"""Shape-manipulation and linear-algebra ops (twin of
``incubator_mxnet_tpu/ops/matrix.py``): its 47 names less ``_sparse_dot``
and ``_sparse_zeros_like``, which come with the sparse storage types
(ROADMAP item 8).  ``dot`` and ``batch_dot`` are ``torch.matmul``: XLA
computed them outside any kernel, and cuBLAS does here.  ``rope_fn``
is the rotary position embedding of the TransformerLM, registered as
``_rope``.
"""
import math

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .registry import defop

__all__ = ["rope_fn"]


def _reverse_axes(x):
    return x.permute(*reversed(range(x.ndim)))


# ------------------------------------------------------------------ reshape
@defop("Reshape", aliases=["reshape"])
def reshape(data, shape=(), reverse=False):
    """Reshape with MXNet's special codes 0, -1, -2, -3, -4."""
    src = list(data.shape)
    if reverse:
        src = src[::-1]
        shape = tuple(shape)[::-1]
    out, i = [], 0
    shape = list(shape)
    k = 0
    while k < len(shape):
        s = shape[k]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = shape[k + 1], shape[k + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            k += 2
        else:
            out.append(int(s))
            i += 1
        k += 1
    if reverse:
        out = out[::-1]
    if -1 in out:
        # resolve the wildcard here, so zero-size arrays reshape too
        known = 1
        for d in out:
            if d != -1:
                known *= int(d)
        total = math.prod(data.shape)
        out[out.index(-1)] = total // known if known > 0 else 0
    return data.reshape(tuple(out))


@defop("Flatten", aliases=["flatten"])
def flatten(data):
    """Collapse all dims but the first."""
    return data.reshape((data.shape[0], math.prod(data.shape[1:])))


@defop("transpose")
def transpose(data, axes=()):
    return data.permute(*axes) if axes else _reverse_axes(data)


@defop("expand_dims")
def expand_dims(data, axis=0):
    axis = int(axis)
    return data.unsqueeze(axis if axis >= 0 else data.ndim + 1 + axis)


@defop("SwapAxis", aliases=["swapaxes"])
def swapaxes(data, dim1=0, dim2=0):
    return data.transpose(int(dim1), int(dim2))


@defop("squeeze")
def squeeze(data, axis=None):
    if axis is None:
        return data.squeeze()
    ax = (int(axis),) if isinstance(axis, int) else tuple(axis)
    return data.squeeze(ax)


# ------------------------------------------------------------------ slicing
def _index(begin, end, step, shape):
    """Python-slicing key for ``begin``/``end``/``step``.  torch slices
    take no negative step, so an axis with one becomes an index tensor
    (and all axes then broadcast against each other, as ``np.ix_``)."""
    ndim = len(shape)
    begin = list(begin) + [None] * (ndim - len(begin))
    end = list(end) + [None] * (ndim - len(end))
    step = (list(step) + [None] * (ndim - len(step))) if step \
        else [None] * ndim
    sl = [slice(b, e, s) for b, e, s in zip(begin, end, step)]
    if all(s.step is None or s.step > 0 for s in sl):
        return tuple(sl)
    key = []
    for ax, s in enumerate(sl):
        idx = torch.arange(shape[ax])[s] if s.step is None or s.step > 0 \
            else torch.tensor(list(range(*s.indices(shape[ax]))),
                              dtype=torch.long)
        key.append(idx.reshape([-1] + [1] * (ndim - ax - 1)))
    return tuple(key)


def _on(key, device):
    return tuple(k.to(device) if isinstance(k, torch.Tensor) else k
                 for k in key)


@defop("slice", aliases=["crop"])
def slice_op(data, begin=(), end=(), step=()):
    """Python-slicing semantics slice."""
    return data[_on(_index(begin, end, step, data.shape), data.device)]


@defop("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None):
    axis = int(axis) % data.ndim
    sl = [slice(None)] * data.ndim
    sl[axis] = slice(begin, end)
    return data[tuple(sl)]


@defop("slice_like")
def slice_like(data, shape_like, axes=()):
    axes_ = tuple(axes) if axes else tuple(range(shape_like.ndim))
    sl = [slice(None)] * data.ndim
    for a in axes_:
        sl[a % data.ndim] = slice(0, shape_like.shape[a % shape_like.ndim])
    return data[tuple(sl)]


@defop("_slice_assign", aliases=["_crop_assign"])
def _slice_assign(lhs, rhs, begin=(), end=(), step=()):
    out = lhs.clone()
    out[_on(_index(begin, end, step, lhs.shape), lhs.device)] = rhs
    return out


@defop("_slice_assign_scalar", aliases=["_crop_assign_scalar"])
def _slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=()):
    out = data.clone()
    out[_on(_index(begin, end, step, data.shape), data.device)] = scalar
    return out


@defop("clip")
def clip(data, a_min=0.0, a_max=1.0):
    return torch.clamp(data, a_min, a_max)


@defop("repeat")
def repeat(data, repeats=1, axis=None):
    return torch.repeat_interleave(
        data, int(repeats), dim=None if axis is None else int(axis))


@defop("tile")
def tile(data, reps=()):
    return torch.tile(data, tuple(reps))


@defop("reverse", aliases=["flip"])
def reverse(data, axis=()):
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, ax)


# ------------------------------------------------------------- concat/split
@defop("Concat", aliases=["concat"], variadic=True)
def concat(*args, dim=1, num_args=None):
    """Concatenate along ``dim``."""
    return torch.cat(args, dim=int(dim))


@defop("stack", variadic=True)
def stack(*args, axis=0, num_args=None):
    return torch.stack(args, dim=int(axis))


def _split_outputs(params):
    return int(params.get("num_outputs", 1))


@defop("SliceChannel", aliases=["split"], num_outputs=_split_outputs)
def slice_channel(data, num_outputs=1, axis=1, squeeze_axis=False):
    """Split into equal parts."""
    n, axis = int(num_outputs), int(axis)
    if data.shape[axis] % n:
        raise ValueError(f"cannot split axis {axis} of size "
                         f"{data.shape[axis]} into {n} equal parts")
    parts = list(torch.split(data, data.shape[axis] // n, dim=axis))
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


# ------------------------------------------------------------------ matmul
@defop("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Matrix product.  For >2-D inputs follows MXNet: lhs reshaped to
    (prod(head), last) and rhs to (first, prod(tail))."""
    a = _reverse_axes(lhs) if transpose_a else lhs
    b = _reverse_axes(rhs) if transpose_b else rhs
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b)
    a2 = a.reshape((-1, a.shape[-1]))
    b2 = b.reshape((b.shape[0], -1))
    return torch.matmul(a2, b2).reshape(a.shape[:-1] + b.shape[1:])


@defop("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Batched matmul."""
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


# ------------------------------------------------------------------ pad
@defop("Pad", aliases=["pad"])
def pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """Pad NCHW/NCDHW.  ``pad_width`` is the flat (before, after)
    per-axis list, first axis first."""
    pw = [int(p) for p in pad_width]
    pw += [0] * (2 * data.ndim - len(pw))
    # F.pad takes the pairs last axis first
    flat = [p for i in reversed(range(data.ndim))
            for p in (pw[2 * i], pw[2 * i + 1])]
    if mode == "constant":
        return F.pad(data, flat, value=constant_value)
    if mode in ("edge", "reflect"):
        if any(pw[:4]):
            raise ValueError(f"{mode} pads only the spatial axes of "
                             "NCHW/NCDHW")
        spatial = flat[:2 * (data.ndim - 2)]
        return F.pad(data, spatial,
                     mode="replicate" if mode == "edge" else "reflect")
    raise ValueError(f"unknown pad mode {mode}")


# ------------------------------------------------------------------ where
@defop("where")
def where(condition, x, y):
    """Elementwise select."""
    if condition.ndim == 1 and x.ndim > 1:
        condition = condition.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(condition != 0, x, y)


# ------------------------------------------------------------------ casts
@defop("Cast", aliases=["cast"])
def cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))


@defop("amp_cast")
def amp_cast(data, dtype="float16"):
    return data.to(torch_dtype(dtype))


@defop("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@defop("ones_like")
def ones_like(data):
    return torch.ones_like(data)


@defop("_identity_with_attr_like_rhs")
def _identity_with_attr_like_rhs(lhs, rhs):
    return lhs + 0


@defop("_CrossDeviceCopy", aliases=["_cross_device_copy"])
def cross_device_copy(data):
    """Explicit device boundary marker: an identity."""
    return data + 0


@defop("einsum", variadic=True, aliases=["_npi_einsum"])
def einsum(*operands, subscripts=""):
    """Einstein summation over any number of operands."""
    if not subscripts:
        raise ValueError("einsum needs subscripts=")
    return torch.einsum(subscripts, *operands)


@defop("cumsum", aliases=["_np_cumsum"])
def cumsum(data, axis=None, dtype=None):
    """Cumulative sum; ``dtype`` is the accumulator's type (numpy
    semantics); ``axis=None`` runs over the flattened array."""
    if axis is None:
        data, axis = data.reshape(-1), 0
    return torch.cumsum(data, dim=int(axis),
                        dtype=torch_dtype(dtype) if dtype else None)


def rope_fn(data, base=10000.0, offset=0):
    """Rotary position embedding.  data: (B_, L, D) or (B, L, H, D);
    positions run along axis 1, shifted by ``offset``.  Rotates the
    feature pairs (d, d + D/2) by position-dependent angles, so q.k
    scores depend on relative position."""
    l, d = data.shape[1], data.shape[-1]
    if d % 2:
        raise ValueError(
            f"rope needs an even feature dim (got {d}): it rotates "
            "pairs (i, i + D/2) — pick d_model/n_heads even")
    half = d // 2
    dev = data.device
    pos = torch.arange(l, dtype=torch.float32, device=dev) + offset
    inv = torch.pow(torch.tensor(float(base), device=dev),
                    -torch.arange(half, dtype=torch.float32,
                                  device=dev) / half)
    ang = pos[:, None] * inv[None, :]                # (L, D/2)
    shape = (1, l) + (1,) * (data.dim() - 3) + (half,)
    cos = torch.cos(ang).reshape(shape)
    sin = torch.sin(ang).reshape(shape)
    x1, x2 = data[..., :half], data[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(data.dtype)


@defop("_rope", arg_names=["data"])
def rope(data, base=10000.0, offset=0):
    """Registry surface for :func:`rope_fn`."""
    return rope_fn(data, base=float(base), offset=float(offset))
