"""Reduction and broadcasting ops (twin of
``incubator_mxnet_tpu/ops/reduce.py``): the same 18 names."""
import torch

from .registry import defop, alias


def _norm_axis(axis, ndim, exclude=False):
    if axis is None or axis == ():
        ax = tuple(range(ndim))
    elif isinstance(axis, int):
        ax = (axis % ndim,)
    else:
        ax = tuple(a % ndim for a in axis)
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


def _prod(data, axis, keepdims):
    """torch.prod takes one axis: move the reduced axes last, flatten
    them, take the product over the flat axis."""
    keep = [i for i in range(data.ndim) if i not in axis]
    flat = data.permute(*keep, *axis).reshape(
        [data.shape[i] for i in keep] + [-1])
    out = torch.prod(flat, dim=-1)
    if keepdims:
        out = out.reshape([1 if i in axis else data.shape[i]
                           for i in range(data.ndim)])
    return out


def _nanprod(data, axis, keepdims):
    return _prod(torch.nan_to_num(data, nan=1.0), axis, keepdims)


def _torch_reduce(f):
    def _r(data, axis, keepdims):
        if not axis:
            return data.clone()
        return f(data, dim=axis, keepdim=keepdims)
    return _r


def _make_reduce(name, f):
    def _op(data, axis=None, keepdims=False, exclude=False, _f=f):
        ax = _norm_axis(axis, data.ndim, exclude)
        return _f(data, ax, bool(keepdims))
    _op.__name__ = name
    _op.__doc__ = f"Reduce-{name} over axes."
    return _op


for _n, _f in {"sum": _torch_reduce(torch.sum),
               "mean": _torch_reduce(torch.mean),
               "prod": _prod, "nansum": _torch_reduce(torch.nansum),
               "nanprod": _nanprod, "max": _torch_reduce(torch.amax),
               "min": _torch_reduce(torch.amin)}.items():
    defop(_n)(_make_reduce(_n, _f))

alias("sum", "sum_axis")
alias("max", "max_axis")
alias("min", "min_axis")


@defop("norm")
def norm(data, ord=2, axis=None, keepdims=False):
    """L2 (or L1) norm over ``axis`` (default all)."""
    ax = _norm_axis(axis, data.ndim)
    if ord == 1:
        return torch.sum(torch.abs(data), dim=ax, keepdim=bool(keepdims))
    return torch.sqrt(torch.sum(torch.square(data), dim=ax,
                                keepdim=bool(keepdims)))


def _make_arg(name, f):
    def _op(data, axis=None, keepdims=False, _f=f):
        if axis is None:
            out = _f(data.reshape(-1), dim=0)
            if keepdims:
                out = out.reshape((1,) * data.ndim)
        else:
            out = _f(data, dim=int(axis), keepdim=bool(keepdims))
        return out.to(data.dtype)
    _op.__name__ = name
    return _op


defop("argmax", differentiable=False)(_make_arg("argmax", torch.argmax))
defop("argmin", differentiable=False)(_make_arg("argmin", torch.argmin))


@defop("argmax_channel", differentiable=False)
def argmax_channel(data):
    """argmax over axis 1."""
    return torch.argmax(data, dim=1).to(data.dtype)


@defop("broadcast_axis", aliases=["broadcast_axes"])
def broadcast_axis(data, axis=(), size=()):
    """Broadcast size-1 axes to given sizes."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    shape = list(data.shape)
    for a, s in zip(axes, sizes):
        shape[a % data.ndim] = s
    return data.expand(*shape)


@defop("broadcast_to")
def broadcast_to(data, shape=()):
    """Broadcast to an explicit shape; 0 keeps the input dim."""
    tgt = tuple(int(data.shape[i]) if s == 0 else int(s)
                for i, s in enumerate(shape))
    return data.expand(*tgt)


@defop("broadcast_like")
def broadcast_like(lhs, rhs):
    return lhs.expand(*rhs.shape)
