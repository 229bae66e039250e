"""NDArray: the imperative array, over a ``torch.Tensor`` (twin of
``incubator_mxnet_tpu/ndarray/ndarray.py``).

- PyTorch's asynchronous CUDA streams play the role of MXNet's
  dependency engine: an op returns at once, and ``wait_to_read`` /
  ``asnumpy`` are the sync points.
- Writes (``x[:] = v``, ``+=``, ``out=``) rebind the array to a new
  tensor, as the JAX package rebinds its buffer: an array that shares
  a tensor with another (``detach``) never sees the other's writes.
- Autograd rides on torch's (``autograd.py``).
- Creators put their result on ``context.default_device()`` unless the
  caller passes ``ctx``, so they raise on a host without a card.
- ``nd.array`` narrows numpy's 64-bit types to 32 bits, as the JAX
  package does with 64-bit types off: float64 to float32, int64 to
  int32, uint64 to uint32.
- ``dtype`` is a numpy dtype, except for bfloat16, which numpy lacks:
  there it is ``torch.bfloat16`` (``asnumpy`` then gives float32).
- ``save`` / ``load`` keep the JAX package's npz format, so each
  package reads the other's files.
- Methods whose ops are not ported yet (``softmax``, ``sort``, ``topk``
  and the like) are left out until their ops come.
"""
import numbers
import os

import numpy as np
import torch
import torch.utils.dlpack

from .. import autograd, engine, random as _random
from ..base import torch_dtype
from ..context import resolve
from ..ops.registry import get_op

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "imperative_invoke", "waitall", "moveaxis",
           "save", "load", "to_dlpack_for_read", "to_dlpack_for_write",
           "from_dlpack"]

_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.uint64: torch.uint32}


def _np_dtype(t):
    if t.dtype == torch.bfloat16:
        return torch.bfloat16
    return torch.empty((), dtype=t.dtype).numpy().dtype


class NDArray:
    """Multi-dimensional array with asynchronous execution."""

    # set by autograd.mark_variables: _grad (NDArray), _grad_req (str)

    def __init__(self, data):
        if isinstance(data, NDArray):
            data = data._data
        self._data = data

    # ------------------------------------------------------------ properties
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _np_dtype(self._data)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self):
        """The ``torch.device`` the array lives on."""
        return self._data.device

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def grad(self):
        return getattr(self, "_grad", None)

    @property
    def T(self):
        return self.transpose()

    @property
    def handle(self):
        """The torch tensor itself."""
        return self._data

    # ------------------------------------------------------------ sync
    def wait_to_read(self):
        """Block until this array's value is computed."""
        engine.wait([self._data])
        return self

    def asnumpy(self):
        """Copy to a numpy array (synchronizes)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    # ------------------------------------------------------------ conversion
    def _unary(self, fn):
        with autograd.grad_scope([self._data]):
            return NDArray(fn(self._data))

    def astype(self, dtype, copy=True):
        return self._unary(lambda t: t.to(torch_dtype(dtype)))

    def copy(self):
        return self._unary(lambda t: t.clone())

    def copyto(self, other):
        """Copy into another NDArray (keeping its dtype) or to a
        device."""
        if isinstance(other, NDArray):
            autograd.rebind(other, self._data.detach().to(
                device=other._data.device, dtype=other._data.dtype))
            return other
        return self.as_in_context(other)

    def as_in_context(self, ctx):
        dev = torch.device(ctx)
        if dev == self._data.device:
            return self
        return self._unary(lambda t: t.to(dev))

    def detach(self):
        return NDArray(self._data.detach())

    def tostype(self, stype):
        if stype == "default":
            return self
        raise NotImplementedError(
            f"storage type {stype!r}: the sparse storage types are not "
            "ported yet (ROADMAP item 8)")

    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a gradient buffer and mark the array for autograd."""
        grad = NDArray(torch.zeros_like(self._data.detach()))
        autograd.mark_variables([self], [grad], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph, train_mode)

    # ------------------------------------------------------------ shape ops
    def _op(self, name, *others, **params):
        return imperative_invoke(get_op(name), (self,) + others, params)

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if kwargs.get("shape"):
            shape = tuple(kwargs["shape"])
        return self._op("Reshape", shape=shape,
                        reverse=kwargs.get("reverse", False))

    def reshape_like(self, other):
        return self._unary(lambda t: t.reshape(other.shape))

    def broadcast_to(self, shape):
        return self._op("broadcast_to", shape=tuple(shape))

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def expand_dims(self, axis):
        return self._op("expand_dims", axis=axis)

    def flatten(self):
        return self._op("Flatten")

    def transpose(self, axes=()):
        return self._op("transpose", axes=axes)

    def swapaxes(self, dim1, dim2):
        return self._op("SwapAxis", dim1=dim1, dim2=dim2)

    def flip(self, axis):
        return self._op("reverse", axis=axis)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return self._op("SliceChannel", num_outputs=num_outputs,
                        axis=axis, squeeze_axis=squeeze_axis)

    def slice(self, begin, end, step=()):
        return self._op("slice", begin=begin, end=end, step=step)

    def slice_axis(self, axis, begin, end):
        return self._op("slice_axis", axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return self._op("take", indices, axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False):
        return self._op("pick", index, axis=axis, keepdims=keepdims)

    def one_hot(self, depth, **kw):
        return self._op("one_hot", depth=depth, **kw)

    def clip(self, a_min, a_max):
        return self._op("clip", a_min=a_min, a_max=a_max)

    def repeat(self, repeats, axis=None):
        return self._op("repeat", repeats=repeats, axis=axis)

    def tile(self, reps):
        return self._op("tile", reps=reps)

    def pad(self, mode="constant", pad_width=(), constant_value=0.0):
        return self._op("Pad", mode=mode, pad_width=pad_width,
                        constant_value=constant_value)

    # ------------------------------------------------------------ reductions
    def sum(self, axis=None, keepdims=False):
        return self._op("sum", axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._op("mean", axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._op("prod", axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return self._op("max", axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return self._op("min", axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._op("norm", ord=ord, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._op("argmax", axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._op("argmin", axis=axis, keepdims=keepdims)

    def dot(self, other, **kw):
        return self._op("dot", other, **kw)

    # elementwise convenience mirrors
    def abs(self):
        return self._op("abs")

    def sqrt(self):
        return self._op("sqrt")

    def square(self):
        return self._op("square")

    def exp(self):
        return self._op("exp")

    def log(self):
        return self._op("log")

    def sigmoid(self):
        return self._op("sigmoid")

    def tanh(self):
        return self._op("tanh")

    def relu(self):
        return self._op("relu")

    # ------------------------------------------------------------ arithmetic
    def _binary(self, opname, scalar_opname, other, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return imperative_invoke(get_op(opname), (a, b), {})
        if isinstance(other, numbers.Number):
            return self._op(scalar_opname, scalar=other)
        return NotImplemented

    def _rscalar(self, opname, binary, scalar, o):
        if isinstance(o, numbers.Number):
            return self._op(opname, scalar=o)
        return self._binary(binary, scalar, o, True)

    def __add__(self, o):
        return self._binary("broadcast_add", "_plus_scalar", o)
    __radd__ = __add__

    def __sub__(self, o):
        return self._binary("broadcast_sub", "_minus_scalar", o)

    def __rsub__(self, o):
        return self._rscalar("_rminus_scalar", "broadcast_sub",
                             "_minus_scalar", o)

    def __mul__(self, o):
        return self._binary("broadcast_mul", "_mul_scalar", o)
    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary("broadcast_div", "_div_scalar", o)

    def __rtruediv__(self, o):
        return self._rscalar("_rdiv_scalar", "broadcast_div",
                             "_div_scalar", o)

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

    def __mod__(self, o):
        return self._binary("broadcast_mod", "_mod_scalar", o)

    def __rmod__(self, o):
        return self._rscalar("_rmod_scalar", "broadcast_mod",
                             "_mod_scalar", o)

    def __pow__(self, o):
        return self._binary("broadcast_power", "_power_scalar", o)

    def __rpow__(self, o):
        if isinstance(o, numbers.Number):
            return self._op("_rpower_scalar", scalar=o)
        return NotImplemented

    def __neg__(self):
        return self._op("negative")

    def __abs__(self):
        return self.abs()

    def __eq__(self, o):
        if o is None:
            return False
        return self._binary("broadcast_equal", "_equal_scalar", o)

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary("broadcast_not_equal", "_not_equal_scalar", o)

    def __gt__(self, o):
        return self._binary("broadcast_greater", "_greater_scalar", o)

    def __ge__(self, o):
        return self._binary("broadcast_greater_equal",
                            "_greater_equal_scalar", o)

    def __lt__(self, o):
        return self._binary("broadcast_lesser", "_lesser_scalar", o)

    def __le__(self, o):
        return self._binary("broadcast_lesser_equal",
                            "_lesser_equal_scalar", o)

    __hash__ = object.__hash__

    # in-place: rebind to the new value
    def _inplace(self, out):
        autograd.rebind(self, out._data)
        return self

    def __iadd__(self, o):
        return self._inplace(self.__add__(o))

    def __isub__(self, o):
        return self._inplace(self.__sub__(o))

    def __imul__(self, o):
        return self._inplace(self.__mul__(o))

    def __itruediv__(self, o):
        return self._inplace(self.__truediv__(o))

    # ------------------------------------------------------------ indexing
    def __len__(self):
        return self.shape[0] if self.shape else 0

    def __bool__(self):
        if self.size != 1:
            raise ValueError("ambiguous truth value of multi-element array")
        return bool(self.asscalar())

    @staticmethod
    def _key(key):
        if isinstance(key, NDArray):
            return key._data.long()
        if isinstance(key, tuple):
            return tuple(k._data.long() if isinstance(k, NDArray) else k
                         for k in key)
        return key

    def __getitem__(self, key):
        return self._unary(lambda t: t[self._key(key)])

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        with autograd.grad_scope([self._data, value]):
            new = self._data.clone()
            new[self._key(key)] = value
        autograd.rebind(self, new)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray {self.shape} "
                f"@{self.context}>")

    # numpy protocol
    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype else a

    # dlpack protocol: zero-copy interchange (JAX, numpy, ...)
    def __dlpack__(self, *args, **kwargs):
        return self._data.detach().__dlpack__(*args, **kwargs)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()


# ---------------------------------------------------------------------------
# the imperative invoke path (role of Imperative::Invoke)
# ---------------------------------------------------------------------------


def _narrow(dtype):
    return _NARROW.get(dtype, dtype)


def _as_tensor(a, device):
    arr = np.asarray(a)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    t = torch.from_numpy(arr)
    return t.to(device=device, dtype=_narrow(t.dtype))


def imperative_invoke(op, args, kwargs, out=None):
    """Run a registered op on NDArrays.  Under ``autograd.record()`` an
    op with an input that requires grad is recorded by torch; every
    other call runs under ``torch.no_grad()``.  ``out=`` rebinds the
    given arrays to the results, in the targets' dtypes."""
    params = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in kwargs.items()
              if v is not None and k not in ("name", "ctx")}
    ctx = kwargs.get("ctx")
    nd_inputs = [a for a in args if isinstance(a, NDArray)]
    if ctx is not None or not nd_inputs:
        device = resolve(ctx)
    else:
        device = nd_inputs[0]._data.device
    targs = [a._data if isinstance(a, NDArray)
             else None if a is None else _as_tensor(a, device)
             for a in args]
    if "ctx" in op.param_defaults:
        params["ctx"] = device
    if op.needs_mode:
        params["_training"] = autograd.is_training()
    if op.needs_rng:
        params["_rng"] = _random.current_generator(device)

    scope = autograd.grad_scope(targs) if op.differentiable \
        else torch.no_grad()
    with scope:
        outs = op.fn(*targs, **params)
    outs_list = list(outs) if isinstance(outs, (tuple, list)) else [outs]

    # aux-state writeback (BatchNorm moving stats): trailing outputs map
    # onto the trailing `num_aux` inputs
    if op.num_aux and params.get("_training"):
        aux_new = outs_list[-op.num_aux:]
        outs_list = outs_list[:-op.num_aux]
        for a, new in zip(args[-op.num_aux:], aux_new):
            if isinstance(a, NDArray):
                autograd.rebind(a, new.detach())

    outs_list = [o if o.device == device else o.to(device)
                 for o in outs_list]
    engine.maybe_block(outs_list)
    if out is not None:
        targets = out if isinstance(out, (tuple, list)) else [out]
        for t, o in zip(targets, outs_list):
            # MXNet's out= writes into the target: its dtype is kept
            autograd.rebind(t, o.to(t._data.dtype))
        return out
    out_arrays = [NDArray(o) for o in outs_list]
    return out_arrays[0] if len(out_arrays) == 1 else out_arrays


# ---------------------------------------------------------------------------
# creation functions
# ---------------------------------------------------------------------------


def array(source, ctx=None, dtype=None):
    """An NDArray from array-like data, on ``ctx`` (default: the card)."""
    device = resolve(ctx)
    if isinstance(source, NDArray):
        t = source._data.detach().to(device, copy=True)
    else:
        t = _as_tensor(source, device)
    if dtype is not None:
        t = t.to(_narrow(torch_dtype(dtype)))
    return NDArray(t)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype="float32", stype=None):
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=resolve(ctx)))


def ones(shape, ctx=None, dtype="float32"):
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=resolve(ctx)))


def full(shape, val, ctx=None, dtype="float32"):
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=resolve(ctx)))


def empty(shape, ctx=None, dtype="float32"):
    return zeros(shape, ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype="float32"):
    return imperative_invoke(get_op("_arange"), (), dict(
        start=start, stop=stop, step=step, repeat=repeat, dtype=dtype,
        ctx=ctx))


def moveaxis(tensor, source, destination):
    return tensor._unary(lambda t: torch.movedim(t, source, destination))


def concatenate(arrays, axis=0, always_copy=True):
    return imperative_invoke(get_op("Concat"), tuple(arrays),
                             {"dim": axis})


def waitall():
    engine.wait_all()


# ---------------------------------------------------------------------------
# dlpack interchange, through torch.utils.dlpack
# ---------------------------------------------------------------------------


def to_dlpack_for_read(data):
    """Export as a DLPack capsule (a read view of the buffer)."""
    return torch.utils.dlpack.to_dlpack(data._data.detach())


def to_dlpack_for_write(data):
    """Export as a DLPack capsule; writes through it land in ``data``."""
    return torch.utils.dlpack.to_dlpack(data._data.detach())


def from_dlpack(ext):
    """NDArray from any DLPack-exporting tensor (JAX, numpy, torch...)
    or capsule, zero-copy when device and layout allow."""
    return NDArray(torch.utils.dlpack.from_dlpack(ext))


# ---------------------------------------------------------------------------
# serialization: the JAX package's npz format
# ---------------------------------------------------------------------------


def _encode(k, t):
    """npz has no bfloat16: store its raw bits as uint16 and tag the
    key, as the JAX package does."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return f"__xdt_bfloat16__{k}", t.view(torch.int16).numpy() \
            .view(np.uint16)
    return k, t.numpy()


def _decode(k, arr, device):
    if k.startswith("__xdt_"):
        name, _, orig = k[len("__xdt_"):].partition("__")
        if name != "bfloat16":
            raise TypeError(f"{orig}: extension dtype {name} has no "
                            "torch counterpart in the port")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return orig, NDArray(t.to(device))
    return k, NDArray(torch.from_numpy(np.array(arr)).to(device))


def save(fname, data):
    """Save NDArrays: list -> positional, dict -> named (npz, under the
    exact file name).  The write goes to a temporary file that replaces
    ``fname`` once complete; a stale CRC sidecar (``fname.crc32``,
    written by the JAX package) is removed first, so the JAX package
    never checks the new file against an old checksum."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        items = data.items()
    else:
        items = ((f"__pos_{i}", v) for i, v in enumerate(data))
    payload = dict(_encode(k, v._data) for k, v in items)
    tmp = f"{fname}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    try:
        os.unlink(fname + ".crc32")
    except FileNotFoundError:
        pass
    os.replace(tmp, fname)


def load(fname, ctx=None):
    """Load arrays saved by :func:`save` (of either package) onto
    ``ctx`` (default: the card)."""
    device = resolve(ctx)
    with np.load(fname, allow_pickle=False) as z:
        items = dict(_decode(k, z[k], device) for k in z.keys())
    if items and all(k.startswith("__pos_") for k in items):
        return [items[f"__pos_{i}"] for i in range(len(items))]
    return items
