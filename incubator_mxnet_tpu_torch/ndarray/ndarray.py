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
- ``save`` / ``load`` keep the JAX package's npz format and its CRC32
  sidecar, so each package reads, and checks, the other's files.
"""
import numbers

import numpy as np
import torch
import torch.utils.dlpack

from .. import autograd, engine, monitor as _monitor, random as _random
from .. import profiler as _profiler
from ..base import torch_dtype
from ..context import Context, as_device, current_scope, resolve
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
    _ctx = None       # the Context it was made in, where one was given

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = _as_tensor(data, resolve(ctx))
        elif ctx is not None:
            data = data.to(resolve(ctx))
        self._data = data
        self._ctx = ctx if isinstance(ctx, Context) else None

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
        """The ``Context`` the array lives in: the one it was made in
        (``ctx=``, ``as_in_context``), else its tensor's device's."""
        dev = self._data.device
        if self._ctx is not None and self._ctx.device == dev:
            return self._ctx
        return Context.from_device(dev)

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
        """Copy to a numpy array (synchronizes).  Always a copy: a CPU
        tensor's ``numpy()`` would share its memory, and a parameter's
        array is written in place."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()

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
        if self.context == ctx:
            return self
        dev = as_device(ctx)
        out = self._unary(lambda t: t.to(dev))
        return _placed(out, ctx)

    def detach(self):
        return NDArray(self._data.detach())

    def tostype(self, stype):
        """This array in storage type ``stype``: 'default', 'csr' or
        'row_sparse' (``sparse.cast_storage``)."""
        if stype == "default":
            return self
        from .sparse import cast_storage
        return cast_storage(self, stype)

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

    def argsort(self, axis=-1, is_ascend=True):
        return self._op("argsort", axis=axis, is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return self._op("sort", axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return self._op("topk", axis=axis, k=k, ret_typ=ret_typ,
                        is_ascend=is_ascend)

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

    def softmax(self, axis=-1):
        return self._op("softmax", axis=axis)

    def log_softmax(self, axis=-1):
        return self._op("log_softmax", axis=axis)

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
    if not arr.flags.c_contiguous or not arr.flags.writeable:
        arr = arr.copy(order="C")
    t = torch.from_numpy(arr)
    return t.to(device=device, dtype=_narrow(t.dtype))


def imperative_invoke(op, args, kwargs, out=None):
    """Run a registered op on NDArrays.  Under ``autograd.record()`` an
    op with an input that requires grad is recorded by torch; every
    other call runs under ``torch.no_grad()``.  ``out=`` rebinds the
    given arrays to the results, in the targets' dtypes.  While the
    profiler runs, each call is one event of its trace."""
    prof = _profiler._profiler if _profiler._profiler.running else None
    if prof is not None:
        prof.op_start()
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
            if isinstance(a, NDArray) and new is not a._data:
                autograd.rebind(a, new.detach())

    outs_list = [o if o.device == device else o.to(device)
                 for o in outs_list]
    engine.maybe_block(outs_list)
    if prof is not None:
        prof.record_op(op.name, outs_list)
    if _monitor.active():
        _monitor.observe_op(op.name, [NDArray(o) for o in outs_list])
    if out is not None:
        targets = out if isinstance(out, (tuple, list)) else [out]
        for t, o in zip(targets, outs_list):
            # MXNet's out= writes into the target: its dtype is kept
            autograd.rebind(t, o.to(t._data.dtype))
        return out
    out_arrays = [NDArray(o) for o in outs_list]
    if nd_inputs and op.differentiable and autograd.is_recording():
        autograd._record(op, args, {
            k: v for k, v in params.items()
            if k not in ("ctx", "_training", "_rng")}, out_arrays)
    return out_arrays[0] if len(out_arrays) == 1 else out_arrays


# ---------------------------------------------------------------------------
# creation functions
# ---------------------------------------------------------------------------


def _placed(arr, ctx):
    """``arr`` remembering the Context it was made in: ``ctx``, else
    the innermost ``with ctx:`` scope."""
    ctx = ctx if ctx is not None else current_scope()
    if isinstance(ctx, Context):
        arr._ctx = ctx
    return arr


def array(source, ctx=None, dtype=None):
    """An NDArray from array-like data, on ``ctx`` (default: the card)."""
    device = resolve(ctx)
    if isinstance(source, NDArray):
        t = source._data.detach().to(device, copy=True)
    else:
        # a copy: a CPU tensor from numpy would share the source's memory
        t = _as_tensor(np.array(source), device)
    if dtype is not None:
        t = t.to(_narrow(torch_dtype(dtype)))
    return _placed(NDArray(t), ctx)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype="float32", stype=None):
    if stype not in (None, "default"):
        from .sparse import zeros as sparse_zeros
        return sparse_zeros(stype, shape, ctx, dtype)
    return _placed(NDArray(torch.zeros(
        _shape(shape), dtype=torch_dtype(dtype), device=resolve(ctx))), ctx)


def ones(shape, ctx=None, dtype="float32"):
    return _placed(NDArray(torch.ones(
        _shape(shape), dtype=torch_dtype(dtype), device=resolve(ctx))), ctx)


def full(shape, val, ctx=None, dtype="float32"):
    return _placed(NDArray(torch.full(
        _shape(shape), val, dtype=torch_dtype(dtype),
        device=resolve(ctx))), ctx)


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
    exact file name).  The write is atomic, with a CRC32 sidecar
    (``resilience.atomic_save``): a reader racing the save, or a crash
    mid-write, never sees a partial file at ``fname``."""
    from ..resilience import atomic_save
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        items = data.items()
    else:
        items = ((f"__pos_{i}", v) for i, v in enumerate(data))
    payload = dict(_encode(k, v._data) for k, v in items)
    atomic_save(fname, lambda f: np.savez(f, **payload))


def load(fname, ctx=None):
    """Load arrays saved by :func:`save` (of either package) onto
    ``ctx`` (default: the card).

    The file is checked against its CRC32 sidecar when there is one,
    and an undecodable archive raises ``CheckpointCorruptError``, so
    ``model.load_checkpoint`` can fall back to an older epoch."""
    import zipfile
    from ..resilience import CheckpointCorruptError, validate_or_raise
    device = resolve(ctx)
    validate_or_raise(fname)
    try:
        with np.load(fname, allow_pickle=False) as z:
            raw = {k: z[k] for k in z.keys()}
    except (zipfile.BadZipFile, ValueError, EOFError) as exc:
        if isinstance(exc, ValueError) and "allow_pickle" in str(exc):
            # a well-formed archive with object members: a format
            # mismatch, not corruption (no fallback to an older epoch)
            raise
        raise CheckpointCorruptError(
            f"checkpoint {fname} is not a readable archive "
            f"({exc})") from exc
    items = dict(_decode(k, v, device) for k, v in raw.items())
    if items and all(k.startswith("__pos_") for k in items):
        return [items[f"__pos_{i}"] for i in range(len(items))]
    return items
