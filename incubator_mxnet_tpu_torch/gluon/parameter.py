"""Gluon Parameter / ParameterDict (twin of
``incubator_mxnet_tpu/gluon/parameter.py``).

A Parameter is backed by one ``torch.nn.Parameter`` (``_var``), made
with the Parameter and registered on the Block whose ParameterDict made
it, under the name it was asked for ("weight", "running_mean", ...), and
on every block that shares it.  So torch sees every Gluon parameter:
``named_parameters``, ``state_dict``, ``.to()``, ``functional_call``.
The tensor object never changes: a deferred shape, ``cast``,
``reset_ctx`` and ``set_data`` change it in place.  It requires grad
unless ``grad_req`` is 'null' (BatchNorm's running stats, a layer's
fixed gamma or beta), which keeps it out of the train step's
gradients.

Until its shape and device are known it is a torch
``UninitializedParameter``: ``initialize(init, ctx)`` makes it on
``ctx`` (None: the card) and fills it, or, while a dimension is still
0, records the choice for the layer's first forward, which settles the
shape from the input.

``data()`` is an NDArray over the tensor whose writes (``out=``,
``x[:] = v``, the optimizers' updates) land in the tensor in place; its
``grad`` is the Parameter's gradient buffer.  A backward through ``nd``
(``autograd.record``) accumulates into the torch leaf, and a hook moves
that into the buffer by ``grad_req``: 'write' replaces it, 'add' adds to
it, as the reference's marked arrays do.  ``torch.autograd.grad`` (the
train step) leaves the buffer alone.

Files are the port's ``nd.save`` / ``nd.load``, which keep the JAX
package's npz format, so a ``.params`` file crosses between the
packages both ways.
"""
import functools
import weakref

import numpy as np
import torch
from torch.nn.parameter import UninitializedParameter

from .. import context
from .. import initializer as init_mod
from ..base import torch_dtype
from ..ndarray.ndarray import NDArray

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError"]

_GRAD_REQS = ("write", "add", "null")

# bumped whenever a parameter's tensor gets new storage (made, moved,
# cast): a captured CUDA graph reads parameters by address, so a
# hybridized block's CachedOp drops its captures when this moves and
# the addresses it captured changed (set_data and initialize write in
# place and keep them)
_STORAGE_EPOCH = [0]


def storage_epoch():
    return _STORAGE_EPOCH[0]


class DeferredInitializationError(RuntimeError):
    """Parameter accessed before its shape was known."""


class _InPlace(NDArray):
    """An NDArray over a parameter's tensor: a write to it (``out=``,
    ``x[:] = v``, BatchNorm's aux write-back) copies into the tensor in
    place, so the block, or the dict ``functional_call`` put in its
    place, sees it.  ``grad`` is the Parameter's gradient buffer."""

    def __init__(self, tensor, param=None):
        self._t = tensor
        self._param = param

    @property
    def _data(self):
        return self._t

    @_data.setter
    def _data(self, value):
        if value is not self._t:
            with torch.no_grad():
                self._t.copy_(value)

    @property
    def grad(self):
        return None if self._param is None else self._param._grad


def _move_grad(ref, leaf):
    """Post-accumulate hook of a parameter's tensor: move the gradient
    torch accumulated into the Parameter's buffer, by its grad_req."""
    g, leaf.grad = leaf.grad, None
    p = ref()
    if p is None or g is None or p._grad is None:
        return
    if p._grad_req == "add":
        p._grad._data = p._grad._data + g
    else:
        p._grad._data = g


def _nd_dtype(tdtype):
    """The NDArray surface's dtype for a torch dtype: numpy's, except
    bfloat16, which numpy lacks."""
    if tdtype == torch.bfloat16:
        return torch.bfloat16
    return torch.empty((), dtype=tdtype).numpy().dtype


class Parameter:
    """A weight or state tensor of a Block."""

    def __init__(self, name, grad_req="write", shape=None, dtype=None,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self._tdtype = torch_dtype(dtype if dtype is not None
                                   else "float32")
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        if not differentiable:
            grad_req = "null"
        if grad_req not in _GRAD_REQS:
            raise ValueError(f"grad_req must be one of {_GRAD_REQS}, "
                             f"got {grad_req!r}")
        self._grad_req = grad_req
        self._var = UninitializedParameter(grad_req != "null",
                                           dtype=self._tdtype)
        self._initialized = False
        # _init_on's arguments, until the shape is known
        self._deferred_init = None
        self._device = None           # a layer's device=: made there
        self._grad = None
        self._nd = None

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")

    # ------------------------------------------------------------ state
    @property
    def shape(self):
        if self._allocated():
            return tuple(self._var.shape)
        return self._shape

    @shape.setter
    def shape(self, new):
        new = tuple(new) if new is not None else None
        if self._allocated() and new != tuple(self._var.shape):
            raise ValueError(f"parameter {self.name} has shape "
                             f"{tuple(self._var.shape)}, cannot set "
                             f"{new}")
        self._shape = new

    @property
    def dtype(self):
        return _nd_dtype(self._tdtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in _GRAD_REQS:
            raise ValueError(f"grad_req must be one of {_GRAD_REQS}, "
                             f"got {req!r}")
        self._grad_req = req
        # an attribute, not requires_grad_(): that would refuse a tensor
        # not yet made (materialize keeps the flag)
        self._var.requires_grad = req != "null"
        self._init_grad()

    def _allocated(self):
        return not isinstance(self._var, UninitializedParameter)

    def _shape_known(self):
        return self._shape is not None and all(s != 0 for s in self._shape)

    def _materialize(self, device):
        self._var.materialize(self._shape, device=device,
                              dtype=self._tdtype)
        _STORAGE_EPOCH[0] += 1

    def _init_grad(self):
        """The gradient buffer (zeros) and the hook that fills it."""
        if self._grad_req == "null" or not self._allocated():
            self._grad = None
            return
        self._grad = NDArray(torch.zeros_like(self._var.detach()))
        if not getattr(self._var, "_post_accumulate_grad_hooks", None):
            self._var.register_post_accumulate_grad_hook(
                functools.partial(_move_grad, weakref.ref(self)))

    # ------------------------------------------------------------ init
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Fill the parameter with ``init``, else its own initializer,
        else ``default_init`` (Uniform(0.07)), on ``ctx``: None means
        where it already lives, or the card if it has no storage yet.
        While its shape is unknown the choice waits for the first
        forward."""
        if self._initialized and not force_reinit:
            return
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        chosen = init or self.init or default_init or init_mod.Uniform(0.07)
        self._init_on(self._target(ctx), init_mod.create(chosen), None,
                      True)

    def _target(self, ctx):
        if ctx is not None:
            return context.as_device(ctx)
        if self._allocated():
            return self._var.device
        return self._device if self._device is not None \
            else context.default_device()

    def _init_on(self, device, initializer, generator, with_grad):
        """Initialize on ``device`` now, or record it for the first
        forward while the shape is unknown.  ``with_grad`` (the Gluon
        path) also makes the gradient buffer; the torch-style
        ``initializer.initialize`` leaves gradients to torch."""
        if not self._allocated() and not self._shape_known():
            if not self.allow_deferred_init:
                raise ValueError(f"cannot initialize parameter "
                                 f"{self.name} with unknown shape "
                                 f"{self._shape}")
            self._deferred_init = (device, initializer, generator,
                                   with_grad)
            return
        if not self._allocated():
            self._materialize(device)
        elif self._var.device != device:
            self.reset_ctx(device)
        initializer(init_mod.InitDesc(self.name), self._var, generator)
        self._deferred_init = None
        self._initialized = True
        if with_grad:
            self._init_grad()

    def _finish_deferred_init(self, like=None):
        """Once a layer has set the shape from its input: make the
        tensor and apply the initializer recorded for it.  Without one,
        a parameter of a layer built with ``device=`` is made there,
        unfilled (the layer's own torch-style use); else this is an
        error, as in the reference."""
        if self._allocated() or not self._shape_known():
            return
        if self._deferred_init is not None:
            self._init_on(*self._deferred_init)
        elif self._device is not None:
            self._materialize(self._device)
        else:
            raise DeferredInitializationError(
                f"parameter {self.name} is not initialized; call "
                "initialize() before the first forward")

    # ------------------------------------------------------------ access
    def data(self, ctx=None):
        """The parameter as an NDArray (writes land in place)."""
        if not self._allocated():
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"parameter {self.name} deferred-initialized; run a "
                    "forward pass (or set shape) first")
            raise RuntimeError(f"parameter {self.name} not initialized; "
                               "call .initialize()")
        if self._nd is None:
            self._nd = _InPlace(self._var, self)
        return self._nd

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        if self._grad_req == "null":
            raise RuntimeError(f"parameter {self.name} has grad_req="
                               "'null'")
        if self._grad is None:
            raise RuntimeError(f"parameter {self.name} not initialized")
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        return [self._var.device if self._allocated()
                else self._device or context.default_device()]

    def zero_grad(self):
        if self._grad is not None:
            self._grad._data = torch.zeros_like(self._grad._data)

    def set_data(self, data):
        """Copy ``data`` (NDArray, tensor or array-like) into the
        parameter; one without storage is made with its shape on its
        device."""
        if isinstance(data, NDArray):
            t = data._data
        elif isinstance(data, torch.Tensor):
            t = data
        else:
            t = torch.from_numpy(np.ascontiguousarray(np.asarray(data)))
        if not self._allocated():
            self._shape = tuple(t.shape)
            self._materialize(t.device)
        with torch.no_grad():
            self._var.copy_(t.detach())
        self._deferred_init = None
        self._initialized = True
        if self._grad is None:
            self._init_grad()

    def reset_ctx(self, ctx):
        """Move the parameter (and its gradient buffer) to ``ctx``."""
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        device = context.as_device(ctx)
        if not self._allocated():
            self._device = device
            return
        self._var.data = self._var.data.to(device)
        _STORAGE_EPOCH[0] += 1
        if self._grad is not None:
            self._grad._data = self._grad._data.to(device)

    def cast(self, dtype):
        self._tdtype = torch_dtype(dtype)
        if self._allocated():
            self._var.data = self._var.data.to(self._tdtype)
            _STORAGE_EPOCH[0] += 1
            if self._grad is not None:
                self._init_grad()

    def var(self):
        """A Symbol variable for the parameter (ref: parameter.py var),
        carrying its lr_mult and wd_mult."""
        from ..symbol import Variable
        return Variable(self.name, lr_mult=self.lr_mult,
                        wd_mult=self.wd_mult)


class ParameterDict:
    """Ordered name -> Parameter mapping with a prefix and a shared
    fallback.  One made for a Block registers every parameter it hands
    out on that block."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared
        self._block = None

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        return f"ParameterDict({self._prefix}: {list(self._params)})"

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs):
        """Get or create the parameter named prefix + name."""
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            param = Parameter(full, **kwargs)
            self._params[full] = param
        else:
            shape = kwargs.get("shape")
            if shape is not None and not param._allocated() \
                    and not param._shape_known():
                param.shape = shape
        if self._block is not None:
            self._block._register_param(name, param)
        return param

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None:
            p = self._shared._get_impl(name)
            if p is not None:
                self._params[name] = p
            return p
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(f"duplicate parameter {k}")
            self._params[k] = v

    # ------------------------------------------------------------ bulk ops
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        init = init or init_mod.Uniform(0.07)
        for p in self.values():
            p.initialize(None, ctx, init, force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    # ------------------------------------------------------------ io
    def save(self, filename, strip_prefix=""):
        from ..ndarray import save as nd_save
        arg = {}
        for p in self.values():
            if not p._allocated():
                continue
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg[name] = p.data()
        nd_save(filename, arg)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load a ``.params`` file (of either package).  A parameter
        with storage keeps its device; one without is made on ``ctx``
        (None: the card)."""
        from ..ndarray import load as nd_load
        loaded = nd_load(filename, ctx=context.cpu())
        loaded = {restore_prefix + k: v for k, v in loaded.items()}
        for name, p in self.items():
            if name in loaded:
                if not p._allocated():
                    p._shape = tuple(loaded[name].shape)
                    p._materialize(p._target(ctx))
                p.set_data(loaded[name])
            elif not allow_missing:
                raise IOError(f"parameter {name} missing in {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(self._params)
            if extra:
                raise IOError(f"extra parameters in file: {extra}")
