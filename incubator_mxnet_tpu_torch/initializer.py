"""Weight initializers (twin of ``incubator_mxnet_tpu/initializer.py``):
``InitDesc``, ``Initializer`` and its registry (``zeros``, ``ones``,
``constant``, ``uniform``, ``normal``, ``orthogonal``, ``xavier``,
``msraprelu``, ``bilinear``, ``lstmbias``, ``mixed``, ``load``).

An initializer is called with a parameter's name (a ``str`` or an
``InitDesc``), its tensor (or an NDArray over it) and an optional
``torch.Generator``, and picks by the name, as the reference does:
``*weight`` gets the initializer's own rule, ``*bias`` and ``*beta``
zeros, ``*gamma`` ones, ``*running_mean``/``*moving_mean`` zeros,
``*running_var``/``*moving_var`` ones, any other name the own rule.
Random draws come from an explicit CPU ``torch.Generator`` (default:
``random.default_generator()``) and are copied to the parameter's
device, so one seed gives the same weights on every device.  They are
not JAX's draws: weights cross between the packages as arrays.

``initialize(module, init, generator)`` initializes every parameter of
a torch module, Gluon layers included: each with its own initializer
where its layer set one (``Dense(weight_initializer=...)``), else with
``init``, as the reference's ``Parameter.initialize`` does; a deferred
parameter (``in_units=0``) keeps that choice for its layer's first
forward.
"""
import json
import re

import numpy as np
import torch

from .ndarray.ndarray import NDArray
from .random import default_generator
from .utils.registry import get_registry

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant",
           "Uniform", "Normal", "Orthogonal", "Xavier", "MSRAPrelu",
           "Bilinear", "LSTMBias", "Mixed", "Load", "create", "register",
           "initialize"]

_REG = get_registry("initializer")
register = _REG.register


def create(name, **kwargs):
    """An initializer from an instance or from its registry name."""
    if isinstance(name, (Initializer, Mixed, Load)):
        return name
    cls = _REG.find(name) if isinstance(name, str) else None
    if cls is None:
        raise ValueError(f"initializer {name!r}: the port has "
                         f"{_REG.keys()}")
    return cls(**kwargs)


class InitDesc(str):
    """A parameter's name, with attributes that may say how to
    initialize it (``attrs["__init__"]``: a dumped initializer)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _tensor(arr):
    return arr._data if isinstance(arr, NDArray) else arr


def _draw(arr, sample):
    """Copy a CPU draw into ``arr`` (on its device, in its dtype)."""
    arr.copy_(sample.reshape(arr.shape))


class Initializer:
    """Base initializer; callable on (name, tensor[, generator])."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    @torch.no_grad()
    def __call__(self, desc, arr, generator=None):
        arr = _tensor(arr)
        gen = generator or default_generator()
        init_attr = getattr(desc, "attrs", {}).get("__init__", "")
        if init_attr:
            klass, kwargs = json.loads(init_attr)
            create(klass, **kwargs)._init_weight(desc, arr, gen)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr, gen)
        elif name.endswith("bias"):
            self._init_bias(desc, arr, gen)
        elif name.endswith("gamma"):
            arr.fill_(1.0)
        elif name.endswith("beta"):
            arr.zero_()
        elif "moving_mean" in name or "running_mean" in name:
            arr.zero_()
        elif ("moving_var" in name or "running_var" in name
              or "moving_inv_var" in name):
            arr.fill_(1.0)
        elif "moving_avg" in name:
            arr.zero_()
        else:
            self._init_default(desc, arr, gen)

    def _init_weight(self, desc, arr, gen):
        raise NotImplementedError

    def _init_bias(self, desc, arr, gen):
        arr.zero_()

    def _init_default(self, desc, arr, gen):
        self._init_weight(desc, arr, gen)


@register("zeros")
class Zero(Initializer):
    def _init_weight(self, desc, arr, gen):
        arr.zero_()


@register("ones")
class One(Initializer):
    def _init_weight(self, desc, arr, gen):
        arr.fill_(1.0)


@register("constant")
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, arr, gen):
        arr.fill_(self.value)


@register("uniform")
class Uniform(Initializer):
    """uniform(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, arr, gen):
        _draw(arr, torch.rand(arr.shape, generator=gen)
              * (2 * self.scale) - self.scale)


@register("normal")
class Normal(Initializer):
    """normal(0, sigma)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, arr, gen):
        _draw(arr, torch.randn(arr.shape, generator=gen) * self.sigma)


@register("orthogonal")
class Orthogonal(Initializer):
    """``scale`` times an orthogonal matrix (out, prod(in)) from the SVD
    of a uniform(-1, 1) or normal draw."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, desc, arr, gen):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = torch.rand((nout, nin), generator=gen,
                             dtype=torch.float64) * 2 - 1
        else:
            tmp = torch.randn((nout, nin), generator=gen,
                              dtype=torch.float64)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        _draw(arr, self.scale * q)


@register("xavier")
class Xavier(Initializer):
    """Glorot init: magnitude / factor, factor the fans' average, the
    fan in or the fan out (fans from the shape (out, in, *kernel)), as
    uniform(-s, s) with s = sqrt(magnitude / factor) or normal(0, s)."""

    def __init__(self, rnd_type="uniform", factor_type="avg",
                 magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr, gen):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError(f"Xavier requires ndim>=2, got {desc} "
                             f"{tuple(shape)}")
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("bad factor_type")
        scale = float(np.sqrt(self.magnitude / factor))
        if self.rnd_type == "uniform":
            _draw(arr, torch.rand(shape, generator=gen) * (2 * scale)
                  - scale)
        elif self.rnd_type == "gaussian":
            _draw(arr, torch.randn(shape, generator=gen) * scale)
        else:
            raise ValueError("bad rnd_type")


@register("msraprelu")
class MSRAPrelu(Xavier):
    """He init for PReLU nets: gaussian Xavier, magnitude
    2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register("bilinear")
class Bilinear(Initializer):
    """A bilinear upsampling kernel."""

    def _init_weight(self, desc, arr, gen):
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(int(np.prod(shape)))
        x, y = i % shape[3], (i // shape[3]) % shape[2]
        weight = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        _draw(arr, torch.from_numpy(weight.astype(np.float32)))


@register("lstmbias")
class LSTMBias(Initializer):
    """Zeros, and ``forget_bias`` on the forget gate's quarter."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr, gen):
        arr.zero_()
        num_hidden = int(arr.shape[0] / 4)
        arr[num_hidden:2 * num_hidden] = self.forget_bias

    _init_bias = _init_weight
    _init_default = _init_weight


@register("mixed")
class Mixed:
    """The first initializer whose pattern matches the name."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must pair up")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, desc, arr, generator=None):
        for prog, init in self.map:
            if prog.match(str(desc)):
                init(desc, arr, generator)
                return
        raise ValueError(f"no initializer pattern matches {desc}; add "
                         "a '.*' fallback")


@register("load")
class Load:
    """Values from a saved dict (name -> array, or an ``nd.save`` file);
    ``default_init`` for names it lacks."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .ndarray import load as nd_load
            from .context import cpu
            param = nd_load(param, ctx=cpu())
        self.param = {k.split(":", 1)[-1]: v for k, v in param.items()}
        self.default_init = default_init

    @torch.no_grad()
    def __call__(self, desc, arr, generator=None):
        name = str(desc)
        if name in self.param:
            src = self.param[name]
            src = _tensor(src) if isinstance(src, NDArray) \
                else torch.as_tensor(np.asarray(src))
            t = _tensor(arr)
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(
                    f"shape mismatch for {name}: saved "
                    f"{tuple(src.shape)} vs required {tuple(t.shape)}")
            t.copy_(src)
        else:
            if self.default_init is None:
                raise ValueError(f"no saved param and no default init "
                                 f"for {name}")
            self.default_init(desc, arr, generator)


def initialize(module, init, generator=None):
    """Initialize every parameter of ``module``, in the order of
    ``named_parameters()``: a Gluon parameter with its own initializer
    if its layer gave it one, else with ``init``, on the device it lives
    on (a deferred one records the choice for its layer's first
    forward); a plain torch parameter with ``init``, by its name.
    Returns the module."""
    init = create(init)
    seen = set()
    for m in module.modules():
        own = getattr(m, "_gluon_params", None)
        if own is None:
            for name, t in m.named_parameters(recurse=False):
                init(name, t.data, generator)
            continue
        for _, p in own.values():
            if id(p) in seen:
                continue
            seen.add(id(p))
            chosen = create(p.init) if p.init is not None else init
            p._init_on(p._target(None), chosen, generator, False)
    return module


class _InitModule:
    """The ``init`` namespace alias (``mx.init.Xavier()`` in the
    reference)."""
    InitDesc = InitDesc
    Initializer = Initializer
    Zero = Zero
    One = One
    Constant = Constant
    Uniform = Uniform
    Normal = Normal
    Orthogonal = Orthogonal
    Xavier = Xavier
    MSRAPrelu = MSRAPrelu
    Bilinear = Bilinear
    LSTMBias = LSTMBias
    Mixed = Mixed
    Load = Load


init = _InitModule()
