"""Gluon basic layers (twin of
``incubator_mxnet_tpu/gluon/nn/basic_layers.py``), as Gluon blocks:
torch modules with the reference's names, parameters and
``hybrid_forward`` through ``nd`` (see ``gluon/block.py``).

Constructors take the reference's parameters in its order with its
defaults.  ``Dense``, ``Embedding`` and ``LayerNorm`` also take a
keyword-only ``device``: the parameters whose shapes are known are made
there at once (unfilled, for ``initializer.initialize`` or a weight
copy), and a deferred one at the first forward.  Without ``device`` they
are made by ``initialize(init, ctx)``, the reference's way.  Their torch
attributes are the reference's parameter names and layouts: ``Dense``
weight (units, in_units) and bias, ``Embedding`` weight (input_dim,
output_dim), ``LayerNorm``/``BatchNorm`` gamma and beta, ``BatchNorm``
running_mean and running_var.

An input width given as 0 (``in_units=0``, ``in_channels=0``, the
defaults) is deferred to the first forward, which sets it through the
op's shape hook (``ops/shape_hooks.py``).
"""
from ...context import as_device
from ...ops.shape_hooks import HOOKS
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "Dropout", "BatchNorm", "LeakyReLU", "Embedding", "Flatten",
           "Lambda", "HybridLambda", "InstanceNorm", "LayerNorm"]

# the reference's Activation act_types
_ACTIVATIONS = ("relu", "sigmoid", "tanh", "softrelu", "softsign")


def _place(block, device):
    """A layer built with ``device=``: its parameters live there; those
    of known shape are made now."""
    if device is None:
        return
    device = as_device(device)
    for _, p in block._gluon_params.values():
        p._device = device
        if p._shape_known():
            p._materialize(device)


def _set_shapes(block, op, x, params, names):
    """Deferred parameter shapes from the op's shape hook on x."""
    shapes = HOOKS[op]([tuple(x.shape)] + [None] * len(names), params)
    for name, shape in zip(names, shapes[1:]):
        block._param(name).shape = shape


class Sequential(Block):
    """Runs its children in the order they were added."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __iter__(self):
        return iter(self._modules.values())


class HybridSequential(HybridBlock):
    """Hybridizable sequential container."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __iter__(self):
        return iter(self._modules.values())


class Dense(HybridBlock):
    """Fully-connected layer: ``x @ weight.T + bias``, then
    ``activation`` (relu, sigmoid, tanh, softrelu, softsign).
    ``flatten=True`` first reshapes x to (N, -1); ``flatten=False``
    applies the layer over the last axis.  ``in_units=0`` defers the
    weight's shape to the first forward."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_units=0, *, device=None):
        super().__init__()
        if activation is not None and activation not in _ACTIVATIONS:
            raise ValueError(f"activation {activation!r}: takes None or "
                             f"{sorted(_ACTIVATIONS)}")
        self._units = units
        self._flatten = flatten
        self._use_bias = use_bias
        self._activation = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units),
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer)
            else:
                self.bias = None
        _place(self, device)

    def shape_from_input(self, x):
        _set_shapes(self, "FullyConnected", x,
                    dict(num_hidden=self._units, flatten=self._flatten),
                    ["weight"])

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=not self._use_bias,
                               flatten=self._flatten)
        if self._activation is not None:
            out = F.Activation(out, act_type=self._activation)
        return out


class Activation(HybridBlock):
    """An activation function (the Activation op's act_type)."""

    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act_type = activation

    def _alias(self):
        return self._act_type if hasattr(self, "_act_type") \
            else "activation"

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class Dropout(HybridBlock):
    """Inverted dropout: in training mode each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate); the input itself
    outside training.  Along ``axes`` the mask is shared (its size there
    is 1).  The mask draws from ``random.current_generator``: the
    generator the train step hands down through
    ``random.key_provider``, else the package's default generator for
    the input's device, never torch's global one."""

    def __init__(self, rate, axes=()):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self._rate = float(rate)
        self._axes = tuple(axes)

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis``.  The running stats are
    grad_req='null' parameters (``requires_grad=False``) that the op's
    aux write-back updates in training mode.  ``scale=False`` fixes
    gamma at 1 (the op's ``fix_gamma``); the layer's ``epsilon`` is
    1e-5 where the op's default is 1e-3."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", shape=(in_channels,),
                init=running_variance_initializer,
                allow_deferred_init=True, differentiable=False)

    def shape_from_input(self, x):
        _set_shapes(self, "BatchNorm", x, dict(axis=self._axis),
                    ["gamma", "beta", "running_mean", "running_var"])

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           eps=self._epsilon, momentum=self._momentum,
                           fix_gamma=not self._scale,
                           use_global_stats=self._use_global_stats,
                           axis=self._axis)


class LeakyReLU(HybridBlock):
    """max(x, alpha * x)."""

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class Embedding(HybridBlock):
    """Row lookup in a (input_dim, output_dim) table of ``dtype``."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, *, device=None):
        super().__init__()
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype)
        _place(self, device)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class Flatten(HybridBlock):
    """Reshape to (N, -1)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class Lambda(Block):
    """A function (or the name of an ``nd`` function) as a Block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd_mod
            function = getattr(nd_mod, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """``function(F, *args)`` (or the ``F`` function of that name) as a
    HybridBlock."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_name = function if isinstance(function, str) else \
            function.__name__
        self._func = function

    def hybrid_forward(self, F, *args):
        if isinstance(self._func, str):
            return getattr(F, self._func)(*args)
        return self._func(F, *args)


class InstanceNorm(HybridBlock):
    """Instance normalization over the spatial axes."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)

    def shape_from_input(self, x):
        _set_shapes(self, "InstanceNorm", x, {}, ["gamma", "beta"])

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis``: (x - mean) / sqrt(var +
    epsilon) * gamma + beta.  ``scale=False`` / ``center=False`` keep
    gamma / beta at their initial values (grad_req 'null', no
    gradient); ``in_channels=0`` defers their shape to the first
    forward."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, *, device=None):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
        _place(self, device)

    def shape_from_input(self, x):
        _set_shapes(self, "LayerNorm", x, dict(axis=self._axis),
                    ["gamma", "beta"])

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)
