"""Gluon basic layers of the port (twin of
``incubator_mxnet_tpu/gluon/nn/basic_layers.py``), as ``nn.Module``s
with the reference's constructor signatures (its parameter names, order
and defaults; ``device`` is a keyword-only extra after them) and its
parameter names and layouts: ``Dense`` weight (units, in_units),
``Embedding`` weight (input_dim, output_dim), ``LayerNorm``
``gamma``/``beta``.

An input width given as 0 (``in_units=0``, ``in_channels=0``, the
defaults) is deferred, as in the reference: the parameter is a torch
``UninitializedParameter`` until the first forward gives it its shape
and the initializer that ``initializer.initialize`` recorded for it.
A parameter's own initializer (``weight_initializer=``,
``bias_initializer=``, ...) wins over the one passed to
``initializer.initialize``, as in the reference.  Parameters are
float32 unless a layer takes a ``dtype``: the dtype the model serves
in, and the master weights a train step updates.
"""
import torch
from torch import nn
from torch.nn import functional as F
from torch.nn.parameter import UninitializedParameter

from ... import context
from ... import random as _random
from ...base import torch_dtype

__all__ = ["Dense", "Embedding", "LayerNorm", "Dropout"]

# the reference's Activation act_types
_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": F.softsign}


def _param(shape, device, init, dtype=torch.float32, requires_grad=True):
    """A parameter of ``shape`` (uninitialized until
    ``initializer.initialize``) carrying its own initializer ``init``
    (None: the one ``initialize`` is given); a 0 in ``shape`` defers
    it to the first forward."""
    dev = context.resolve(device)
    if 0 in shape:
        param = UninitializedParameter(requires_grad, dev, dtype)
    else:
        param = nn.Parameter(torch.empty(shape, device=dev, dtype=dtype),
                             requires_grad)
    param.init = init
    return param


def _materialize(param, shape, name):
    """Give a deferred parameter its shape, then the initializer that
    ``initializer.initialize`` recorded for it, if any (``name`` picks
    the rule by suffix, as there)."""
    with torch.no_grad():
        param.materialize(shape)
        deferred = param.__dict__.pop("deferred_init", None)
        if deferred is not None:
            init, generator = deferred
            init(name, param.data, generator)


class Dense(nn.Module):
    """Fully-connected layer: ``x @ weight.T + bias``, then
    ``activation`` (the reference's act_types: relu, sigmoid, tanh,
    softrelu, softsign).  ``flatten=True`` first reshapes x to (N, -1),
    as the reference does; ``flatten=False`` applies the layer over the
    last axis.  ``in_units=0`` defers the weight's shape to the first
    forward."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_units=0, *, device=None):
        super().__init__()
        if activation is not None and activation not in _ACTIVATIONS:
            raise ValueError(f"activation {activation!r}: takes None or "
                             f"{sorted(_ACTIVATIONS)}")
        self._units = units
        self._flatten = flatten
        self._act = _ACTIVATIONS.get(activation)
        self.weight = _param((units, in_units), device, weight_initializer)
        self.bias = _param((units,), device, bias_initializer) \
            if use_bias else None

    def forward(self, x):
        if self._flatten:
            x = x.reshape(x.shape[0], -1)
        if isinstance(self.weight, UninitializedParameter):
            _materialize(self.weight, (self._units, x.shape[-1]), "weight")
        out = F.linear(x, self.weight, self.bias)
        return self._act(out) if self._act is not None else out


class Embedding(nn.Module):
    """Row lookup in a (input_dim, output_dim) table of ``dtype``."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, *, device=None):
        super().__init__()
        self.weight = _param((input_dim, output_dim), device,
                             weight_initializer, torch_dtype(dtype))

    def forward(self, x):
        return F.embedding(x.long(), self.weight)


class LayerNorm(nn.Module):
    """Layer normalization over ``axis``: (x - mean) / sqrt(var +
    epsilon) * gamma + beta.  ``scale=False`` / ``center=False`` keep
    gamma / beta at their initial values (no gradient), as the
    reference does; ``in_channels=0`` defers their shape to the first
    forward."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, *, device=None):
        super().__init__()
        self._axis = axis
        self._eps = epsilon
        self.gamma = _param((in_channels,), device, gamma_initializer,
                            requires_grad=scale)
        self.beta = _param((in_channels,), device, beta_initializer,
                           requires_grad=center)

    def forward(self, x):
        ax = self._axis % x.dim()
        if isinstance(self.gamma, UninitializedParameter):
            _materialize(self.gamma, (x.shape[ax],), "gamma")
            _materialize(self.beta, (x.shape[ax],), "beta")
        y = x.movedim(ax, -1)
        y = F.layer_norm(y, self.gamma.shape, self.gamma, self.beta,
                         self._eps)
        return y.movedim(-1, ax)


class Dropout(nn.Module):
    """Inverted dropout: in training mode each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate); the identity in
    ``eval()``.  Along ``axes`` the mask is shared (its size there is
    1), as in the reference.  The mask draws from
    ``random.current_generator``: the generator the train step hands
    down through ``random.key_provider``, else the package's default
    generator for the input's device, never torch's global one."""

    def __init__(self, rate, axes=()):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self._rate = float(rate)
        self._axes = tuple(axes)

    def forward(self, x):
        if not self.training or self._rate == 0.0:
            return x
        shape = list(x.shape)
        for a in self._axes:
            shape[a] = 1
        gen = _random.current_generator(x.device)
        keep = torch.rand(shape, generator=gen, device=x.device) \
            >= self._rate
        return torch.where(keep, x / (1.0 - self._rate),
                           torch.zeros((), dtype=x.dtype,
                                       device=x.device))
