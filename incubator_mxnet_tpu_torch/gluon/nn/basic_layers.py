"""Gluon basic layers of the port (twin of
``incubator_mxnet_tpu/gluon/nn/basic_layers.py``), as ``nn.Module``s
with the JAX package's parameter names and layouts: ``Dense`` weight
(units, in_units), ``Embedding`` weight (input_dim, output_dim),
``LayerNorm`` ``gamma``/``beta``.  Input widths are given up front
(PyTorch's idiom) instead of inferred at the first call.  Parameters
are float32: the dtype the model serves in, and the master weights a
train step updates.
"""
import torch
from torch import nn
from torch.nn import functional as F

from ... import context
from ... import random as _random

__all__ = ["Dense", "Embedding", "LayerNorm", "Dropout"]

_EPS = 1e-5


def _empty(shape, device):
    return nn.Parameter(torch.empty(shape, device=context.resolve(device),
                                    dtype=torch.float32))


class Dense(nn.Module):
    """Fully-connected layer over the last axis (the JAX layer with
    ``flatten=False``): ``x @ weight.T + bias``, then ReLU if
    ``activation="relu"``."""

    def __init__(self, units, in_units, activation=None, use_bias=True,
                 device=None):
        super().__init__()
        if activation not in (None, "relu"):
            raise ValueError(f"activation {activation!r}: this slice "
                             "has None and 'relu'")
        self._relu = activation == "relu"
        self.weight = _empty((units, in_units), device)
        self.bias = _empty((units,), device) if use_bias else None

    def forward(self, x):
        out = F.linear(x, self.weight, self.bias)
        return torch.relu(out) if self._relu else out


class Embedding(nn.Module):
    """Row lookup in a (input_dim, output_dim) table."""

    def __init__(self, input_dim, output_dim, device=None):
        super().__init__()
        self.weight = _empty((input_dim, output_dim), device)

    def forward(self, x):
        return F.embedding(x.long(), self.weight)


class LayerNorm(nn.Module):
    """Layer normalization over the last axis, eps 1e-5."""

    def __init__(self, in_channels, device=None):
        super().__init__()
        self.gamma = _empty((in_channels,), device)
        self.beta = _empty((in_channels,), device)

    def forward(self, x):
        return F.layer_norm(x, self.gamma.shape, self.gamma, self.beta,
                            _EPS)


class Dropout(nn.Module):
    """Inverted dropout: in training mode each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate); the identity in
    ``eval()``.  The mask draws from ``random.current_generator``: the
    generator the train step hands down through
    ``random.key_provider``, else the package's default generator for
    the input's device, never torch's global one."""

    def __init__(self, rate):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self._rate = float(rate)

    def forward(self, x):
        if not self.training or self._rate == 0.0:
            return x
        gen = _random.current_generator(x.device)
        keep = torch.rand(x.shape, generator=gen, device=x.device) \
            >= self._rate
        return torch.where(keep, x / (1.0 - self._rate),
                           torch.zeros((), dtype=x.dtype,
                                       device=x.device))
