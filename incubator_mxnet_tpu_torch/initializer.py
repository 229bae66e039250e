"""Weight initializers (twin of ``incubator_mxnet_tpu/initializer.py``:
``Zero``, ``One`` and ``Xavier``, the JAX tests' initializer).

An initializer is called with a parameter's name and tensor and picks
by the name's suffix, as the reference does: ``*weight`` gets the
initializer's own rule, ``*bias``/``*beta`` zeros, ``*gamma`` ones.
Random draws come from an explicit CPU ``torch.Generator`` and are
copied to the parameter's device, so one seed gives the same weights
on every device.

``initialize`` gives each parameter its own initializer where its layer
set one (``Dense(weight_initializer=...)``; the ``init`` attribute),
else the one it is given, as the reference's ``Parameter.initialize``
does; a deferred parameter (``in_units=0``) keeps that choice for its
first forward.
"""
import numpy as np
import torch
from torch.nn.parameter import UninitializedParameter

from .random import default_generator

__all__ = ["Initializer", "Zero", "One", "Xavier", "create", "initialize"]


class Initializer:
    """Base initializer; callable on (name, tensor[, generator])."""

    @torch.no_grad()
    def __call__(self, name, arr, generator=None):
        name = name.lower()
        if name.endswith("weight"):
            self._init_weight(name, arr, generator or default_generator())
        elif name.endswith("bias") or name.endswith("beta"):
            arr.zero_()
        elif name.endswith("gamma"):
            arr.fill_(1.0)
        else:
            self._init_weight(name, arr, generator or default_generator())

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError


class Zero(Initializer):
    def _init_weight(self, name, arr, generator):
        arr.zero_()


class One(Initializer):
    def _init_weight(self, name, arr, generator):
        arr.fill_(1.0)


class Xavier(Initializer):
    """Glorot init with the reference's defaults (uniform, fan average,
    magnitude 3): uniform(-s, s) with s = sqrt(3 / ((fan_in + fan_out)
    / 2)), fans from the shape (out, in, *kernel)."""

    def _init_weight(self, name, arr, generator):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError(f"Xavier requires ndim>=2, got {name} "
                             f"{tuple(shape)}")
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        factor = (shape[0] + shape[1]) * hw_scale / 2.0
        scale = float(np.sqrt(3.0 / factor))
        arr.copy_(torch.rand(shape, generator=generator) * (2 * scale)
                  - scale)


_NAMES = {"zeros": Zero, "ones": One, "xavier": Xavier}


def create(init):
    """An initializer from an instance or from the reference's registry
    name (``"zeros"``, ``"ones"``, ``"xavier"``; any case)."""
    if isinstance(init, Initializer):
        return init
    try:
        return _NAMES[init.lower()]()
    except (AttributeError, KeyError):
        raise ValueError(f"initializer {init!r}: the port has "
                         f"{sorted(_NAMES)}") from None


def initialize(module, init, generator=None):
    """Initialize every parameter of ``module``, in the order of
    ``named_parameters()``: with its own initializer if its layer gave
    it one, else with ``init``.  A deferred parameter records the choice
    and is initialized at its layer's first forward.  Returns the
    module."""
    for name, param in module.named_parameters():
        own = getattr(param, "init", None)
        chosen = create(own) if own is not None else init
        if isinstance(param, UninitializedParameter):
            param.deferred_init = (chosen, generator)
        else:
            chosen(name, param.data, generator)
    return module
