"""``sym`` namespace (twin of ``incubator_mxnet_tpu/symbol``): Symbol
plus one symbolic function per op of the port's registry."""
import sys as _sys

from .. import ops as _ops  # noqa: F401  (registers every op)
from .symbol import (Symbol, Variable, var, Group, load, load_json,
                     NameManager)
from . import register as _register

_internal = _register.populate(_sys.modules[__name__])

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "NameManager", "zeros", "ones", "full", "arange"]


def zeros(shape, dtype="float32", **kwargs):
    """Symbolic zeros tensor."""
    return _internal._zeros(shape=shape, dtype=dtype, **kwargs)


def ones(shape, dtype="float32", **kwargs):
    """Symbolic ones tensor."""
    return _internal._ones(shape=shape, dtype=dtype, **kwargs)


def full(shape, val, dtype="float32", **kwargs):
    """Symbolic constant-filled tensor."""
    return _internal._full(shape=shape, value=val, dtype=dtype, **kwargs)


def arange(start, stop=None, step=1.0, repeat=1, dtype="float32",
           **kwargs):
    """Symbolic arange."""
    return _internal._arange(start=start, stop=stop, step=step,
                             repeat=repeat, dtype=dtype, **kwargs)
