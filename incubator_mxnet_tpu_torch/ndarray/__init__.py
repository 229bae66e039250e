"""``nd`` namespace (twin of ``incubator_mxnet_tpu/ndarray``): NDArray
plus the imperative op surface generated from the op registry."""
import sys as _sys

from .. import ops as _ops  # noqa: F401  (registers every op)
from .ndarray import (NDArray, array, zeros, ones, full, empty, arange,
                      concatenate, imperative_invoke, waitall, moveaxis,
                      save, load, to_dlpack_for_read, to_dlpack_for_write,
                      from_dlpack)
from . import register as _register

_internal = _register.populate(_sys.modules[__name__])

from . import random   # noqa: E402
from . import linalg   # noqa: E402

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "imperative_invoke", "waitall", "moveaxis",
           "save", "load", "to_dlpack_for_read", "to_dlpack_for_write",
           "from_dlpack", "random", "linalg"]
