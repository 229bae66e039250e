"""``nd`` namespace (twin of ``incubator_mxnet_tpu/ndarray``): NDArray
plus the imperative op surface generated from the op registry, and the
sparse storage types (``nd.sparse``)."""
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
from . import sparse   # noqa: E402
from .sparse import CSRNDArray, RowSparseNDArray  # noqa: E402

# the imperative cast_storage is storage-aware: dense to dense goes
# through the registry op (differentiable, recorded); a sparse target or
# source goes through the sparse converters
_registry_cast_storage = cast_storage  # noqa: F821 (from the registry)


def cast_storage(arr, stype="default"):  # noqa: F811
    if stype == "default" and not isinstance(arr,
                                             sparse.BaseSparseNDArray):
        return _registry_cast_storage(arr, stype="default")
    return sparse.cast_storage(arr, stype)


__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "imperative_invoke", "waitall", "moveaxis",
           "save", "load", "to_dlpack_for_read", "to_dlpack_for_write",
           "from_dlpack", "random", "linalg", "sparse", "CSRNDArray",
           "RowSparseNDArray", "cast_storage"]
