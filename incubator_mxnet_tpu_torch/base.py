"""Errors, shapes and dtypes of the port (twin of
``incubator_mxnet_tpu/base.py``): the reference's integer dtype enum,
``np_dtype`` / ``dtype_enum`` over it, ``TShape``, and ``torch_dtype``
for the tensors."""
import numpy as np
import torch

__version__ = "0.1.0"


class MXNetError(RuntimeError):
    """Error raised by the port's framework code."""


class MXTPUError(RuntimeError):
    """Framework error type (the reference's dmlc::Error role)."""


# mshadow's dtype enum, as the reference numbers it (kFloat32 = 0, ...)
_DTYPE_NP_TO_MX = {np.dtype(np.float32): 0, np.dtype(np.float64): 1,
                   np.dtype(np.float16): 2, np.dtype(np.uint8): 3,
                   np.dtype(np.int32): 4, np.dtype(np.int8): 5,
                   np.dtype(np.int64): 6}
_DTYPE_MX_TO_NP = {v: k for k, v in _DTYPE_NP_TO_MX.items()}
_NP_ALIASES = {"float": "float32", "double": "float64", "half": "float16",
               "bf16": "bfloat16"}


def np_dtype(dtype):
    """A dtype-ish (name, numpy dtype or type, or the integer enum) as a
    numpy dtype; bfloat16, which numpy lacks, as ``ml_dtypes``'s."""
    if isinstance(dtype, int):
        return _DTYPE_MX_TO_NP[dtype]
    if isinstance(dtype, str):
        dtype = _NP_ALIASES.get(dtype, dtype)
        if dtype == "bfloat16":
            import ml_dtypes
            return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(dtype)


def dtype_enum(dtype):
    """The reference's integer enum of a dtype-ish; 100 for types past
    its range (bfloat16)."""
    return _DTYPE_NP_TO_MX.get(np_dtype(dtype), 100)


class TShape(tuple):
    """A shape tuple (mshadow's TShape role)."""

    def __new__(cls, dims=()):
        return super().__new__(cls, (int(d) for d in dims))

    @property
    def ndim(self):
        return len(self)

    def prod(self):
        out = 1
        for d in self:
            out *= d
        return out


_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_ALIASES = {"float": "float32", "double": "float64", "half": "float16",
            "int": "int32", "long": "int64"}


def torch_dtype(dtype):
    """A dtype-ish (name, numpy dtype or type, torch dtype) as a
    ``torch.dtype`` (the role of the JAX package's ``np_dtype``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
    else:
        name = np.dtype(dtype).name
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise TypeError(f"dtype {dtype!r} has no torch counterpart "
                        "in the port") from None
