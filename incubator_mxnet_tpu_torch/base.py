"""Errors and dtypes of the port (twin of ``incubator_mxnet_tpu/base.py``,
the subset the port uses)."""
import numpy as np
import torch

__version__ = "0.1.0"


class MXNetError(RuntimeError):
    """Error raised by the port's framework code."""


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
