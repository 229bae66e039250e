"""Errors of the port (twin of ``incubator_mxnet_tpu/base.py``, the
subset the port uses)."""
__version__ = "0.1.0"


class MXNetError(RuntimeError):
    """Error raised by the port's framework code."""
