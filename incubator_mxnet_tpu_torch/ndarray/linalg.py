"""``nd.linalg`` namespace (twin of ``incubator_mxnet_tpu/ndarray/linalg.py``;
ref: python/mxnet/ndarray/linalg.py): every ``_linalg_*`` op under its
short name (``nd.linalg.potrf``, ...)."""
import sys as _sys

from ..ops.registry import OPS
from .register import make_nd_func

_mod = _sys.modules[__name__]
for _name, _op in list(OPS.items()):
    if _name.startswith("_linalg_"):
        setattr(_mod, _name[len("_linalg_"):], make_nd_func(_name, _op))
