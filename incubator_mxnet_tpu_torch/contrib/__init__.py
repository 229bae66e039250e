"""The contrib namespace (twin of ``incubator_mxnet_tpu/contrib``): the
``_contrib_*`` ops of the registry without their prefix, as
``contrib.nd`` / ``contrib.sym`` and as ``nd.contrib`` / ``sym.contrib``
(ref: python/mxnet/contrib/__init__.py), e.g.
``mt.nd.contrib.MultiBoxPrior``.  ``import
incubator_mxnet_tpu_torch.ndarray.contrib`` works as a statement too.
``contrib.autograd`` is the legacy autograd namespace and
``contrib.tensorboard`` the metric-logging callback."""
import sys as _sys
import types as _types

from .. import ndarray as _nd
from .. import symbol as _sym
from ..ops.registry import OPS as _OPS

__all__ = ["ndarray", "nd", "symbol", "sym", "autograd", "tensorboard"]


def _make_namespace(modname, internal):
    m = _types.ModuleType(modname)
    for name in list(_OPS):
        if name.startswith("_contrib_"):
            fn = getattr(internal, name, None)
            if fn is not None:
                setattr(m, name[len("_contrib_"):], fn)
    return m


ndarray = nd = _make_namespace(__name__ + ".ndarray", _nd._internal)
symbol = sym = _make_namespace(__name__ + ".symbol", _sym._internal)

_nd.contrib = ndarray
_sym.contrib = symbol
_sys.modules[_nd.__name__ + ".contrib"] = ndarray
_sys.modules[_sym.__name__ + ".contrib"] = symbol

from . import autograd, tensorboard  # noqa: E402  (after the namespaces)
