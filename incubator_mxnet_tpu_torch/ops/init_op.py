"""Creation ops (twin of ``incubator_mxnet_tpu/ops/init_op.py``): _zeros,
_ones, _full, _arange and _eye.  ``_sparse_zeros`` comes with the sparse
storage types (ROADMAP item 8).  ``ctx`` is the device the result is
made on; ``nd`` fills it in (``context.default_device()`` when the
caller gives none)."""
import torch

from ..base import torch_dtype
from .registry import defop


def _dt(dtype):
    return torch_dtype(dtype or "float32")


def _shape(shape):
    return tuple(int(s) for s in shape)


@defop("_zeros", differentiable=False)
def _zeros(shape=(), dtype="float32", ctx=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=ctx)


@defop("_ones", differentiable=False)
def _ones(shape=(), dtype="float32", ctx=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype), device=ctx)


@defop("_full", differentiable=False)
def _full(shape=(), value=0.0, dtype="float32", ctx=None):
    return torch.full(_shape(shape), value, dtype=_dt(dtype), device=ctx)


@defop("_arange", differentiable=False)
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
            ctx=None, infer_range=False):
    if stop is None:                  # numpy: arange(stop)
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=_dt(dtype), device=ctx)
    if int(repeat) != 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


@defop("_eye", differentiable=False)
def _eye(N=0, M=0, k=0, dtype="float32", ctx=None):
    n, m = int(N), int(M) or int(N)
    rows = torch.arange(n, device=ctx)[:, None]
    cols = torch.arange(m, device=ctx)[None, :]
    return (cols - rows == int(k)).to(_dt(dtype))
