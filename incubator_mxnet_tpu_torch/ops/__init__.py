"""Ops of the port: the op registry with its plain PyTorch ops, and the
wrappers of the hand-written CUDA kernels built by ``_build``.
Importing this package registers every op (see ``registry``)."""
from . import _build, registry
from .registry import OPS, OpDef, defop, alias, get_op, find_op, list_ops
# registration side effects: order matters only for alias targets
from . import elemwise, reduce, matrix, indexing, init_op, optimizer_op
from . import flash
from ._build import LAUNCHES, reset_launches
from .flash import flash_attention, flash_attention_fwd
from .matrix import rope_fn

__all__ = ["LAUNCHES", "reset_launches", "flash_attention",
           "flash_attention_fwd", "rope_fn", "flash", "matrix", "_build",
           "registry", "elemwise", "reduce", "indexing", "init_op",
           "optimizer_op", "OPS", "OpDef", "defop", "alias", "get_op",
           "find_op", "list_ops"]
