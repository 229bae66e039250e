"""Ops of the port: plain PyTorch functions, and wrappers of the
hand-written CUDA kernels built by ``_build``."""
from . import _build, flash, matrix
from ._build import LAUNCHES, reset_launches
from .flash import flash_attention, flash_attention_fwd
from .matrix import rope_fn

__all__ = ["LAUNCHES", "reset_launches", "flash_attention",
           "flash_attention_fwd", "rope_fn", "flash", "matrix", "_build"]
