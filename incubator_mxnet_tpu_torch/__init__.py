"""incubator_mxnet_tpu_torch — the PyTorch/CUDA port of
``incubator_mxnet_tpu`` for NVIDIA Hopper.

It keeps the JAX package's module paths and names, and uses PyTorch's
idiom inside: ``nn.Module``s, plain functions on tensors, an explicit
``device`` and an explicit ``torch.Generator``.  Every kernel the JAX
package wrote in Pallas becomes a hand-written CUDA kernel, built from
``csrc/`` at first use.  Entry points run on the first CUDA card unless
the caller passes ``device="cpu"``, which runs the plain PyTorch path.

This package imports neither JAX nor ``incubator_mxnet_tpu``.
"""
from .base import __version__, MXNetError
from . import (base, context, random, initializer, ops, gluon, convert,
               parallel)
from .context import cpu, gpu, default_device

__all__ = ["__version__", "MXNetError", "base", "context", "random",
           "initializer", "ops", "gluon", "convert", "parallel", "cpu",
           "gpu", "default_device"]
