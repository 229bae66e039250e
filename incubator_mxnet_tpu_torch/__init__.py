"""incubator_mxnet_tpu_torch — the PyTorch/CUDA port of
``incubator_mxnet_tpu`` for NVIDIA Hopper.

It keeps the JAX package's module paths and names, and uses PyTorch's
idiom inside: ``nn.Module``s, plain functions on tensors, an explicit
``device`` and an explicit ``torch.Generator``.  Every kernel the JAX
package wrote in Pallas becomes a hand-written CUDA kernel, built from
``csrc/`` at first use.  Entry points run on the first CUDA card unless
the caller passes ``device="cpu"``, which runs the plain PyTorch path.

The imperative surface rides on the op registry (``ops.registry``):
``nd`` (NDArray and one function per registered op), ``autograd`` on
torch's own, ``engine``, and ``rtc``, which turns a CUDA kernel given as
source text into an op.

This package imports neither JAX nor ``incubator_mxnet_tpu``.
"""
from .base import __version__, MXNetError
from . import (base, context, random, initializer, ops, gluon, convert,
               parallel, engine, autograd)
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import rtc
from .context import cpu, gpu, default_device

__all__ = ["__version__", "MXNetError", "base", "context", "random",
           "initializer", "ops", "gluon", "convert", "parallel", "engine",
           "autograd", "nd", "ndarray", "NDArray", "rtc", "cpu", "gpu",
           "default_device"]
