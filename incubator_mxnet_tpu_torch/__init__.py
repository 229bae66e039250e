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
source text into an op.  ``gluon`` (Parameter, Block, layers, losses,
the Trainer, the ResNet and transformer model zoo), ``optimizer`` and
``lr_scheduler`` train through it; ``parallel`` holds the functional
train steps (on a CUDA device each one captured CUDA graph replay) and
the mesh, ``kvstore`` the parameter store.  The symbolic surface rides on the same registry: ``sym``
(Symbol, one function per op), ``Executor``, ``mod`` (``Module.fit``),
``metric``, ``io``, ``callback``, ``model`` (checkpoints) and
``monitor``, and ``rnn`` (the bucketed sentence iterator for
``mod.BucketingModule``); ``contrib`` names the ``_contrib_*`` ops
(detection, CTC, FFT, quantization) as ``nd.contrib`` and
``sym.contrib``; ``graph`` holds the pass pipeline every bind runs and the
``CachedOp`` behind ``HybridBlock.hybridize()``; ``operator`` holds the
``Custom`` ops written in Python.  ``serving`` serves ``TransformerLM`` traffic by
continuous batching over a paged KV cache.  The input pipeline is
``recordio``, ``image`` (``ImageRecordIter``, ``ImageDetIter``), ``io``'s
``DevicePrefetchIter`` and ``gluon.data``; ``profiler``, ``predictor``
(``Predictor``), ``visualization`` and ``test_utils`` complete the surface.
``perf`` holds the cost model, the device table, the MFU clock and the
memory planner that the train steps' preflight reads.

This package imports neither JAX nor ``incubator_mxnet_tpu``.
"""
from .base import __version__, MXNetError, MXTPUError, TShape
from . import (base, context, random, initializer, ops, gluon, convert,
               parallel, engine, autograd, optimizer, lr_scheduler)
from . import initializer as init
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import rtc
from . import utils
from . import resilience, telemetry, tracing, serving
from . import perf
from . import name, attribute
from .attribute import AttrScope
from . import symbol
from . import symbol as sym
from .symbol import Symbol
from .executor import Executor
from . import graph
from . import metric, io, callback, kvstore, model, monitor
from . import kvstore as kv
from . import dist
from .model import load_checkpoint, save_checkpoint
from . import module
from . import module as mod
from .module import Module
from . import rnn
from . import contrib
from . import operator
from . import recordio, image, profiler, predictor, visualization, test_utils
from .predictor import Predictor
from .utils.env import list_env
from .monitor import Monitor
from .io import DataBatch, DataDesc, DataIter, NDArrayIter
from .optimizer import Optimizer
from .context import (Context, cpu, gpu, tpu, cpu_pinned, current_context,
                      default_context, num_gpus, num_tpus, gpu_memory_info,
                      tpu_memory_info, default_device)

__all__ = ["__version__", "MXNetError", "base", "context", "random",
           "initializer", "init", "ops", "gluon", "convert", "parallel",
           "engine", "autograd", "optimizer", "lr_scheduler", "nd",
           "ndarray", "NDArray", "rtc", "resilience", "telemetry", "tracing",
           "perf",
           "list_env", "serving", "name",
           "attribute", "AttrScope", "symbol", "sym", "Symbol",
           "Executor", "graph", "metric", "io", "callback", "model", "monitor",
           "load_checkpoint", "save_checkpoint", "module", "mod",
           "Module", "rnn", "contrib", "Monitor", "DataBatch", "DataDesc", "DataIter",
           "NDArrayIter", "kvstore", "kv", "Context", "cpu", "gpu",
           "cpu_pinned", "current_context", "num_gpus", "gpu_memory_info",
           "default_device", "MXTPUError", "TShape", "Optimizer", "tpu",
           "num_tpus", "tpu_memory_info", "default_context", "operator",
           "recordio", "image", "profiler", "predictor", "Predictor",
           "visualization", "test_utils"]
