"""Training on the card (twin of ``incubator_mxnet_tpu/parallel``).

  optim          — functional optimizers (sgd, adam, nag) and lr
                   schedules, multi-tensor updates in place
  functional     — functionalize / PureBlock: a Gluon block as a pure
                   function of its parameters and states
  data_parallel  — ShardedTrainStep: forward, backward and optimizer
                   update of a module or a Gluon block; on a CUDA
                   device one captured CUDA graph replay a step
  symbol_step    — SymbolTrainStep: the same for a bound Symbol graph,
                   Module's kvstore='tpu' step
  mesh           — named device meshes (one device per process here)

The multi-card modes of the JAX package (meshes over several cards,
sharding rules, ring and Ulysses attention, pipelines, sharded
checkpoints) come with ROADMAP item A9.
"""
from . import optim
from .functional import PureBlock, functionalize
from .data_parallel import ShardedTrainStep
from .mesh import (AXES, P, make_mesh, current_mesh, use_mesh,
                   named_sharding, replicated, shard_batch)
from .symbol_step import SymbolTrainStep

__all__ = ["optim", "PureBlock", "functionalize", "ShardedTrainStep",
           "SymbolTrainStep", "AXES", "P", "make_mesh", "current_mesh",
           "use_mesh", "named_sharding", "replicated", "shard_batch"]
