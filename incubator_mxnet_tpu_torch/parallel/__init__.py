"""Training on the card (twin of ``incubator_mxnet_tpu/parallel``).

  optim          — functional optimizers (sgd, adam, nag) and lr
                   schedules, multi-tensor updates in place
  functional     — functionalize / PureBlock: a Gluon block as a pure
                   function of its parameters and states
  data_parallel  — ShardedTrainStep: forward, backward and optimizer
                   update of a module or a Gluon block; on a CUDA
                   device one captured CUDA graph replay a step; over a
                   world of ranks dp x tp (DTensor) and ZeRO
  symbol_step    — SymbolTrainStep: the same for a bound Symbol graph,
                   Module's kvstore='tpu' step
  mesh           — named device meshes (one device per process; a
                   world of ranks is a DeviceMesh)
  sharding       — parameter sharding rules (regex -> PartitionSpec ->
                   DTensor placements) and the slice arithmetic
  checkpoint     — sharded reshardable checkpoints with a manifest, in
                   the JAX package's format

Ring and Ulysses attention and pipelines (the sp, pp and ep axes) are
ROADMAP item A9b.
"""
from . import optim
from .functional import PureBlock, functionalize
from .data_parallel import ShardedTrainStep
from .mesh import (AXES, P, make_mesh, current_mesh, use_mesh,
                   named_sharding, replicated, shard_batch)
from .symbol_step import SymbolTrainStep
from .sharding import ShardingRules, tp_rules_for_dense_stacks, constrain
from .checkpoint import (save_sharded, load_sharded, load_latest,
                         load_data_companion)

__all__ = ["optim", "PureBlock", "functionalize", "ShardedTrainStep",
           "SymbolTrainStep", "AXES", "P", "make_mesh", "current_mesh",
           "use_mesh", "named_sharding", "replicated", "shard_batch",
           "ShardingRules", "tp_rules_for_dense_stacks", "constrain",
           "save_sharded", "load_sharded", "load_latest",
           "load_data_companion"]
