"""Training on the card (twin of ``incubator_mxnet_tpu/parallel``).

  optim          — functional optimizers (sgd, adam, nag) and lr
                   schedules, updating in place
  functional     — functionalize / PureBlock: a Gluon block as a pure
                   function of its parameters and states
  data_parallel  — ShardedTrainStep: forward, backward and optimizer
                   update of a module or a Gluon block, on one card

The multi-card modes of the JAX package (meshes, sharding rules, ring
and Ulysses attention, pipelines, sharded checkpoints) come with later
slices.
"""
from . import optim
from .functional import PureBlock, functionalize
from .data_parallel import ShardedTrainStep

__all__ = ["optim", "PureBlock", "functionalize", "ShardedTrainStep"]
