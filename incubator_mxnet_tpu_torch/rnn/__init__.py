"""Legacy mx.rnn API (twin of ``incubator_mxnet_tpu/rnn``; ref:
python/mxnet/rnn/): symbolic-era RNN cells and the bucketed data
iterator.  The cell classes re-export gluon's, as in the JAX package
(the reference kept two parallel hierarchies; one is enough here —
same math, same parameter names)."""
from ..gluon.rnn.rnn_cell import (RecurrentCell, RNNCell, LSTMCell,
                                  GRUCell, SequentialRNNCell,
                                  DropoutCell, ModifierCell,
                                  ZoneoutCell, ResidualCell,
                                  BidirectionalCell)
from .io import BucketSentenceIter, encode_sentences

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell",
           "BucketSentenceIter", "encode_sentences"]
