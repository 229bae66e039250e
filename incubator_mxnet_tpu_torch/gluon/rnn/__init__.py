"""Gluon RNN API (twin of ``incubator_mxnet_tpu/gluon/rnn``; ref:
python/mxnet/gluon/rnn/): recurrent cells and the fused layers."""
from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell,
                       LSTMCell, GRUCell, SequentialRNNCell,
                       DropoutCell, ModifierCell, ZoneoutCell,
                       ResidualCell, BidirectionalCell)
from .rnn_layer import RNN, LSTM, GRU

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell",
           "LSTMCell", "GRUCell", "SequentialRNNCell", "DropoutCell",
           "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell", "RNN", "LSTM", "GRU"]
