"""Fused Gluon RNN layers (twin of
``incubator_mxnet_tpu/gluon/rnn/rnn_layer.py``; ref:
python/mxnet/gluon/rnn/rnn_layer.py — RNN/LSTM/GRU over the fused
``RNN`` op, ``ops/rnn.py``: cuDNN on the card).

Parameters are kept unfused per layer and direction
(``{l,r}{i}_i2h_weight`` ...), the reference's names, and concatenated
into the op's flat vector at every forward (``_flat_params``), so
checkpoints cross with the cell-based API and with the JAX package.
The first layer's input width is deferred to the first forward when
``input_size`` is 0.  Begin states are made where the inputs live.
"""
import torch

from ...ndarray.ndarray import NDArray
from ...ops.rnn import _GATES
from ..block import HybridBlock
from .rnn_cell import (RNNCell, LSTMCell, GRUCell, SequentialRNNCell,
                       BidirectionalCell)

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """Base fused layer (ref: rnn_layer.py _RNNLayer)."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            f"invalid layout {layout}; must be TNC or NTC"
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer
        G = _GATES[mode]
        ng, ni, nh = G, input_size, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for j in ["l", "r"][:self._dir]:
                    # each becomes this block's torch parameter of its name
                    for name, shape, init in (
                            ("i2h_weight", (ng * nh, ni),
                             i2h_weight_initializer),
                            ("h2h_weight", (ng * nh, nh),
                             h2h_weight_initializer),
                            ("i2h_bias", (ng * nh,), i2h_bias_initializer),
                            ("h2h_bias", (ng * nh,), h2h_bias_initializer)):
                        self.params.get(f"{j}{i}_{name}", shape=shape,
                                        init=init, allow_deferred_init=True)
                ni = nh * self._dir

    def shape_from_input(self, x, *rest):
        ni = x.shape[-1]
        G = _GATES[self._mode]
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                self._param(f"{j}{i}_i2h_weight").shape = \
                    (G * self._hidden_size, ni)
            ni = self._hidden_size * self._dir

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states; ``ctx=`` puts them on a device (None: the
        card)."""
        from ... import nd
        func = func or nd.zeros
        states = []
        for info in self.state_info(batch_size):
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape=shape, **info, **kwargs))
        return states

    def _flat_params(self, params):
        """Concatenate per-layer params into the op's packed vector
        (all weights layer-major, then all biases)."""
        from ... import nd
        chunks = []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                chunks.append(params[f"{j}{i}_i2h_weight"].reshape(-1))
                chunks.append(params[f"{j}{i}_h2h_weight"].reshape(-1))
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                chunks.append(params[f"{j}{i}_i2h_bias"])
                chunks.append(params[f"{j}{i}_h2h_bias"])
        return nd.concat(*chunks, dim=0)

    def forward(self, inputs, states=None):
        if isinstance(states, (list, tuple)):
            states = [NDArray(s) if isinstance(s, torch.Tensor) else s
                      for s in states]
        return super().forward(inputs, states)

    def __call__(self, inputs, states=None):
        return self.forward(inputs, states)

    def hybrid_forward(self, F, inputs, states=None, **params):
        batch_axis = self._layout.find("N")
        batch_size = inputs.shape[batch_axis]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context)
        if isinstance(states, NDArray):
            states = [states]
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        flat = self._flat_params(params)
        out = F.RNN(inputs, flat, *states,
                    state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=True)
        outputs, out_states = out[0], list(out[1:])
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        if skip_states:
            return outputs
        return outputs, out_states

    def _unfuse(self):
        """Equivalent stack of unfused cells (ref: rnn_layer.py
        _unfuse) — shares this layer's parameters."""
        get_cell = {
            "rnn_relu": lambda **kw: RNNCell(self._hidden_size,
                                             activation="relu", **kw),
            "rnn_tanh": lambda **kw: RNNCell(self._hidden_size,
                                             activation="tanh", **kw),
            "lstm": lambda **kw: LSTMCell(self._hidden_size, **kw),
            "gru": lambda **kw: GRUCell(self._hidden_size, **kw),
        }[self._mode]
        stack = SequentialRNNCell(prefix=self.prefix,
                                  params=self.params)
        with stack.name_scope():
            ni = self._input_size
            for i in range(self._num_layers):
                kwargs = {
                    "input_size": ni,
                    "i2h_weight_initializer":
                        self._i2h_weight_initializer,
                    "h2h_weight_initializer":
                        self._h2h_weight_initializer,
                    "i2h_bias_initializer":
                        self._i2h_bias_initializer,
                    "h2h_bias_initializer":
                        self._h2h_bias_initializer,
                }
                if self._dir == 2:
                    stack.add(BidirectionalCell(
                        get_cell(prefix=f"l{i}_", **kwargs),
                        get_cell(prefix=f"r{i}_", **kwargs)))
                else:
                    stack.add(get_cell(prefix=f"l{i}_", **kwargs))
                ni = self._hidden_size * self._dir
        return stack


class RNN(_RNNLayer):
    """Vanilla multi-layer RNN (ref: rnn_layer.py RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer,
                         h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Fused multi-layer LSTM (ref: rnn_layer.py LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC",
                 dropout=0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer,
                         h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Fused multi-layer GRU (ref: rnn_layer.py GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC",
                 dropout=0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer,
                         h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
