"""Convolutional recurrent cells (twin of
``incubator_mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``; ref:
python/mxnet/gluon/contrib/rnn/conv_rnn_cell.py — Conv{1,2,3}D
{RNN,LSTM,GRU}Cell).

One generic base drives all nine cells: the input-to-hidden and
hidden-to-hidden projections are N-D convolutions (the port's
``Convolution`` op: cuDNN on the card), with the h2h conv
'same'-padded so the recurrent state keeps its spatial shape.  As in
the reference, ``input_shape`` (C, *spatial) is declared up front, so
every parameter and state shape is known at construction.
"""
from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tup(v, n, name):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    if len(v) != n:
        raise ValueError(f"{name} must have {n} dims, got {v}")
    return v


def _conv_out(size, kernel, pad, dilate):
    return tuple(
        (s + 2 * p - d * (k - 1) - 1) + 1
        for s, k, p, d in zip(size, kernel, pad, dilate))


class _BaseConvRNNCell(HybridRecurrentCell):
    """Shared conv/param plumbing (ref: conv_rnn_cell.py
    _BaseConvRNNCell:37)."""

    _gates = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 activation="tanh", conv_dims=2,
                 i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        n = conv_dims
        self._nd = n
        self._input_shape = tuple(input_shape)  # (C, *spatial)
        if len(self._input_shape) != n + 1:
            raise ValueError(
                f"input_shape needs {n + 1} dims (C, *spatial), got "
                f"{self._input_shape}")
        self._hidden_channels = hidden_channels
        self._i2h_kernel = _tup(i2h_kernel, n, "i2h_kernel")
        self._h2h_kernel = _tup(h2h_kernel, n, "h2h_kernel")
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise ValueError(
                f"h2h_kernel must be odd in every dim (got "
                f"{self._h2h_kernel}) so 'same' padding preserves "
                "the state's spatial shape")
        self._i2h_pad = _tup(i2h_pad, n, "i2h_pad")
        self._i2h_dilate = _tup(i2h_dilate, n, "i2h_dilate")
        self._h2h_dilate = _tup(h2h_dilate, n, "h2h_dilate")
        self._h2h_pad = tuple(
            d * (k - 1) // 2
            for k, d in zip(self._h2h_kernel, self._h2h_dilate))
        self._activation = activation

        in_c, in_spatial = self._input_shape[0], self._input_shape[1:]
        self._state_spatial = _conv_out(
            in_spatial, self._i2h_kernel, self._i2h_pad,
            self._i2h_dilate)
        G = self._gates
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight",
                shape=(G * hidden_channels, in_c) + self._i2h_kernel,
                init=i2h_weight_initializer)
            self.h2h_weight = self.params.get(
                "h2h_weight",
                shape=(G * hidden_channels,
                       hidden_channels) + self._h2h_kernel,
                init=h2h_weight_initializer)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(G * hidden_channels,),
                init=i2h_bias_initializer)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(G * hidden_channels,),
                init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hidden_channels) + \
            self._state_spatial
        if self._gates == 4:            # LSTM: h and c
            return [{"shape": shape, "__layout__": "NC" + "DHW"
                     [3 - self._nd:]}] * 2
        return [{"shape": shape,
                 "__layout__": "NC" + "DHW"[3 - self._nd:]}]

    def _convs(self, F, inputs, state, i2h_weight, h2h_weight, i2h_bias,
               h2h_bias):
        G = self._gates
        i2h = F.Convolution(
            inputs, i2h_weight, i2h_bias,
            kernel=self._i2h_kernel, pad=self._i2h_pad,
            dilate=self._i2h_dilate,
            num_filter=G * self._hidden_channels)
        h2h = F.Convolution(
            state, h2h_weight, h2h_bias,
            kernel=self._h2h_kernel, pad=self._h2h_pad,
            dilate=self._h2h_dilate,
            num_filter=G * self._hidden_channels)
        return i2h, h2h

    def _act(self, F, x):
        return F.Activation(x, act_type=self._activation)


class _ConvRNNCell(_BaseConvRNNCell):
    _gates = 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._convs(F, inputs, states[0], **params)
        out = self._act(F, i2h + h2h)
        return out, [out]


class _ConvLSTMCell(_BaseConvRNNCell):
    _gates = 4

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._convs(F, inputs, states[0], **params)
        gates = i2h + h2h
        g = F.SliceChannel(gates, num_outputs=4, axis=1)
        i = F.Activation(g[0], act_type="sigmoid")
        f = F.Activation(g[1], act_type="sigmoid")
        c_in = self._act(F, g[2])
        o = F.Activation(g[3], act_type="sigmoid")
        next_c = f * states[1] + i * c_in
        next_h = o * self._act(F, next_c)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    _gates = 3

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, **params):
        prev = states[0]
        i2h, h2h = self._convs(F, inputs, prev, **params)
        ig = F.SliceChannel(i2h, num_outputs=3, axis=1)
        hg = F.SliceChannel(h2h, num_outputs=3, axis=1)
        r = F.Activation(ig[0] + hg[0], act_type="sigmoid")
        z = F.Activation(ig[1] + hg[1], act_type="sigmoid")
        n = self._act(F, ig[2] + r * hg[2])
        next_h = (1.0 - z) * n + z * prev
        return next_h, [next_h]


def _specialize(base, dims, name):
    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, **kwargs):
        base.__init__(self, input_shape, hidden_channels, i2h_kernel,
                      h2h_kernel, conv_dims=dims, **kwargs)

    cls = type(name, (base,), {"__init__": __init__, "__doc__":
                               f"{dims}-D {base.__doc__ or name} "
                               f"(ref: conv_rnn_cell.py {name})"})
    return cls


Conv1DRNNCell = _specialize(_ConvRNNCell, 1, "Conv1DRNNCell")
Conv2DRNNCell = _specialize(_ConvRNNCell, 2, "Conv2DRNNCell")
Conv3DRNNCell = _specialize(_ConvRNNCell, 3, "Conv3DRNNCell")
Conv1DLSTMCell = _specialize(_ConvLSTMCell, 1, "Conv1DLSTMCell")
Conv2DLSTMCell = _specialize(_ConvLSTMCell, 2, "Conv2DLSTMCell")
Conv3DLSTMCell = _specialize(_ConvLSTMCell, 3, "Conv3DLSTMCell")
Conv1DGRUCell = _specialize(_ConvGRUCell, 1, "Conv1DGRUCell")
Conv2DGRUCell = _specialize(_ConvGRUCell, 2, "Conv2DGRUCell")
Conv3DGRUCell = _specialize(_ConvGRUCell, 3, "Conv3DGRUCell")
