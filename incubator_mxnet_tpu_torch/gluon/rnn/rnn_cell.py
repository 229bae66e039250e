"""Gluon recurrent cells (twin of
``incubator_mxnet_tpu/gluon/rnn/rnn_cell.py``; ref:
python/mxnet/gluon/rnn/rnn_cell.py — RecurrentCell:96, RNNCell:273,
LSTMCell:373, GRUCell:485, SequentialRNNCell:605, DropoutCell:677,
ModifierCell:728, ZoneoutCell:770, ResidualCell:815,
BidirectionalCell:849).

A cell is one time step: a couple of ``FullyConnected`` ops through
``nd``, recorded by torch's autograd like any eager op.  ``unroll``
steps it over a sequence in either layout (``TNC``, ``NTC``), and with
``valid_length`` masks the outputs past each sequence's end and returns
each sequence's state at its last valid step.  For whole-sequence speed
prefer the fused layers in ``rnn_layer.py`` (cuDNN on the card).

Parameters are the block's torch parameters under their reference names
(``i2h_weight``, ``h2h_weight``, ``i2h_bias``, ``h2h_bias``), the
input-to-hidden weight's width deferred to the first step when
``input_size`` is 0.  Begin states are made where the inputs live.
"""
from ... import ndarray as nd
from ..block import HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell",
           "LSTMCell", "GRUCell", "SequentialRNNCell", "DropoutCell",
           "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge):
    """Normalize inputs to a list of (N,C) steps.
    Returns (inputs, axis, batch_size)."""
    assert layout in ("TNC", "NTC"), f"bad layout {layout}"
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, (list, tuple)):
        assert length is None or len(inputs) == length
        # per-step arrays have already dropped the T axis: always (N,C)
        batch_size = inputs[0].shape[0]
        seq = list(inputs)
    else:
        batch_size = inputs.shape[batch_axis]
        L = inputs.shape[axis]
        assert length is None or L == length
        seq = _split_steps(inputs, L, axis)
    return seq, axis, batch_size


def _split_steps(x, num, axis):
    """Split along time and drop the time axis: per-step (N,C)."""
    outs = nd.SliceChannel(x, num_outputs=num, axis=axis,
                           squeeze_axis=True)
    return outs if isinstance(outs, (list, tuple)) else [outs]


def _merge(outputs, axis):
    return nd.stack(*outputs, axis=axis)


class RecurrentCell(HybridBlock):
    """Base recurrent cell (ref: rnn_cell.py RecurrentCell:96)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._child_blocks():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states (ref: rnn_cell.py begin_state); ``ctx=`` puts
        them on a device (None: the card)."""
        assert not self._modified, \
            "After applying modifier cells, call the modifier's " \
            "begin_state instead"
        func = func or nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape=shape, **info, **kwargs)
                          if "shape" not in kwargs else func(**kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell for `length` steps (ref: rnn_cell.py
        unroll:190)."""
        self.reset()
        seq, axis, batch_size = _format_sequence(length, inputs, layout,
                                                 merge_outputs)
        states = begin_state if begin_state is not None else \
            self.begin_state(batch_size=batch_size, ctx=seq[0].context)
        outputs = []
        all_states = []
        for i in range(len(seq)):
            out, states = self(seq[i], states)
            outputs.append(out)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            # final state of each sequence = its state at the last
            # VALID step, not after the padding (ref: rnn_cell.py
            # unroll — SequenceLast over stacked per-step states)
            states = [nd.SequenceLast(
                          _merge([s[i] for s in all_states], 0),
                          valid_length, use_sequence_length=True,
                          axis=0)
                      for i in range(len(states))]
            merged = _merge(outputs, axis)
            merged = nd.SequenceMask(merged, valid_length,
                                     use_sequence_length=True,
                                     axis=axis)
            if merge_outputs is False:
                outputs = _split_steps(merged, len(seq), axis)
            else:
                outputs = merged
            return outputs, states
        if merge_outputs is None or merge_outputs:
            outputs = _merge(outputs, axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell):
    """Cells whose step is a hybrid_forward (ref: rnn_cell.py:264).  A
    call runs the step directly: ``hybridize`` leaves cells alone, as in
    the JAX package."""

    def __call__(self, inputs, states):
        return self.forward(inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class _BaseDenseCell(HybridRecurrentCell):
    """Shared param plumbing for RNN/LSTM/GRU cells."""

    _gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        G = self._gates
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(G * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(G * hidden_size, hidden_size),
                init=h2h_weight_initializer)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(G * hidden_size,),
                init=i2h_bias_initializer)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(G * hidden_size,),
                init=h2h_bias_initializer)

    def shape_from_input(self, x, *rest):
        self._param("i2h_weight").shape = (
            self._gates * self._hidden_size, x.shape[-1])

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]


class RNNCell(_BaseDenseCell):
    """Elman RNN cell (ref: rnn_cell.py RNNCell:273)."""

    _gates = 1

    def __init__(self, hidden_size, activation="tanh", **kwargs):
        super().__init__(hidden_size, **kwargs)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight,
                       h2h_weight, i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(_BaseDenseCell):
    """LSTM cell, gate order i,f,c,o (ref: rnn_cell.py LSTMCell:373)."""

    _gates = 4

    def _alias(self):
        return "lstm"

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def hybrid_forward(self, F, inputs, states, i2h_weight,
                       h2h_weight, i2h_bias, h2h_bias):
        H = self._hidden_size
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * H)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * H)
        gates = i2h + h2h
        g = F.SliceChannel(gates, num_outputs=4, axis=-1)
        in_gate = F.Activation(g[0], act_type="sigmoid")
        forget_gate = F.Activation(g[1], act_type="sigmoid")
        in_transform = F.Activation(g[2], act_type="tanh")
        out_gate = F.Activation(g[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(_BaseDenseCell):
    """GRU cell, gate order r,z,n (ref: rnn_cell.py GRUCell:485)."""

    _gates = 3

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight,
                       h2h_weight, i2h_bias, h2h_bias):
        H = self._hidden_size
        prev_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * H)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=3 * H)
        ig = F.SliceChannel(i2h, num_outputs=3, axis=-1)
        hg = F.SliceChannel(h2h, num_outputs=3, axis=-1)
        reset_gate = F.Activation(ig[0] + hg[0], act_type="sigmoid")
        update_gate = F.Activation(ig[1] + hg[1], act_type="sigmoid")
        next_h_tmp = F.Activation(ig[2] + reset_gate * hg[2],
                                  act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + \
            update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack of cells applied in order (ref: rnn_cell.py:605)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._child_blocks(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._child_blocks(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._child_blocks():
            n = len(cell.state_info())
            cell_states = states[p:p + n]
            p += n
            inputs, cell_states = cell(inputs, cell_states)
            next_states.extend(cell_states)
        return inputs, next_states

    def __len__(self):
        return len(self._child_blocks())

    def __getitem__(self, i):
        return self._child_blocks()[i]


class DropoutCell(RecurrentCell):
    """Dropout on the cell stream (ref: rnn_cell.py DropoutCell:677)."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.rate = rate

    def state_info(self, batch_size=0):
        return []

    def __call__(self, inputs, states):
        self._counter += 1
        if self.rate > 0:
            inputs = nd.Dropout(inputs, p=self.rate)
        return inputs, states


class ModifierCell(RecurrentCell):
    """Base for cells wrapping another cell (ref: rnn_cell.py:728)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "cell already modified by another modifier"
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias() + "_",
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (ref: rnn_cell.py ZoneoutCell:770)."""

    def __init__(self, base_cell, zoneout_outputs=0.0,
                 zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout; wrap the " \
            "inner cells instead"
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def __call__(self, inputs, states):
        from ... import autograd
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        p_out, p_st = self.zoneout_outputs, self.zoneout_states

        def mask(p, like):
            return nd.Dropout(nd.ones_like(like), p=p)

        prev_output = self._prev_output if self._prev_output is not None \
            else nd.zeros_like(next_output)
        if autograd.is_training():
            output = nd.where(mask(p_out, next_output), next_output,
                              prev_output) if p_out != 0.0 \
                else next_output
            states = [nd.where(mask(p_st, ns), ns, s)
                      for s, ns in zip(states, next_states)] \
                if p_st != 0.0 else next_states
        else:
            # inference: expectation
            output = (1 - p_out) * next_output + p_out * prev_output \
                if p_out != 0.0 else next_output
            states = [(1 - p_st) * ns + p_st * s
                      for s, ns in zip(states, next_states)] \
                if p_st != 0.0 else next_states
        self._prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Adds the input to the output (ref: rnn_cell.py:815)."""

    def _alias(self):
        return "residual"

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(RecurrentCell):
    """Runs two cells over the sequence in both directions (ref:
    rnn_cell.py BidirectionalCell:849).  Step-call is invalid; only
    unroll works (matches reference)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell)
        self.register_child(r_cell)
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cells cannot be stepped; use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._child_blocks(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._child_blocks(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        seq, axis, batch_size = _format_sequence(length, inputs,
                                                 layout, None)
        states = begin_state if begin_state is not None else \
            self.begin_state(batch_size=batch_size, ctx=seq[0].context)
        l_cell, r_cell = self._child_blocks()
        n_l = len(l_cell.state_info(batch_size))
        step_layout = "TNC" if axis == 0 else "NTC"
        l_out, l_states = l_cell.unroll(
            length, seq, states[:n_l], layout=step_layout,
            merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            rev = list(reversed(seq))
        else:
            # sequence-aware reverse: each sequence's valid prefix is
            # reversed in place so the r_cell sees valid data first
            # (ref: rnn_cell.py BidirectionalCell.unroll —
            # SequenceReverse on inputs)
            merged_in = _merge(seq, 0)  # (T,N,C)
            rev_in = nd.SequenceReverse(merged_in, valid_length,
                                        use_sequence_length=True,
                                        axis=0)
            rev = _split_steps(rev_in, len(seq), 0)
        r_out, r_states = r_cell.unroll(
            length, rev, states[n_l:], layout=step_layout,
            merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            r_out = list(reversed(r_out))
        else:
            merged_r = _merge(r_out, 0)  # (T,N,H)
            merged_r = nd.SequenceReverse(merged_r, valid_length,
                                          use_sequence_length=True,
                                          axis=0)
            r_out = _split_steps(merged_r, len(seq), 0)
        outputs = [nd.concat(lo, ro, dim=-1)
                   for lo, ro in zip(l_out, r_out)]
        if merge_outputs is None or merge_outputs:
            outputs = _merge(outputs, axis)
        return outputs, l_states + r_states
