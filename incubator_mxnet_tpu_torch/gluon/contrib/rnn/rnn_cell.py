"""Contrib recurrent cells (twin of
``incubator_mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``; ref:
python/mxnet/gluon/contrib/rnn/rnn_cell.py — VariationalDropoutCell).
"""
from .... import autograd, ndarray as nd
from ...rnn.rnn_cell import (BidirectionalCell, ModifierCell,
                             SequentialRNNCell)

__all__ = ["VariationalDropoutCell"]


class VariationalDropoutCell(ModifierCell):
    """Variational (locked) dropout: ONE mask per sequence, shared
    across time steps, separately for inputs / states / outputs
    (Gal & Ghahramani 2016).  Masks are drawn on the first step, from
    ``random.current_generator`` of the step's device, and persist until
    ``reset()`` — call it between sequences when stepping manually
    (``unroll`` resets automatically)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        if drop_states and isinstance(base_cell, BidirectionalCell):
            raise ValueError(
                "BidirectionalCell doesn't support variational state "
                "dropout; wrap the inner cells instead")
        if drop_states and isinstance(base_cell, SequentialRNNCell):
            raise ValueError(
                "wrap the cells inside the SequentialRNNCell "
                "individually for variational state dropout")
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._masks = {}

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self._masks = {}

    def _mask(self, key, p, like):
        if key not in self._masks:
            self._masks[key] = nd.Dropout(nd.ones_like(like), p=p)
        return self._masks[key]

    def __call__(self, inputs, states):
        if autograd.is_training():
            if self.drop_inputs:
                inputs = inputs * self._mask(
                    "in", self.drop_inputs, inputs)
            if self.drop_states:
                states = [states[0] * self._mask(
                    "st", self.drop_states, states[0])] + \
                    list(states[1:])
        output, next_states = self.base_cell(inputs, states)
        if autograd.is_training() and self.drop_outputs:
            output = output * self._mask(
                "out", self.drop_outputs, output)
        return output, next_states

    # no unroll override needed: RecurrentCell.unroll calls
    # self.reset() first, which redraws the locked masks per sequence
