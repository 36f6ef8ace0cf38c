"""Contrib recurrent cells of the PyTorch port (``mxtpu``'s
``gluon/contrib/rnn/rnn_cell.py``): ``VariationalDropoutCell`` (one mask
a sequence for each of inputs, states and outputs) and ``LSTMPCell``
(an LSTM whose recurrent state is a learned projection of its output).
"""
from __future__ import annotations

from ...rnn.rnn_cell import ModifierCell, HybridRecurrentCell

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """Locked dropout around a cell (reference contrib rnn_cell.py:26,
    Gal and Ghahramani): the mask drawn at a sequence's first step is
    applied at every step until ``reset`` (``unroll`` resets first). The
    masks are instance state between eager steps, so the cell refuses
    ``hybridize``, as ``mxtpu``'s does."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _alias(self):
        return "vardrop"

    def hybridize(self, active=True, **kwargs):
        if active:
            raise NotImplementedError(
                "VariationalDropoutCell does not support hybridize: the "
                "per-sequence locked masks are instance state (reference "
                "contrib cell is also trace-hostile); unroll it eagerly")
        super().hybridize(active, **kwargs)

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _mask(self, F, name, like, rate):
        if getattr(self, name) is None and rate:
            # dropout over ones: scaled by 1 / (1 - rate) in training,
            # ones at inference, as Dropout itself
            setattr(self, name, F.Dropout(F.ones_like(like), p=rate))
        return getattr(self, name)

    def hybrid_forward(self, F, inputs, states):
        if self.drop_inputs:
            inputs = inputs * self._mask(F, "drop_inputs_mask", inputs,
                                         self.drop_inputs)
        if self.drop_states:
            states = [states[0] * self._mask(
                F, "drop_states_mask", states[0], self.drop_states)] + \
                list(states[1:])
        output, states = self.base_cell(inputs, states)
        if self.drop_outputs:
            output = output * self._mask(F, "drop_outputs_mask", output,
                                         self.drop_outputs)
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        return super().unroll(length, inputs, begin_state, layout,
                              merge_outputs, valid_length)


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a hidden projection (reference contrib rnn_cell.py:197,
    Sak et al. 2014): the recurrent state and output is r = W_hr (o *
    tanh(c)), ``projection_size`` wide, the cell ``hidden_size``."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        slices = F.split(i2h + h2h, num_outputs=4, axis=1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.tanh(slices[2])
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        hidden = out_gate * F.tanh(next_c)
        next_r = F.FullyConnected(hidden, h2r_weight, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]
