"""Gluon recurrent cells of the PyTorch port.

Counterpart of ``mxtpu/gluon/rnn/rnn_cell.py``: cells stepped one time
step a call, ``unroll`` over a sequence (NTC or TNC, merged or a list),
and the Sequential / Dropout / Zoneout / Residual / Bidirectional
modifiers. Gate orders and parameter names are ``mxtpu``'s, which are
the fused RNN op's: LSTM [i, f, g, o], GRU [r, z, n] with n = tanh(i2h_n
+ r * (h2h_n + b_hn)); so a fused layer's ``l0_i2h_weight`` drops into
an ``LSTMCell``'s ``i2h_weight`` and a cell net's ``.params`` file loads
in both packages under the same names.

A hybridized cell runs each step as its program (``HybridBlock``); a
step's states start on the inputs' context, with the steps' batch size
(``mxtpu`` takes the size of a step's axis at the layout's N, the
channels under TNC). ``valid_length`` is taken and not used, as in
``mxtpu``. The random cells (``DropoutCell``,
``ZoneoutCell``) draw from the port's generator, not JAX's.
"""
from __future__ import annotations

from ..block import Block, HybridBlock
from ... import ndarray as nd

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "ModifierCell", "DropoutCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(inputs, layout):
    """The inputs as a list of (N, C...) steps: (steps, time axis,
    length)."""
    axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        return list(inputs), axis, len(inputs)
    length = inputs.shape[axis]
    steps = [nd.squeeze(nd.slice_axis(inputs, axis=axis, begin=t,
                                      end=t + 1), axis=axis)
             for t in range(length)]
    return steps, axis, length


def _default_state(cell, steps, begin_state):
    """``begin_state``, else zeros for the steps' batch (a step's axis 0:
    ``mxtpu`` reads the layout's N axis of a step, which under TNC is
    the channel axis) on their context."""
    if begin_state is not None:
        return begin_state
    return cell.begin_state(steps[0].shape[0], ctx=steps[0].context)


class RecurrentCell(Block):
    """Base cell (reference rnn_cell.py:34)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified, \
            "After applying modifier cells, call the modifier's begin_state"
        func = func or nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            states.append(func(shape=info["shape"], **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run the cell over the sequence's steps (reference
        rnn_cell.py:206): (outputs, last states)."""
        steps, axis, length = _format_sequence(inputs, layout)
        states = _default_state(self, steps, begin_state)
        outputs = []
        for i in range(length):
            output, states = self(steps[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def forward(self, inputs, states):
        self._counter += 1
        return self._forward_step(inputs, states)

    def _forward_step(self, inputs, states):
        raise NotImplementedError

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """Hybridizable cell base: a step is ``HybridBlock``'s call."""

    def __init__(self, prefix=None, params=None):
        RecurrentCell.__init__(self, prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, inputs, states, **params):
        raise NotImplementedError


class _GatedCell(HybridRecurrentCell):
    """The four parameters of an RNN / LSTM / GRU cell, ``gates`` gate
    blocks of ``hidden_size`` rows each."""

    _gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, input_size, prefix, params):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        rows = self._gates * hidden_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(rows, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(rows, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(rows,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(rows,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _projections(self, F, inputs, state, i2h_weight, h2h_weight,
                     i2h_bias, h2h_bias):
        rows = self._gates * self._hidden_size
        return (F.FullyConnected(inputs, i2h_weight, i2h_bias,
                                 num_hidden=rows),
                F.FullyConnected(state, h2h_weight, h2h_bias,
                                 num_hidden=rows))


class RNNCell(_GatedCell):
    """Elman cell (reference rnn_cell.py:320)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """(reference rnn_cell.py:398). Gates [i, f, g, o]."""

    _gates = 4

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)

    def state_info(self, batch_size=0):
        return 2 * super().state_info(batch_size)

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        slices = F.split(i2h + h2h, num_outputs=4, axis=1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.tanh(slices[2])
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """(reference rnn_cell.py:518). Gates [r, z, n]."""

    _gates = 3

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h, h2h = self._projections(F, inputs, prev_h, i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        i2h = F.split(i2h, num_outputs=3, axis=1)
        h2h = F.split(h2h, num_outputs=3, axis=1)
        reset_gate = F.sigmoid(i2h[0] + h2h[0])
        update_gate = F.sigmoid(i2h[1] + h2h[1])
        next_h_tmp = F.tanh(i2h[2] + reset_gate * h2h[2])
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack cells (reference rnn_cell.py:620)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, **kwargs)

    def _split_states(self, states):
        pos = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            yield cell, states[pos:pos + n]
            pos += n

    def _forward_step(self, inputs, states):
        next_states = []
        for cell, state in self._split_states(states):
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        if begin_state is None:
            steps = inputs if isinstance(inputs, (list, tuple)) else \
                [nd.swapaxes(inputs, dim1=0, dim2=layout.find("N"))]
            begin_state = _default_state(self, steps, None)
        states = begin_state
        last = len(self._children) - 1
        next_states = []
        for i, (cell, state) in enumerate(self._split_states(states)):
            inputs, state = cell.unroll(
                length, inputs, state, layout,
                merge_outputs=None if i < last else merge_outputs)
            next_states.extend(state)
        return inputs, next_states

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)


class ModifierCell(HybridRecurrentCell):
    """Base for cells wrapping another cell (reference rnn_cell.py:718):
    the base cell's parameters and states."""

    def __init__(self, base_cell):
        assert not base_cell._modified
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias() + "_",
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size=batch_size,
                                           func=func or nd.zeros, **kwargs)
        self.base_cell._modified = True
        return begin


class DropoutCell(HybridRecurrentCell):
    """Dropout on the inputs a step, a new mask each (reference
    rnn_cell.py:774)."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.rate = rate

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self.rate > 0:
            inputs = F.Dropout(inputs, p=self.rate)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """(reference rnn_cell.py:826): each output and state entry kept from
    the step before with probability ``zoneout_*``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)
        prev_output = self._prev_output if self._prev_output is not None \
            else F.zeros_like(next_output)
        output = F.where(mask(self.zoneout_outputs, next_output),
                         next_output, prev_output) \
            if self.zoneout_outputs > 0.0 else next_output
        if self.zoneout_states > 0.0:
            states = [F.where(mask(self.zoneout_states, ns), ns, s)
                      for ns, s in zip(next_states, states)]
        else:
            states = next_states
        self._prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """(reference rnn_cell.py:885): output + inputs."""

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    """(reference rnn_cell.py:921): ``l_cell`` forward and ``r_cell``
    over the reversed steps, their outputs concatenated a step. It only
    unrolls: a step raises, as in ``mxtpu``."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, **kwargs)

    def _forward_step(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped; use unroll")

    forward = _forward_step

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        steps, axis, length = _format_sequence(inputs, layout)
        states = _default_state(self, steps, begin_state)
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info())
        l_outputs, l_states = l_cell.unroll(
            length, steps, states[:n_l], layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, list(reversed(steps)), states[n_l:], layout,
            merge_outputs=False)
        outputs = [nd.concat(lo, ro, dim=1) for lo, ro in
                   zip(l_outputs, reversed(r_outputs))]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
