"""Convolutional recurrent cells of the PyTorch port (``mxtpu``'s
``gluon/contrib/rnn/conv_rnn_cell.py``): RNN / LSTM / GRU cells whose
input-to-hidden and hidden-to-hidden maps are 1-, 2- or 3-D
convolutions (ConvLSTM, Shi et al. 2015) over the port's
``Convolution`` (cuDNN on the card). ``input_shape`` (C, *spatial) is
given at construction; the state is (N, hidden_channels, *spatial after
the i2h convolution at stride 1 and ``i2h_pad``), and the h2h
convolution pads by half its odd kernel, so the state keeps its shape.
Gate orders as the dense cells': LSTM [i, f, g, o], GRU [r, z, n].
"""
from __future__ import annotations

from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tuplize(v, ndim, name):
    if isinstance(v, int):
        return (v,) * ndim
    v = tuple(v)
    assert len(v) == ndim, "%s must have %d elements" % (name, ndim)
    return v


class _BaseConvRNNCell(HybridRecurrentCell):
    """(``mxtpu``'s ``_BaseConvRNNCell``, ``conv_rnn_cell.py:29``)."""

    _num_gates = 1
    _num_states = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, activation="tanh", conv_ndim=2,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._ndim = conv_ndim
        self._input_shape = tuple(input_shape)
        self._hidden_channels = hidden_channels
        self._activation = activation
        self._i2h_kernel = _tuplize(i2h_kernel, conv_ndim, "i2h_kernel")
        self._h2h_kernel = _tuplize(h2h_kernel, conv_ndim, "h2h_kernel")
        for k in self._h2h_kernel:
            assert k % 2 == 1, ("h2h_kernel must be odd for same-padding; "
                                "got %s" % (self._h2h_kernel,))
        self._i2h_pad = _tuplize(i2h_pad, conv_ndim, "i2h_pad")
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        rows = self._num_gates * hidden_channels
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(rows, self._input_shape[0])
            + self._i2h_kernel, init=i2h_weight_initializer,
            allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(rows, hidden_channels) + self._h2h_kernel,
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(rows,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(rows,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    @property
    def _state_shape(self):
        spatial = tuple(s + 2 * p - k + 1 for s, p, k in zip(
            self._input_shape[1:], self._i2h_pad, self._i2h_kernel))
        return (self._hidden_channels,) + spatial

    def state_info(self, batch_size=0):
        shape = (batch_size,) + self._state_shape
        return [{"shape": shape, "__layout__": "NC" + "DHW"[-self._ndim:]}
                for _ in range(self._num_states)]

    def _convs(self, F, inputs, states, i2h_weight, h2h_weight, i2h_bias,
               h2h_bias):
        rows = self._num_gates * self._hidden_channels
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            num_filter=rows)
        h2h = F.Convolution(states[0], h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            num_filter=rows)
        return i2h, h2h

    def _act(self, F, x):
        return F.Activation(x, act_type=self._activation)


class _ConvRNNCell(_BaseConvRNNCell):
    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states, i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        out = self._act(F, i2h + h2h)
        return out, [out]


class _ConvLSTMCell(_BaseConvRNNCell):
    _num_gates = 4
    _num_states = 2

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states, i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        sl = F.split(i2h + h2h, num_outputs=4, axis=1)
        i = F.sigmoid(sl[0])
        f = F.sigmoid(sl[1])
        g = self._act(F, sl[2])
        o = F.sigmoid(sl[3])
        next_c = f * states[1] + i * g
        next_h = o * self._act(F, next_c)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    _num_gates = 3

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states, i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        i2h = F.split(i2h, num_outputs=3, axis=1)
        h2h = F.split(h2h, num_outputs=3, axis=1)
        r = F.sigmoid(i2h[0] + h2h[0])
        z = F.sigmoid(i2h[1] + h2h[1])
        n = self._act(F, i2h[2] + r * h2h[2])
        next_h = (1 - z) * n + z * states[0]
        return next_h, [next_h]


def _make(ndim, base, name, doc):
    class Cell(base):
        __doc__ = doc

        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, activation="tanh", **kwargs):
            super().__init__(input_shape, hidden_channels, i2h_kernel,
                             h2h_kernel, i2h_pad, activation=activation,
                             conv_ndim=ndim, **kwargs)

    Cell.__name__ = Cell.__qualname__ = name
    return Cell


Conv1DRNNCell = _make(1, _ConvRNNCell, "Conv1DRNNCell",
                      "1-D convolutional RNN cell (reference :218).")
Conv2DRNNCell = _make(2, _ConvRNNCell, "Conv2DRNNCell",
                      "2-D convolutional RNN cell (reference :285).")
Conv3DRNNCell = _make(3, _ConvRNNCell, "Conv3DRNNCell",
                      "3-D convolutional RNN cell (reference :352).")
Conv1DLSTMCell = _make(1, _ConvLSTMCell, "Conv1DLSTMCell",
                       "1-D ConvLSTM cell (reference :473).")
Conv2DLSTMCell = _make(2, _ConvLSTMCell, "Conv2DLSTMCell",
                       "2-D ConvLSTM cell (Shi et al.; reference :550).")
Conv3DLSTMCell = _make(3, _ConvLSTMCell, "Conv3DLSTMCell",
                       "3-D ConvLSTM cell (reference :627).")
Conv1DGRUCell = _make(1, _ConvGRUCell, "Conv1DGRUCell",
                      "1-D ConvGRU cell (reference :762).")
Conv2DGRUCell = _make(2, _ConvGRUCell, "Conv2DGRUCell",
                      "2-D ConvGRU cell (reference :834).")
Conv3DGRUCell = _make(3, _ConvGRUCell, "Conv3DGRUCell",
                      "3-D ConvGRU cell (reference :906).")
