"""Gluon fused RNN layers of the PyTorch port.

Counterpart of ``mxtpu/gluon/rnn/rnn_layer.py``: RNN/LSTM/GRU layers over
the port's fused RNN op (``ops/rnn.py``), whose LSTM and GRU time loops
launch the hand-written kernels ``lstm_scan`` / ``gru_scan`` on the card
(one launch a layer and direction a forward). Per-layer weights are
separate Parameters, as in ``mxtpu``, packed into the flat cuDNN-layout
vector at each forward. The layers run eagerly, hybridized or not, as in
``mxtpu``; their states start on the inputs' context.
"""
from __future__ import annotations

from ..block import HybridBlock
from ... import ndarray as nd

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), "Invalid layout %s" % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4,
                       "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                self._register_param(
                    "%s%d_i2h_weight" % (j, i), (ng * nh, ni),
                    i2h_weight_initializer)
                self._register_param(
                    "%s%d_h2h_weight" % (j, i), (ng * nh, nh),
                    h2h_weight_initializer)
                self._register_param(
                    "%s%d_i2h_bias" % (j, i), (ng * nh,),
                    i2h_bias_initializer)
                self._register_param(
                    "%s%d_h2h_bias" % (j, i), (ng * nh,),
                    h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)
        return p

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        func = func or nd.zeros
        states = []
        for info in self.state_info(batch_size):
            info = dict(info)
            shape = info.pop("shape")
            states.append(func(shape=shape, **kwargs))
        return states

    def _collect_flat_params(self):
        arrays = []
        for i in range(self._num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                arrays.append(getattr(
                    self, "%s%d_i2h_weight" % (j, i)).data().reshape(-1))
                arrays.append(getattr(
                    self, "%s%d_h2h_weight" % (j, i)).data().reshape(-1))
        for i in range(self._num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                arrays.append(getattr(self, "%s%d_i2h_bias" % (j, i)).data())
                arrays.append(getattr(self, "%s%d_h2h_bias" % (j, i)).data())
        return nd.concat(*arrays, dim=0)

    def forward(self, inputs, states=None):
        from ..parameter import DeferredInitializationError
        batch_size = inputs.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context,
                                      dtype=inputs.dtype)
        if isinstance(states, nd.NDArray):
            states = [states]
        try:
            out = self._forward_kernel(inputs, states)
        except DeferredInitializationError:
            self._infer_param_shapes(inputs)
            out = self._forward_kernel(inputs, states)
        return out[0] if skip_states else out

    def _infer_param_shapes(self, inputs):
        isz = inputs.shape[self._layout.find("C")]
        ng, nh = self._gates, self._hidden_size
        ni = isz
        for i in range(self._num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                getattr(self, "%s%d_i2h_weight" % (j, i)).shape = \
                    (ng * nh, ni)
            ni = nh * self._dir
        for p in self.collect_params().values():
            p._finish_deferred_init()

    def _forward_kernel(self, inputs, states):
        if self._layout == "NTC":
            inputs = nd.swapaxes(inputs, 0, 1)
        params = self._collect_flat_params()
        if self._mode == "lstm":
            outputs = nd.RNN(inputs, params, states[0], states[1],
                             state_size=self._hidden_size,
                             num_layers=self._num_layers,
                             bidirectional=self._dir == 2,
                             p=self._dropout, state_outputs=True,
                             mode=self._mode)
            out, h, c = outputs
            new_states = [h, c]
        else:
            outputs = nd.RNN(inputs, params, states[0],
                             state_size=self._hidden_size,
                             num_layers=self._num_layers,
                             bidirectional=self._dir == 2,
                             p=self._dropout, state_outputs=True,
                             mode=self._mode)
            out, h = outputs
            new_states = [h]
        if self._layout == "NTC":
            out = nd.swapaxes(out, 0, 1)
        return out, new_states

    def __repr__(self):
        return "%s(%s, %s layers, hidden=%s)" % (
            self.__class__.__name__, self._mode, self._num_layers,
            self._hidden_size)


class RNN(_RNNLayer):
    """Multi-layer Elman RNN (reference rnn_layer.py:310)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference rnn_layer.py:389)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU (reference rnn_layer.py:478)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
