"""Symbolic RNN cells of the PyTorch port.

Counterpart of ``mxtpu/rnn/rnn_cell.py``, reduced to the fused cell:
:class:`FusedRNNCell` unrolls into one ``RNN`` op node, with the same
node names, params and begin states as ``mxtpu``'s, so the graphs the
two packages build serialize to the same JSON. The unfused cells wait
for a later slice.
"""
from __future__ import annotations

import numpy as _np

from .. import symbol
from ..symbol import Symbol

__all__ = ["RNNParams", "BaseRNNCell", "FusedRNNCell"]


class RNNParams:
    """Container for shared cell parameters (``mxtpu`` RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.var(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Base of the symbolic cells: parameters and begin states."""

    def __init__(self, prefix="", params=None):
        self._prefix = prefix
        self._params = RNNParams(prefix) if params is None else params
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    @property
    def state_info(self):
        raise NotImplementedError()

    def begin_state(self):
        """Initial states as ``_zeros`` symbols whose batch dim is 0
        ("unknown", resolved at evaluation), named as in ``mxtpu``."""
        states = []
        for info in self.state_info:
            self._init_counter += 1
            shape = tuple(0 if s is None else s for s in info["shape"])
            states.append(symbol._zeros(
                shape=shape, name="%sbegin_state_%d"
                % (self._prefix, self._init_counter)))
        return states


def _normalize_sequence(length, inputs, layout):
    axis = layout.find("T")
    if isinstance(inputs, Symbol):
        if len(inputs.list_outputs()) == 1:
            inputs = symbol.split(inputs, axis=axis, num_outputs=length,
                                  squeeze_axis=True)
            inputs = [inputs[i] for i in range(length)]
        else:
            inputs = list(inputs)
    if len(inputs) != length:
        raise ValueError("unroll(%d) got %d inputs" % (length, len(inputs)))
    return inputs


class FusedRNNCell(BaseRNNCell):
    """Multi-layer RNN over the fused ``RNN`` op (``mxtpu`` FusedRNNCell).
    Its one parameter, ``<prefix>parameters``, is the flat blob in the
    cuDNN layout of :func:`~mxtpu_torch.ops.rnn.rnn_blob_blocks`."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._parameter = self._params.get("parameters")
        self._directions = 2 if bidirectional else 1

    @property
    def state_info(self):
        n = (self._mode == "lstm") + 1
        return [{"shape": (self._directions * self._num_layers, 0,
                           self._num_hidden), "__layout__": "LNC"}
                for _ in range(n)]

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "FusedRNNCell cannot be stepped; call unroll()")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs = _normalize_sequence(length, inputs, layout)
        stacked = symbol.stack(*inputs, axis=0)   # time-major (T, N, C)
        if begin_state is None:
            begin_state = self.begin_state()
        args = dict(mode=self._mode, state_size=self._num_hidden,
                    num_layers=self._num_layers,
                    bidirectional=self._bidirectional, p=self._dropout,
                    state_outputs=True)
        if self._mode == "lstm":
            rnn = symbol.RNN(stacked, self._parameter, begin_state[0],
                             begin_state[1], name="%srnn" % self._prefix,
                             **args)
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            rnn = symbol.RNN(stacked, self._parameter, begin_state[0],
                             name="%srnn" % self._prefix, **args)
            outputs, states = rnn[0], [rnn[1]]
        states = states if self._get_next_state else []
        if merge_outputs:
            if layout.find("T") == 1:
                outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
            return outputs, states
        steps = symbol.split(outputs, axis=0, num_outputs=length,
                             squeeze_axis=True)
        return [steps[i] for i in range(length)], states

    @property
    def _fused_gate_names(self):
        return {"lstm": ("_i", "_f", "_c", "_o"),
                "gru": ("_r", "_z", "_o"),
                "rnn_relu": ("",), "rnn_tanh": ("",)}[self._mode]

    def _blob_slices(self, blob_size):
        """Per-gate ``(arg_name, start, shape)`` slices of the flat blob,
        named as ``mxtpu``'s unfused stack names its parameters."""
        from ..ops.rnn import rnn_blob_blocks
        G = len(self._fused_gate_names)
        H = self._num_hidden
        D = self._directions
        per_gate = blob_size // D // H // G
        isz = per_gate - (self._num_layers - 1) * (H + D * H + 2) - H - 2
        blocks, total = rnn_blob_blocks(self._mode, isz, H,
                                        self._num_layers, D)
        if total != blob_size:
            raise ValueError("blob of %d values does not fit this cell "
                             "(%d for input size %d)"
                             % (blob_size, total, isz))
        slices = []
        for b in blocks:
            cp = "%s%s%d_" % (self._prefix, "lr"[b["dir"]], b["layer"])
            for group, key in (("i2h", "wi"), ("h2h", "wh")):
                start, (_gh, cols) = b[key]
                for j, g in enumerate(self._fused_gate_names):
                    slices.append(("%s%s%s_weight" % (cp, group, g),
                                   start + j * H * cols, (H, cols)))
            for group, key in (("i2h", "bi"), ("h2h", "bh")):
                start, _ = b[key]
                for j, g in enumerate(self._fused_gate_names):
                    slices.append(("%s%s%s_bias" % (cp, group, g),
                                   start + j * H, (H,)))
        return slices

    def unpack_weights(self, args):
        """Slice the flat ``<prefix>parameters`` blob into per-gate
        arrays (``mxtpu`` FusedRNNCell.unpack_weights)."""
        from .. import ndarray as nd
        args = dict(args)
        blob = args.pop(self._parameter.name)
        arr = blob.asnumpy() if hasattr(blob, "asnumpy") \
            else _np.asarray(blob)
        ctx = getattr(blob, "context", None)
        for name, start, shape in self._blob_slices(arr.size):
            n = int(_np.prod(shape))
            args[name] = nd.array(arr[start:start + n].reshape(shape),
                                  ctx=ctx, dtype=arr.dtype)
        return args

    def pack_weights(self, args):
        """Inverse of :meth:`unpack_weights`."""
        from .. import ndarray as nd
        from ..ops.rnn import rnn_param_size
        args = dict(args)
        if self._parameter.name in args:
            return args
        first = "%sl0_i2h%s_weight" % (self._prefix,
                                       self._fused_gate_names[0])
        if first not in args:
            raise KeyError("pack_weights: neither %r nor %r is present"
                           % (self._parameter.name, first))
        ctx = getattr(args[first], "context", None)
        host = {k: (v.asnumpy() if hasattr(v, "asnumpy") else _np.asarray(v))
                for k, v in args.items()}
        size = rnn_param_size(self._mode, host[first].shape[1],
                              self._num_hidden, self._num_layers,
                              self._bidirectional)
        out = _np.zeros((size,), host[first].dtype)
        for name, start, shape in self._blob_slices(size):
            n = int(_np.prod(shape))
            out[start:start + n] = host[name].reshape(-1)
            args.pop(name)
        args[self._parameter.name] = nd.array(out, ctx=ctx, dtype=out.dtype)
        return args
