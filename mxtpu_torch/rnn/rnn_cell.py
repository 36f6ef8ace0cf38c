"""Symbolic RNN cells of the PyTorch port.

Counterpart of ``mxtpu/rnn/rnn_cell.py``: ``BaseRNNCell`` (``__call__``
a step, ``unroll``, ``begin_state``, the per-gate ``unpack_weights`` /
``pack_weights``), parameter sharing through ``RNNParams``, and the
cells RNNCell, LSTMCell, GRUCell, FusedRNNCell, SequentialRNNCell,
BidirectionalCell, DropoutCell, and the modifiers ZoneoutCell and
ResidualCell. They build the same nodes, with the same names, params
and begin states, as ``mxtpu``'s, so the graphs the two packages build
serialize to the same JSON (the one exception is a Python number in the
arithmetic, such as GRUCell's ``1.0 - update``: the port writes a
``_rminus_scalar`` node, ``mxtpu`` a ``_scalar_`` variable).

:class:`FusedRNNCell` unrolls into one ``RNN`` op node, whose LSTM and
GRU time loops run the hand-written kernels on the card; the unfused
cells unroll into ``FullyConnected`` and elementwise nodes, plain
PyTorch on either device, as ``mxtpu`` computes them outside Pallas.
"""
from __future__ import annotations

import numpy as _np

from .. import symbol
from ..symbol import Symbol

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "ModifierCell", "DropoutCell", "ZoneoutCell", "ResidualCell"]


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
    """Base of the symbolic cells: parameters, begin states, a step
    (``__call__``) and ``unroll``."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, **kwargs):
        """Initial states, named ``<prefix>begin_state_<i>``: by default
        ``_zeros`` symbols whose unknown (None or 0) batch dim is resolved
        at evaluation; else ``func(name=..., shape=..., **kwargs)``."""
        if self._modified:
            raise RuntimeError("After applying modifier cells the base "
                               "cell cannot be called")
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            if info is None:
                state = symbol._zeros(name=name, **kwargs) if func is None \
                    else func(name=name, **kwargs)
            elif func is None:
                state = symbol._zeros(
                    shape=tuple(0 if s is None else s
                                for s in info["shape"]), name=name)
            else:
                info = dict(info)
                state = func(name=name, shape=info.pop("shape", ()),
                             **kwargs)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Split each ``<prefix>{i2h,h2h}_weight`` / ``_bias`` into one
        array a gate, named ``<prefix>{i2h,h2h}<gate>_weight``."""
        args = dict(args)
        for group in ("i2h", "h2h"):
            weight = args.pop("%s%s_weight" % (self._prefix, group), None)
            bias = args.pop("%s%s_bias" % (self._prefix, group), None)
            if weight is None:
                continue
            gates = self._gate_names
            if not gates:
                args["%s%s_weight" % (self._prefix, group)] = weight
                if bias is not None:
                    args["%s%s_bias" % (self._prefix, group)] = bias
                continue
            h = weight.shape[0] // len(gates)
            for j, g in enumerate(gates):
                args["%s%s%s_weight" % (self._prefix, group, g)] = \
                    weight[j * h:(j + 1) * h]
                if bias is not None:
                    args["%s%s%s_bias" % (self._prefix, group, g)] = \
                        bias[j * h:(j + 1) * h]
        return args

    def pack_weights(self, args):
        """Inverse of :meth:`unpack_weights`."""
        from .. import ndarray as nd
        args = dict(args)
        gates = self._gate_names
        if not gates:
            return args
        for group in ("i2h", "h2h"):
            keys = ["%s%s%s_weight" % (self._prefix, group, g)
                    for g in gates]
            if any(k not in args for k in keys):
                continue
            ws = [args.pop(k) for k in keys]
            bs = [args.pop(k) for k in
                  ("%s%s%s_bias" % (self._prefix, group, g) for g in gates)
                  if k in args]
            args["%s%s_weight" % (self._prefix, group)] = nd.concatenate(
                ws, axis=0)
            if bs:
                args["%s%s_bias" % (self._prefix, group)] = nd.concatenate(
                    bs, axis=0)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """The cell applied ``length`` times: (outputs, final states)."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _format_sequence(length, outputs, layout, merge_outputs)
        return outputs, states


def _normalize_sequence(length, inputs, layout, merge):
    """``inputs`` as a list of ``length`` step symbols (a single-output
    symbol is split along the layout's T axis)."""
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
    return inputs, axis


def _format_sequence(length, outputs, layout, merge):
    """The step outputs, or with ``merge`` one symbol joined along the
    layout's T axis."""
    axis = layout.find("T")
    if merge:
        outputs = [symbol.expand_dims(o, axis=axis) for o in outputs]
        return symbol.Concat(*outputs, dim=axis), axis
    return outputs, axis


class RNNCell(BaseRNNCell):
    """Vanilla tanh/relu RNN cell (``mxtpu`` RNNCell)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = symbol.Activation(i2h + h2h, act_type=self._activation,
                                   name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (``mxtpu`` LSTMCell; gate order i, f, c, o)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%sh2h" % name)
        gates = i2h + h2h
        sliced = symbol.SliceChannel(gates, num_outputs=4,
                                     name="%sslice" % name)
        in_gate = symbol.Activation(sliced[0], act_type="sigmoid")
        forget_gate = symbol.Activation(sliced[1], act_type="sigmoid")
        in_transform = symbol.Activation(sliced[2], act_type="tanh")
        out_gate = symbol.Activation(sliced[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (``mxtpu`` GRUCell; gate order r, z, o)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(prev_h, self._hW, self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%sh2h" % name)
        i2h_s = symbol.SliceChannel(i2h, num_outputs=3)
        h2h_s = symbol.SliceChannel(h2h, num_outputs=3)
        reset = symbol.Activation(i2h_s[0] + h2h_s[0], act_type="sigmoid")
        update = symbol.Activation(i2h_s[1] + h2h_s[1], act_type="sigmoid")
        next_h_tmp = symbol.Activation(i2h_s[2] + reset * h2h_s[2],
                                       act_type="tanh")
        next_h = (1.0 - update) * next_h_tmp + update * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Multi-layer RNN over the fused ``RNN`` op (``mxtpu`` FusedRNNCell).
    Its one parameter, ``<prefix>parameters``, is the flat blob in the
    cuDNN layout of :func:`~mxtpu_torch.ops.rnn.rnn_blob_blocks`,
    initialized by :class:`~mxtpu_torch.initializer.FusedRNN` (the
    forget gate's bias at ``forget_bias``) whatever the module's
    initializer."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        from .. import initializer as _init
        self._parameter = self.params.get(
            "parameters",
            init=_init.FusedRNN(None, num_hidden, num_layers, mode,
                                bidirectional, forget_bias))
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
        inputs, _ = _normalize_sequence(length, inputs, layout, None)
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
        """Slice the flat ``<prefix>parameters`` blob into the per-gate
        arrays of the equivalent :meth:`unfuse` stack (``mxtpu``
        FusedRNNCell.unpack_weights)."""
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

    def unfuse(self):
        """The equivalent stack of unfused cells (``mxtpu`` unfuse), whose
        parameters :meth:`unpack_weights` and the stack's
        ``pack_weights`` fill from the blob."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_"
                                      % (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Cells applied in sequence (``mxtpu`` SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []
        self._override_cell_params = params is not None

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            state = states[p: p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if begin_state is None:
            begin_state = self.begin_state()
        p = 0
        states = begin_state
        next_states = []
        num_cells = len(self._cells)
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            state = states[p: p + n]
            p += n
            inputs, state = cell.unroll(
                length, inputs=inputs, begin_state=state, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(state)
        return inputs, next_states


class BidirectionalCell(BaseRNNCell):
    """A forward and a backward cell over the sequence, their outputs
    joined a step (``mxtpu`` BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._cells = [l_cell, r_cell]
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped; call unroll()")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout=layout, merge_outputs=None)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n_l:], layout=layout,
            merge_outputs=None)
        outputs = [symbol.Concat(l_o, r_o, dim=1,
                                 name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in
                   enumerate(zip(l_outputs, reversed(r_outputs)))]
        if merge_outputs:
            outputs, _ = _format_sequence(length, outputs, layout, True)
        return outputs, l_states + r_states


class ModifierCell(BaseRNNCell):
    """Base of the cells that wrap another cell (``mxtpu``
    ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, **kwargs):
        if self._modified:
            raise RuntimeError("After applying modifier cells the base "
                               "cell cannot be called")
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class DropoutCell(BaseRNNCell):
    """Dropout on the outputs between layers (``mxtpu`` DropoutCell)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(inputs, p=self.dropout)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout (``mxtpu`` ZoneoutCell): each output and state element
    keeps its previous value with the given probability."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        if isinstance(base_cell, FusedRNNCell):
            raise TypeError("FusedRNNCell does not support zoneout")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(symbol.ones_like(like), p=p)
        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(next_output)
        if self.zoneout_outputs > 0:
            output = symbol.where(mask(self.zoneout_outputs, next_output),
                                  next_output, prev_output)
        else:
            output = next_output
        if self.zoneout_states > 0:
            states = [symbol.where(mask(self.zoneout_states, ns), ns, s)
                      for ns, s in zip(next_states, states)]
        else:
            states = next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Adds the input to the cell's output (``mxtpu`` ResidualCell)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.elemwise_add(output, inputs)
        return output, states
