"""Symbolic graph layer of the PyTorch port.

Counterpart of ``mxtpu/symbol/__init__.py``: a Symbol is a lightweight
DAG over registered ops, written to and read from the same JSON schema,
so a graph saved by either package loads in the other. Where ``mxtpu``
traces a graph into one jitted XLA computation, the port evaluates it
eagerly, node by node (:func:`eval_graph`). Shape inference runs the
same walk on ``meta`` tensors, which carry shapes and dtypes but no
data, with the same per-op parameter-shape hints.
"""
from __future__ import annotations

import inspect
import json

import numpy as _np
import torch

from ..attribute import current as _attr_scope_current
from ..base import canonical_dtype, dtype_name
from ..ops.registry import ContribNamespace, get_op
from .. import name as _name_mgr

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "eval_graph", "contrib"]


class _Node:
    """Graph node: an op application or a free variable. A variable with
    a ``__scalar__`` attribute is a constant of that value (``mxtpu``
    writes ``sym - 1.0`` as such a node, named ``_scalar_1.0``): not an
    argument, and fed as the number itself."""

    __slots__ = ("op", "name", "inputs", "params", "num_outputs", "attrs",
                 "aux_positions", "input_names")

    def __init__(self, op, name, inputs=(), params=None, attrs=None,
                 input_names=()):
        self.op = op                    # OpDef or None for variables
        self.name = name
        self.inputs = list(inputs)      # list of (node, out_index)
        self.params = dict(params or {})
        self.attrs = dict(attrs or {})
        self.input_names = list(input_names)
        self.num_outputs = 1
        self.aux_positions = set(op.aux_update.keys()) if op else set()

    @property
    def is_variable(self):
        return self.op is None

    @property
    def is_scalar(self):
        return self.op is None and "__scalar__" in self.attrs


class Symbol:
    """An (ordered) set of outputs of a graph — same surface as
    ``mxtpu.symbol.Symbol`` for composing, listing, shape inference and
    JSON."""

    def __init__(self, outputs):
        self._outputs = list(outputs)   # list of (node, out_index)

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "group",)

    def __getitem__(self, index):
        if isinstance(index, str):
            index = self.list_outputs().index(index)
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    # -- arithmetic: broadcast ops between symbols, the _*_scalar ops with
    # a number (the reference's and mxtpu's JSON op names) ----------------
    def _binop(self, opname, scalar_op, other, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _apply_op(get_op(opname), None, [a, b], {})
        return _apply_op(get_op(scalar_op), None, [self],
                         {"scalar": float(other)})

    def __add__(self, o):
        return self._binop("broadcast_add", "_plus_scalar", o)

    def __radd__(self, o):
        return self._binop("broadcast_add", "_plus_scalar", o, True)

    def __sub__(self, o):
        return self._binop("broadcast_sub", "_minus_scalar", o)

    def __rsub__(self, o):
        return self._binop("broadcast_sub", "_rminus_scalar", o, True)

    def __mul__(self, o):
        return self._binop("broadcast_mul", "_mul_scalar", o)

    def __rmul__(self, o):
        return self._binop("broadcast_mul", "_mul_scalar", o, True)

    def __truediv__(self, o):
        return self._binop("broadcast_div", "_div_scalar", o)

    def __rtruediv__(self, o):
        return self._binop("broadcast_div", "_rdiv_scalar", o, True)

    def __pow__(self, o):
        return self._binop("broadcast_power", "_power_scalar", o)

    def __neg__(self):
        return _apply_op(get_op("negative"), None, [self], {})

    def __iter__(self):
        for i in range(len(self._outputs)):
            yield self[i]

    def get_internals(self):
        """A symbol of every output of every node of the graph, variables
        included, in ``mxtpu``'s topological order and named as
        :meth:`list_outputs` names them, so that
        ``sym.get_internals()["feat_output"]`` picks one out."""
        return Symbol([(node, i) for node in self._topo()
                       for i in range(node.num_outputs)])

    # -- graph traversal ---------------------------------------------------
    def _topo(self):
        """Nodes in depth-first post-order (inputs before the node), each
        once; iterative, so no closure cycle and no recursion limit."""
        seen, order = set(), []
        for (root, _) in self._outputs:
            if id(root) in seen:
                continue
            seen.add(id(root))
            stack = [(root, iter(root.inputs))]
            while stack:
                node, pending = stack[-1]
                for (n, _) in pending:
                    if id(n) not in seen:
                        seen.add(id(n))
                        stack.append((n, iter(n.inputs)))
                        break
                else:
                    stack.pop()
                    order.append(node)
        return order

    def _classify_vars(self):
        """Return (arg_nodes, aux_nodes) in first-visit order."""
        aux_ids, arg_ids = set(), set()
        nodes = self._topo()
        order = [n for n in nodes if n.is_variable and not n.is_scalar]
        for node in nodes:
            if node.op is None:
                continue
            for pos, (inp, _) in enumerate(node.inputs):
                if inp.is_variable:
                    if pos in node.aux_positions:
                        aux_ids.add(id(inp))
                    else:
                        arg_ids.add(id(inp))
        args, auxs = [], []
        for v in order:
            if id(v) in aux_ids and id(v) not in arg_ids:
                auxs.append(v)
            else:
                args.append(v)
        return args, auxs

    def list_arguments(self):
        return [n.name for n in self._classify_vars()[0]]

    def list_auxiliary_states(self):
        return [n.name for n in self._classify_vars()[1]]

    # -- attributes --------------------------------------------------------
    def attr(self, key):
        """Attribute ``key`` of this symbol's (first) output node."""
        return self._outputs[0][0].attrs.get(key)

    def attr_dict(self):
        """``{node name: attributes}`` over the graph (the optimizer reads
        the variables' ``__lr_mult__`` / ``__wd_mult__`` from it)."""
        return {node.name: dict(node.attrs) for node in self._topo()
                if node.attrs}

    def list_outputs(self):
        names = []
        for (node, idx) in self._outputs:
            if node.num_outputs == 1:
                names.append(node.name + "_output")
            else:
                names.append("%s_output%d" % (node.name, idx))
        return names

    # -- shape inference ---------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from the shapes of
        some arguments, given by position or name (as in ``mxtpu``)."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        known = {}
        for n, s in zip(arg_names, args):
            if s is not None:
                known[n] = tuple(s)
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})
        shapes, out_shapes = _infer_graph_shapes(self, known, partial)
        return ([shapes.get(n) for n in arg_names], out_shapes,
                [shapes.get(n) for n in self.list_auxiliary_states()])

    def infer_type(self, *args, **kwargs):
        """``(arg_types, out_types, aux_types)`` as numpy dtypes: the given
        arguments' types, float32 for every other argument, output and aux
        state (``mxtpu``'s rule)."""
        arg_names = self.list_arguments()
        dtypes = {n: canonical_dtype(t) for n, t in zip(arg_names, args)
                  if t is not None}
        dtypes.update({k: canonical_dtype(v) for k, v in kwargs.items()})
        default = _np.dtype(_np.float32)
        arg_types = [_np.dtype(dtype_name(dtypes[n])) if n in dtypes
                     else default for n in arg_names]
        return (arg_types, [default] * len(self._outputs),
                [default] * len(self.list_auxiliary_states()))

    # -- binding -----------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, **kwargs):
        """An :class:`~mxtpu_torch.executor.Executor` with zeroed argument,
        gradient and aux arrays of the shapes inferred from ``kwargs``,
        on ``ctx`` (default: the current context)."""
        from ..context import current_context
        from ..executor import Executor
        if stype_dict and any(v != "default" for v in stype_dict.values()):
            raise NotImplementedError("the port binds dense arrays only")
        return Executor._simple_bind(self, ctx or current_context(),
                                     grad_req, type_dict, kwargs)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An Executor over the given argument (and gradient, aux)
        arrays."""
        from ..executor import Executor
        return Executor._bind(self, ctx, args, args_grad, grad_req,
                              aux_states)

    # -- serialization -----------------------------------------------------
    def tojson(self):
        """Graph JSON in ``mxtpu``'s schema: params as Python literals,
        variable attributes in ``var_attrs``."""
        nodes = self._topo()
        idx = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jn = {
                "op": n.op.name if n.op else "null",
                "name": n.name,
                "attrs": {k: repr(v) for k, v in n.params.items()},
                "inputs": [[idx[id(i)], oi] for (i, oi) in n.inputs],
            }
            if n.input_names:
                jn["input_names"] = list(n.input_names)
            if n.is_variable and n.attrs:
                va = {}
                for k, v in n.attrs.items():
                    if k == "__dtype__":
                        va[k] = dtype_name(v)
                    elif k != "__init__":
                        va[k] = repr(v) if not isinstance(v, str) else v
                jn["var_attrs"] = va
            jnodes.append(jn)
        heads = [[idx[id(n)], oi] for (n, oi) in self._outputs]
        return json.dumps({"nodes": jnodes, "heads": heads,
                           "mxtpu_version": 1}, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())


# ---------------------------------------------------------------------------
# Symbol creation from ops
# ---------------------------------------------------------------------------

# Optional (default=None) fn parameters that denote *array* inputs; any
# other default-None parameter is a static param (as in mxtpu)
_OPTIONAL_ARRAY_PARAMS = {"bias", "state", "state_cell", "parameters",
                          "crop_like"}

# optional array inputs with no implicit variable: absent unless given
_OPTIONAL_NO_AUTO = {"crop_like"}

# loss heads whose implicit label variable is ``<name>_label``
_LABELLED_HEADS = ("SoftmaxOutput", "LinearRegressionOutput",
                   "LogisticRegressionOutput", "MAERegressionOutput",
                   "SVMOutput")


def _array_input_names(op, params):
    """Leading fn parameters that are array inputs; None if variadic."""
    sig = inspect.signature(op.fn)
    names = []
    for p in sig.parameters.values():
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            return None
        if p.kind == inspect.Parameter.VAR_KEYWORD:
            break
        if p.default is inspect.Parameter.empty:
            if p.name.startswith("_"):
                continue
            names.append(p.name)
        elif p.default is None and p.name in _OPTIONAL_ARRAY_PARAMS:
            names.append(p.name)
        else:
            break
    if op.name in ("FullyConnected", "Convolution", "Deconvolution"):
        # each op's own no_bias default: Deconvolution's is bias-less
        if params.get("no_bias", sig.parameters["no_bias"].default):
            names = [n for n in names if n != "bias"]
    return names


def _create_symbol(op, *args, **kwargs):
    name = kwargs.pop("name", None)
    attrs = _attr_scope_current().get(kwargs.pop("attr", None))
    sym_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
    for k in sym_kwargs:
        kwargs.pop(k)
    params = kwargs
    name = _name_mgr.current().get(name, op.name.lower().split("_")[-1]
                                   if op.name.islower() else op.name.lower())
    input_names = _array_input_names(op, params)
    inputs, used_names = [], []
    if input_names is None:
        inputs = list(args)
        used_names = ["arg%d" % i for i in range(len(inputs))]
    else:
        pos = list(args)
        for argname in input_names:
            supplied = pos.pop(0) if pos else None
            if supplied is not None and not isinstance(supplied, Symbol):
                if isinstance(supplied, (torch.Tensor, _np.ndarray)) or \
                        hasattr(supplied, "asnumpy"):
                    raise TypeError(
                        "op %s input %r must be a Symbol, got %s"
                        % (op.name, argname, type(supplied).__name__))
                if argname in params:
                    raise TypeError("op %s got multiple values for "
                                    "argument %r" % (op.name, argname))
                params[argname] = supplied
                continue
            if supplied is None and argname in params:
                continue
            if supplied is not None:
                inputs.append(supplied)
                used_names.append(argname)
            elif argname in sym_kwargs:
                inputs.append(sym_kwargs.pop(argname))
                used_names.append(argname)
            elif argname in _OPTIONAL_NO_AUTO:
                continue        # the op gets None
            elif argname == "state_cell" and \
                    params.get("mode", "lstm") != "lstm":
                continue        # only LSTM has a cell state
            else:
                # implicit weight/bias/label variables, named as in mxtpu
                if op.name in _LABELLED_HEADS and argname == "label":
                    vname = name + "_label"
                else:
                    vname = "%s_%s" % (name, argname)
                inputs.append(var(vname))
                used_names.append(argname)
        if sym_kwargs:
            raise TypeError("unexpected symbol kwargs %s for op %s"
                            % (list(sym_kwargs), op.name))
        if any(a is not None for a in pos):
            raise TypeError("op %s consumes %d array inputs (%s) but got %d "
                            "positional symbols"
                            % (op.name, len(input_names), input_names,
                               len(args)))
    return _apply_op(op, name, inputs, params, attrs, used_names)


def _apply_op(op, name, inputs, params, attrs=None, input_names=()):
    if name is None:
        name = _name_mgr.current().get(None, op.name.lower())
    in_refs = []
    for s in inputs:
        if not isinstance(s, Symbol):
            raise TypeError("op inputs must be Symbols, got %r" % (s,))
        if len(s._outputs) != 1:
            raise ValueError("cannot use grouped symbol as op input")
        in_refs.append(s._outputs[0])
    node = _Node(op, name, in_refs, params, attrs, input_names)
    node.num_outputs = _node_num_outputs(op, params)
    shown = op.user_outputs(params) if callable(op.user_outputs) \
        else op.user_outputs
    return Symbol([(node, i) for i in range(shown or node.num_outputs)])


def _node_num_outputs(op, params):
    """Output arity of an op node (one rule for _apply_op and load_json)."""
    if op.name in ("split", "SliceChannel"):
        return int(params.get("num_outputs", 2))
    if op.name == "RNN":
        return 1 if not params.get("state_outputs") else \
            (3 if params.get("mode", "lstm") == "lstm" else 2)
    if op.name == "Custom":
        from ..operator import custom_num_outputs
        return custom_num_outputs(params)
    return op.num_outputs if isinstance(op.num_outputs, int) else 1


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
        dtype=None, init=None, **kwargs):
    """Create a free variable (``sym.var``); ``lr_mult`` / ``wd_mult``
    scale the optimizer's rates for it, ``init`` (an Initializer or its
    ``dumps()``) overrides the module's initializer."""
    node = _Node(None, name)
    attr = _attr_scope_current().get(attr)
    if attr:
        node.attrs.update(attr)
    if shape is not None:
        node.attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        node.attrs["__dtype__"] = canonical_dtype(dtype)
    if lr_mult is not None:
        node.attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        node.attrs["__wd_mult__"] = wd_mult
    if init is not None:
        node.attrs["__init__"] = init if isinstance(init, str) \
            else init.dumps()
    node.attrs.update(kwargs)
    return Symbol([(node, 0)])


Variable = var


def Group(symbols):
    """One symbol whose outputs are the given symbols' outputs, in order
    (``sym.Group``): a graph with several heads."""
    return Symbol([out for s in symbols for out in s._outputs])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def _literal(text):
    """Parse a Python literal written by ``repr`` (params, var attrs)."""
    return eval(text, {"__builtins__": {}}, {})  # noqa: S307


def load_json(json_str):
    d = json.loads(json_str)
    nodes = []
    for jn in d["nodes"]:
        if jn["op"] == "null":
            node = _Node(None, jn["name"])
            for k, v in jn.get("var_attrs", {}).items():
                if k == "__dtype__":
                    node.attrs[k] = canonical_dtype(v)
                elif k == "__stype__":
                    node.attrs[k] = v
                elif isinstance(v, str) and k.startswith("__"):
                    node.attrs[k] = _literal(v)
                else:
                    node.attrs[k] = v
        else:
            op = get_op(jn["op"])
            if op is None:
                raise ValueError("unknown op %r in symbol json" % jn["op"])
            params = {k: _literal(v) for k, v in jn.get("attrs", {}).items()}
            node = _Node(op, jn["name"], params=params,
                         input_names=jn.get("input_names", ()))
        nodes.append(node)
    for node, jn in zip(nodes, d["nodes"]):
        node.inputs = [(nodes[i], oi) for (i, oi) in jn["inputs"]]
        if node.op:
            node.num_outputs = _node_num_outputs(node.op, node.params)
    return Symbol([(nodes[i], oi) for (i, oi) in d["heads"]])


# ---------------------------------------------------------------------------
# Graph evaluation (serving programs and shape inference)
# ---------------------------------------------------------------------------

def _build_consumer_map(nodes):
    consumers = {}
    for n in nodes:
        for (inp, _oi) in n.inputs:
            consumers.setdefault(id(inp), []).append(n)
    return consumers


def _creation_batch(node, consumers, get_input_shape, fallback_shapes):
    """Resolve the MXNet 'unknown batch' (dim 0 in a _zeros shape),
    by ``mxtpu``'s rule: an RNN consumer pins it to its (T, N, C) data's
    N; otherwise the leading dim of a variable named 'data'/'*_data',
    else of the first known variable shape."""
    for c in consumers.get(id(node), ()):
        if c.op is not None and c.op.name == "RNN" and c.inputs:
            s = get_input_shape(c.inputs[0])
            if s is not None and len(s) >= 2:
                return s[1]
    for name, s in fallback_shapes.items():
        if (name == "data" or name.endswith("_data")) and len(s) > 0:
            return s[0]
    return next((s[0] for s in fallback_shapes.values() if len(s) > 0),
                None)


def _resolve_creation_shape(node, params, consumers, get_input_shape,
                            fallback_shapes):
    if node.op.name == "_zeros" and 0 in tuple(params.get("shape", ())):
        batch = _creation_batch(node, consumers, get_input_shape,
                                fallback_shapes)
        if batch:
            params["shape"] = tuple(batch if d == 0 else d
                                    for d in params["shape"])


class _GraphEval:
    """One evaluation of a graph: the node values computed so far (each
    node once, on first use, depth first) and the aux states' updates.
    A class and not nested closures: a recursive closure refers to itself
    through its cell, and that cycle would keep every activation of the
    step alive until Python's cycle collector ran."""

    def __init__(self, nodes, feed, training, device):
        self.feed, self.training, self.device = feed, training, device
        self.cache = {}
        self.aux_updates = {}
        self.consumers = _build_consumer_map(nodes)
        self.fallback = {k: tuple(v.shape) for k, v in feed.items()
                         if v.dim() > 0}

    def in_shape(self, ref):
        n2, oi2 = ref
        return tuple(self.node(n2)[oi2].shape) or None

    def node(self, node):
        key = id(node)
        if key in self.cache:
            return self.cache[key]
        if node.is_scalar:
            vals = (node.attrs["__scalar__"],)
        elif node.is_variable:
            if node.name not in self.feed:
                raise KeyError("no value bound for variable %r" % node.name)
            vals = (self.feed[node.name],)
        else:
            in_vals = [self.node(inp)[oi] for (inp, oi) in node.inputs]
            params = dict(node.params)
            if node.op.needs_train_flag:
                params["_training"] = self.training
            if node.op.needs_device:
                params["_device"] = self.device
            _resolve_creation_shape(node, params, self.consumers,
                                    self.in_shape, self.fallback)
            out = node.op.fn(*in_vals, **params)
            vals = out if isinstance(out, tuple) else (out,)
            for in_pos, out_idx in node.op.aux_update.items():
                if in_pos < len(node.inputs):
                    src, _ = node.inputs[in_pos]
                    if src.is_variable:
                        self.aux_updates[src.name] = vals[out_idx]
        self.cache[key] = vals
        return vals


def eval_graph(sym_outputs, feed, training=False, device=None):
    """Evaluate graph outputs given ``{var_name: tensor}``.

    Returns ``(outputs, aux_updates)`` as ``mxtpu.symbol.eval_graph``
    does. ``device`` is where nullary creation ops (``_zeros``) put their
    tensors; by default the device of the fed tensors.
    """
    if device is None:
        device = next((v.device for v in feed.values()
                       if isinstance(v, torch.Tensor)), torch.device("cpu"))
    run = _GraphEval(Symbol(list(sym_outputs))._topo(), feed, training,
                     device)
    outputs = [run.node(n)[oi] for (n, oi) in sym_outputs]
    return outputs, run.aux_updates


# ---------------------------------------------------------------------------
# Shape inference: a forward walk on meta tensors, with per-op hints that
# fill in parameter shapes from the data shape.
# ---------------------------------------------------------------------------

_SHAPE_HINTS = {}


def shape_hint(opname):
    def deco(fn):
        _SHAPE_HINTS[opname] = fn
        return fn
    return deco


@shape_hint("FullyConnected")
def _fc_hint(params, in_shapes, input_names):
    data = in_shapes.get("data")
    if data is None:
        return {}
    nh = int(params.get("num_hidden", 0))
    if params.get("flatten", True):
        d = 1
        for s in data[1:]:
            d *= s
    else:
        d = data[-1]
    out = {"weight": (nh, d)}
    if "bias" in input_names:
        out["bias"] = (nh,)
    return out


@shape_hint("Convolution")
def _conv_hint(params, in_shapes, input_names):
    data = in_shapes.get("data")
    if data is None:
        return {}
    nf = int(params.get("num_filter", 0))
    ng = int(params.get("num_group", 1))
    out = {"weight": (nf, data[1] // ng) + tuple(params.get("kernel", ()))}
    if "bias" in input_names:
        out["bias"] = (nf,)
    return out


@shape_hint("Deconvolution")
def _deconv_hint(params, in_shapes, input_names):
    data = in_shapes.get("data")
    if data is None:
        return {}
    nf = int(params.get("num_filter", 0))
    ng = int(params.get("num_group", 1))
    out = {"weight": (data[1], nf // ng) + tuple(params.get("kernel", ()))}
    if "bias" in input_names:
        out["bias"] = (nf,)
    return out


@shape_hint("LayerNorm")
def _ln_hint(params, in_shapes, input_names):
    data = in_shapes.get("data")
    if data is None:
        return {}
    c = (data[int(params.get("axis", -1)) % len(data)],)
    return {"gamma": c, "beta": c}


@shape_hint("InstanceNorm")
def _in_hint(params, in_shapes, input_names):
    data = in_shapes.get("data")
    if data is None:
        return {}
    return {"gamma": (data[1],), "beta": (data[1],)}


@shape_hint("Embedding")
def _emb_hint(params, in_shapes, input_names):
    return {"weight": (int(params["input_dim"]), int(params["output_dim"]))}


@shape_hint("SoftmaxOutput")
@shape_hint("SVMOutput")
def _label_hint(params, in_shapes, input_names):
    data = in_shapes.get("data")
    if data is None:
        return {}
    if params.get("multi_output"):
        return {"label": (data[0],) + tuple(data[2:])}
    return {"label": (data[0],)}


@shape_hint("LinearRegressionOutput")
@shape_hint("LogisticRegressionOutput")
@shape_hint("MAERegressionOutput")
def _reg_label_hint(params, in_shapes, input_names):
    data = in_shapes.get("data")
    return {"label": data} if data else {}


@shape_hint("BatchNorm")
def _bn_hint(params, in_shapes, input_names):
    data = in_shapes.get("data")
    if data is None:
        return {}
    c = (data[int(params.get("axis", 1)) % len(data)],)
    return {"gamma": c, "beta": c, "moving_mean": c, "moving_var": c}


@shape_hint("Custom")
def _custom_hint(params, in_shapes, input_names):
    """The shapes the prop's ``infer_shape`` gives the inputs not yet
    known (a label such as ``softmax_label``), from those known."""
    from ..operator import custom_arg_shapes
    known = [in_shapes.get(n) for n in input_names]
    if known[0] is None:
        return {}
    return {n: s for n, k, s in zip(input_names, known,
                                    custom_arg_shapes(params, known))
            if k is None and s is not None}


@shape_hint("RNN")
def _rnn_hint(params, in_shapes, input_names):
    from ..ops.rnn import rnn_param_size
    data = in_shapes.get("data")
    if data is None:
        return {}
    state_size = int(params.get("state_size", 0))
    num_layers = int(params.get("num_layers", 1))
    bidir = bool(params.get("bidirectional", False))
    dirs = 2 if bidir else 1
    psize = rnn_param_size(params.get("mode", "lstm"), data[2], state_size,
                           num_layers, bidir)
    out = {"parameters": (psize,),
           "state": (num_layers * dirs, data[1], state_size)}
    if "state_cell" in input_names:
        out["state_cell"] = (num_layers * dirs, data[1], state_size)
    return out


def _infer_graph_shapes(sym, known, partial=False):
    """Fill variable shapes via hints, then run each node on meta
    tensors. Returns ``(var_shapes, out_shapes)``."""
    meta = torch.device("meta")
    shapes = dict(known)
    nodes = sym._topo()
    consumer_map = _build_consumer_map(nodes)
    for n in nodes:   # declared shapes; a 0 dim means "unknown"
        if n.is_variable and "__shape__" in n.attrs and n.name not in shapes:
            s = tuple(n.attrs["__shape__"])
            if all(d > 0 for d in s):
                shapes[n.name] = s
    outs = {}         # id(node) -> tuple of meta tensors

    def value(ref):
        inp, oi = ref
        if inp.is_scalar:
            return inp.attrs["__scalar__"]
        if inp.is_variable:
            if inp.name not in shapes:
                return None
            dt = canonical_dtype(inp.attrs.get("__dtype__"))
            return torch.empty(shapes[inp.name], dtype=dt, device=meta)
        got = outs.get(id(inp))
        return None if got is None else got[oi]

    def in_shape(ref):
        v = value(ref)
        return None if v is None else tuple(getattr(v, "shape", ()))

    for node in nodes:
        if node.is_variable:
            continue
        hint = _SHAPE_HINTS.get(node.op.name)
        if hint is not None:
            ism = {}
            for pos, ref in enumerate(node.inputs):
                s = in_shape(ref)
                if s is not None and pos < len(node.input_names):
                    ism[node.input_names[pos]] = s
            filled = hint(node.params, ism, node.input_names)
            for pos, (inp, _oi) in enumerate(node.inputs):
                argname = node.input_names[pos] \
                    if pos < len(node.input_names) else None
                if inp.is_variable and argname in filled \
                        and inp.name not in shapes:
                    shapes[inp.name] = tuple(filled[argname])
        in_vals = [value(ref) for ref in node.inputs]
        if any(v is None for v in in_vals):
            if partial:
                continue
            raise ValueError("cannot infer shapes for node %r: missing "
                             "input shapes" % node.name)
        params = dict(node.params)
        if node.op.needs_train_flag:
            params["_training"] = False
        if node.op.needs_device:
            params["_device"] = meta
        _resolve_creation_shape(node, params, consumer_map, in_shape, known)
        r = node.op.fn(*in_vals, **params)
        outs[id(node)] = r if isinstance(r, tuple) else (r,)

    out_shapes = []
    for ref in sym._outputs:
        s = in_shape(ref)
        out_shapes.append(s)
    return shapes, out_shapes


def _op_function(op, name):
    """``sym.<name>``: a symbol of op ``op`` over its arguments."""
    def fn(*args, **kwargs):
        return _create_symbol(op, *args, **kwargs)
    fn.__name__ = name
    fn.__doc__ = op.doc
    return fn


contrib = ContribNamespace(_op_function)


def __getattr__(name):
    op = get_op(name)
    if op is None:
        raise AttributeError("module 'mxtpu_torch.symbol' has no attribute "
                             "%r" % name)
    return _op_function(op, name)
