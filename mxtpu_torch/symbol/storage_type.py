"""Storage-type inference over the symbolic graph.

Capability parity with the reference's InferStorageType attribute pass
(``src/executor/infer_graph_attr_pass.cc``, ``exec_pass.h:151-179``):
given the storage types of graph inputs (declared on variables via
``sym.var(stype=...)`` or passed to ``infer_storage_type``), propagate a
storage type ("default" | "csr" | "row_sparse") to every node output,
using per-op rules with a *dense fallback* — any op without a sparse rule
produces "default" outputs, the exact analogue of the reference's
FComputeFallback densification.

The port's counterpart of ``mxtpu/symbol/storage_type.py``, rule for
rule. The pass decides which bound arguments and gradients are CSR or
row-sparse arrays (so that the sparse paths engage: ``dot`` on the
compressed CSR tensors, the lazy optimizer updates, ``row_sparse_pull``).
At run time a CSR tensor reaching an op without a CSR path becomes its
dense value (``ops.registry.storage_fallback``).
"""
from __future__ import annotations

__all__ = ["infer_graph_storage_types", "STYPES", "register_storage_rule"]

STYPES = ("default", "csr", "row_sparse")

# op name -> fn(in_stypes: list[str], params: dict) -> str (output stype)
_RULES = {}


def register_storage_rule(*op_names):
    def deco(fn):
        for n in op_names:
            _RULES[n] = fn
        return fn
    return deco


@register_storage_rule("dot")
def _dot_rule(in_stypes, params):
    """Reference sparse dot rules (src/operator/tensor/dot-inl.h):
    dot(csr, dense) -> dense; dot(csr.T, dense) -> row_sparse;
    anything else falls back to dense."""
    lhs = in_stypes[0] if in_stypes else "default"
    if lhs == "csr" and params.get("transpose_a"):
        return "row_sparse"
    return "default"


@register_storage_rule("broadcast_add", "broadcast_sub", "elemwise_add",
                       "elemwise_sub", "add_n")
def _addlike_rule(in_stypes, params):
    """Same-stype addition preserves storage (rsp+rsp -> rsp, csr+csr ->
    csr: the union of stored rows/elements is still sparse)."""
    kinds = set(in_stypes)
    if kinds == {"row_sparse"}:
        return "row_sparse"
    if kinds == {"csr"}:
        return "csr"
    return "default"


@register_storage_rule("broadcast_mul", "broadcast_div", "elemwise_mul",
                       "elemwise_div")
def _mullike_rule(in_stypes, params):
    """Multiplication by a sparse operand keeps its zero structure:
    rsp * anything-dense stays rsp (reference elemwise_mul rsp rules)."""
    if in_stypes and in_stypes[0] == "row_sparse" and \
            all(s in ("default", "row_sparse") for s in in_stypes):
        return "row_sparse"
    return "default"


# zero-preserving unary ops keep the input's storage type
_ZERO_PRESERVING = ("negative", "abs", "sign", "square", "sqrt", "cbrt",
                    "relu", "trunc", "ceil", "floor", "rint", "round",
                    "sin", "tan", "arcsin", "arctan", "sinh", "tanh",
                    "expm1", "log1p")


@register_storage_rule(*_ZERO_PRESERVING)
def _unary_rule(in_stypes, params):
    return in_stypes[0] if in_stypes else "default"


@register_storage_rule("cast_storage")
def _cast_rule(in_stypes, params):
    return params.get("stype", "default")


@register_storage_rule("_sparse_retain", "retain")
def _retain_rule(in_stypes, params):
    return "row_sparse"


def infer_graph_storage_types(symbol, known):
    """Propagate storage types through ``symbol``'s graph.

    Parameters
    ----------
    symbol : Symbol
    known : dict name -> stype for input variables (overrides the
        ``__stype__`` attribute declared on the variable).

    Returns
    -------
    (var_stypes, out_stypes) : dict name -> stype for every variable, and
        the stype of each symbol output.
    """
    for name, st in known.items():
        if st not in STYPES:
            raise ValueError("unknown storage type %r for %r" % (st, name))
    node_stype = {}   # id(node) -> stype of its outputs
    var_stypes = {}
    for node in symbol._topo():
        if node.op is None:  # variable
            st = known.get(node.name,
                           node.attrs.get("__stype__", "default"))
            node_stype[id(node)] = st
            var_stypes[node.name] = st
            continue
        in_stypes = [node_stype.get(id(src), "default")
                     for (src, _oi) in node.inputs]
        rule = _RULES.get(node.op.name)
        if rule is None:
            # dense fallback: the reference densifies inputs and runs the
            # default FCompute; dense-backed arrays make this free here
            st = "default"
        else:
            st = rule(in_stypes, node.params)
        node_stype[id(node)] = st
    out_stypes = [node_stype.get(id(n), "default")
                  for (n, _oi) in symbol._outputs]
    return var_stypes, out_stypes
