"""Checkpoints of the PyTorch port.

Counterpart of the checkpoint half of ``mxtpu/model.py``: the same
``prefix-symbol.json`` + ``prefix-%04d.params`` pair, so a checkpoint
written by either package loads in the other.
"""
from __future__ import annotations

from . import ndarray as nd
from . import symbol as sym

__all__ = ["save_checkpoint", "load_params", "load_checkpoint",
           "params_from_numpy"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Save ``prefix-symbol.json`` + ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    nd.save("%s-%04d.params" % (prefix, epoch), save_dict)


def load_params(prefix, epoch, ctx=None):
    """Load a params file into ``(arg_params, aux_params)`` dicts of
    NDArrays on ``ctx`` (default: the current context)."""
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch), ctx=ctx)
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch, ctx=None):
    """``(symbol, arg_params, aux_params)`` saved by save_checkpoint."""
    symbol = sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params(prefix, epoch, ctx=ctx)
    return symbol, arg_params, aux_params


def params_from_numpy(arg_params, aux_params, ctx=None):
    """The port's ``(arg_params, aux_params)`` NDArray dicts from dicts of
    numpy arrays, such as ``{k: v.asnumpy()}`` of the dicts that
    ``mxtpu.model.load_params`` returns. Arrays keep their layout: a
    fused RNN's flat ``parameters`` blob stays in the cuDNN layout of
    ``rnn_blob_blocks``."""
    return ({k: nd.array(v, ctx=ctx) for k, v in arg_params.items()},
            {k: nd.array(v, ctx=ctx) for k, v in aux_params.items()})
