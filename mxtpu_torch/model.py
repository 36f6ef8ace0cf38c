"""Checkpoints and the kvstore training glue of the PyTorch port.

Counterpart of ``mxtpu/model.py``: ``BatchEndParam``, the same
``prefix-symbol.json`` + ``prefix-%04d.params`` pair (a checkpoint
written by either package loads in the other), and the helpers that
``Module`` updates through: ``_create_kvstore``, ``_initialize_kvstore``,
``_update_params_on_kvstore`` and ``_update_params``, and the
``MXTPU_MODULE_FUSED`` gate of the fused train step
(``_module_fused_enabled``).
"""
from __future__ import annotations

import os
from collections import namedtuple

import numpy as np

from . import ndarray as nd
from . import symbol as sym

__all__ = ["BatchEndParam", "save_checkpoint", "load_params",
           "load_checkpoint", "params_from_numpy"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _module_fused_enabled():
    """MXTPU_MODULE_FUSED gate for the fused Module train step
    (``module/fused.py``): default on; ``0`` keeps the eager
    forward/backward/per-parameter update loop everywhere."""
    return os.environ.get("MXTPU_MODULE_FUSED", "1").strip().lower() \
        not in ("0", "false", "off")


def _create_kvstore(kvstore, num_device, arg_params):
    """``(store, update_on_kvstore)`` from a store or a type name. A name
    without "dist" on one device means no store (the module's updater
    runs); a given store object updates the weights at the store, except
    for a "local" store by name whose largest parameter passes 16M
    elements."""
    from . import kvstore as kvs
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(np.prod(param.shape)
                               for param in arg_params.values()) \
                    if arg_params else 0
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """One store entry a parameter, then (when the store updates) its
    value pulled into every device's array. The entry is copied from the
    first device's array, which holds ``arg_params``' value, so that the
    store's weight lives where the update runs."""
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, param_on_devs[0])
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Push each gradient (the store's optimizer updates its weight), then
    pull the weight into the devices' arrays."""
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        name = param_names[index]
        kvstore.push(name, grad_list, priority=-index)
        kvstore.pull(name, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Sum the gradients through the store if there is one, then run the
    updater on each device's copy, slot ``index * num_device + k``."""
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        if kvstore:
            name = param_names[index]
            kvstore.push(name, grad_list, priority=-index)
            kvstore.pull(name, grad_list, priority=-index)
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(index * num_device + k, g, w)


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
    numpy arrays, or of any arrays with ``asnumpy()``: the dicts that
    ``mxtpu``'s ``Module.get_params()`` or ``model.load_params`` return,
    ready for the port's ``Module.init_params`` / ``set_params``. Arrays
    keep their layout: a fused RNN's flat ``parameters`` blob stays in the
    cuDNN layout of ``rnn_blob_blocks``."""
    def convert(table):
        return {k: nd.array(v.asnumpy() if hasattr(v, "asnumpy") else v,
                            ctx=ctx) for k, v in (table or {}).items()}
    return convert(arg_params), convert(aux_params)
