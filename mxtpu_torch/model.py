"""Checkpoints and the kvstore training glue of the PyTorch port.

Counterpart of ``mxtpu/model.py``: ``BatchEndParam``, the same
``prefix-symbol.json`` + ``prefix-%04d.params`` pair (a checkpoint
written by either package loads in the other), and the helpers that
``Module`` updates through: ``_create_kvstore``, ``_initialize_kvstore``,
``_update_params_on_kvstore`` and ``_update_params``, the
``MXTPU_MODULE_FUSED`` gate of the fused train step
(``_module_fused_enabled``), and ``FeedForward``, the legacy front end
over a ``Module``.
"""
from __future__ import annotations

import os
from collections import namedtuple

import numpy as np

from . import ndarray as nd
from . import symbol as sym

__all__ = ["BatchEndParam", "save_checkpoint", "load_params",
           "load_checkpoint", "params_from_numpy", "FeedForward"]

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
    cuDNN layout of ``rnn_blob_blocks``, and a row-sparse or CSR array
    (``mxtpu``'s ``.params`` entries with ``::stype``) its storage type
    and stored rows."""
    def convert(v):
        stype = getattr(v, "stype", "default")
        if stype == "row_sparse":
            return nd.sparse.row_sparse_array(
                (v.data.asnumpy(), v.indices.asnumpy()), shape=v.shape,
                ctx=ctx)
        if stype == "csr":
            return nd.sparse.csr_matrix(
                (v.data.asnumpy(), v.indices.asnumpy(), v.indptr.asnumpy()),
                shape=v.shape, ctx=ctx)
        return nd.array(v.asnumpy() if hasattr(v, "asnumpy") else v,
                        ctx=ctx)
    return ({k: convert(v) for k, v in (arg_params or {}).items()},
            {k: convert(v) for k, v in (aux_params or {}).items()})


class FeedForward:
    """The legacy training front end (MXNet's ``model.FeedForward``, as
    ``mxtpu`` keeps it): a ``Module`` on ``ctx`` behind numpy-friendly
    ``fit`` / ``predict`` / ``score`` / ``save`` / ``load``; keyword
    arguments beyond its own are the optimizer's parameters."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as init_mod
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or init_mod.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None

    def _as_iter(self, X, y=None, batch_size=None, shuffle=False):
        from . import io
        if hasattr(X, "provide_data"):
            return X
        return io.NDArrayIter(X, y, batch_size or self.numpy_batch_size,
                              shuffle=shuffle)

    def _ensure_module(self):
        from . import module as mod
        if self._module is None:
            self._module = mod.Module(self.symbol, context=self.ctx)
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        train = self._as_iter(X, y, shuffle=True)
        if eval_data is not None and not hasattr(eval_data, "provide_data"):
            eval_data = self._as_iter(eval_data[0], eval_data[1])
        m = self._ensure_module()
        # a module bound for inference by predict/score is bound again
        rebind = m.binded and not m.for_training
        m.fit(train, eval_data=eval_data, eval_metric=eval_metric,
              force_rebind=rebind, epoch_end_callback=epoch_end_callback,
              batch_end_callback=batch_end_callback, kvstore=kvstore,
              optimizer=self.optimizer,
              optimizer_params=self.kwargs or {"learning_rate": 0.01},
              initializer=self.initializer, arg_params=self.arg_params,
              aux_params=self.aux_params, allow_missing=True,
              begin_epoch=self.begin_epoch, num_epoch=self.num_epoch or 1,
              monitor=monitor)
        self.arg_params, self.aux_params = m.get_params()
        return self

    def _bound(self, data, for_training=False):
        m = self._ensure_module()
        if not m.binded:
            m.bind(data_shapes=data.provide_data,
                   label_shapes=data.provide_label if for_training
                   else None, for_training=False)
            m.init_params(self.initializer, arg_params=self.arg_params,
                          aux_params=self.aux_params, allow_missing=True,
                          allow_extra=self.allow_extra_params)
        return m

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The first output over ``X``'s batches as numpy, padding cut;
        with ``return_data`` also the data and labels."""
        data = self._as_iter(X)
        m = self._bound(data)
        if reset:
            data.reset()
        if not return_data:
            out = m.predict(data, num_batch=num_batch)
            if isinstance(out, (list, tuple)):
                return [o.asnumpy() for o in out]
            return out.asnumpy()
        outs, datas, labels = [], [], []
        for nbatch, batch in enumerate(data):
            if num_batch is not None and nbatch == num_batch:
                break
            m.forward(batch, is_train=False)
            n = batch.data[0].shape[0] - (getattr(batch, "pad", 0) or 0)
            outs.append(m.get_outputs()[0].asnumpy()[:n])
            datas.append(batch.data[0].asnumpy()[:n])
            if batch.label:
                labels.append(batch.label[0].asnumpy()[:n])
        return (np.concatenate(outs), np.concatenate(datas),
                np.concatenate(labels) if labels else None)

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        from . import metric as metric_mod
        data = self._as_iter(X)
        if reset:
            data.reset()
        m = self._bound(data, for_training=True)
        metric = metric_mod.create(eval_metric)
        res = m.score(data, metric, num_batch=num_batch)
        return dict(res)[metric.name]

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)
