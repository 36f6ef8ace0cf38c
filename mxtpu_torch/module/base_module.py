"""BaseModule of the PyTorch port: the high-level training interface.

Counterpart of ``mxtpu/module/base_module.py``: ``fit`` (its loop stages
the next batch on the device while the current step runs), ``score``,
``iter_predict`` / ``predict``, ``forward_backward``, and
``save_params`` / ``load_params``.
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from .. import ndarray as nd
from ..context import cpu
from ..initializer import Uniform
from ..model import BatchEndParam

__all__ = ["BaseModule"]


def _as_list(obj):
    if isinstance(obj, (list, tuple)):
        return obj
    return [obj]


def _fire(callbacks, **kw):
    """Hand one BatchEndParam to every callback."""
    if callbacks is None:
        return
    event = BatchEndParam(**kw)
    for cb in _as_list(callbacks):
        cb(event)


def _check_input_names(symbol, names, typename, throw):
    """Check that the names are arguments of the symbol."""
    args = symbol.list_arguments()
    known = set(args)
    suffixes = ("_weight", "_bias", "_gamma", "_beta")
    for name in names:
        if name in known:
            continue
        data_like = "\n\t".join(a for a in args if not a.endswith(suffixes))
        msg = ("You created Module with Module(..., %s_names=%s) but input "
               "with name '%s' is not found in symbol.list_arguments(). Did "
               "you mean one of:\n\t%s" % (typename, str(names), name,
                                           data_like))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


def _check_names_match(data_names, data_shapes, name, throw):
    described = sorted(d[0] for d in data_shapes)
    if described != sorted(data_names):
        msg = ("Data provided by %s_shapes don't match names specified by "
               "%s_names (%s vs. %s)" % (name, name, str(data_shapes),
                                         str(data_names)))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


def _parse_data_desc(data_names, label_names, data_shapes, label_shapes):
    """Shape specs as DataDesc lists."""
    from ..io import DataDesc

    def to_descs(specs):
        return [s if isinstance(s, DataDesc) else DataDesc(*s)
                for s in specs]

    data_shapes = to_descs(data_shapes)
    _check_names_match(data_names, data_shapes, "data", True)
    if label_shapes is None:
        _check_names_match(label_names, [], "label", False)
    else:
        label_shapes = to_descs(label_shapes)
        _check_names_match(label_names, label_shapes, "label", False)
    return data_shapes, label_shapes


class BaseModule:
    """Abstract module: a computation over batches of data."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = self.for_training = self.inputs_need_grad = False
        self.params_initialized = self.optimizer_initialized = False
        self._symbol = None

    # -- high-level interface ---------------------------------------------
    def forward_backward(self, data_batch):
        """A training forward, then backward."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def _eval_batches(self, eval_data, num_batch, reset):
        """Yield (index, batch) after an inference forward of each batch,
        up to ``num_batch`` batches."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("bind and initialize the parameters first")
        if reset:
            eval_data.reset()
        for idx, batch in enumerate(eval_data):
            if idx == num_batch:
                return
            self.prepare(batch)
            self.forward(batch, is_train=False)
            yield idx, batch

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """The metric over ``eval_data`` (inference forwards)."""
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        seen = 0
        for idx, batch in self._eval_batches(eval_data, num_batch, reset):
            self.update_metric(eval_metric, batch.label)
            _fire(batch_end_callback, epoch=epoch, nbatch=idx,
                  eval_metric=eval_metric, locals=locals())
            seen = idx + 1
        _fire(score_end_callback, epoch=epoch, nbatch=seen,
              eval_metric=eval_metric, locals=locals())
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True,
                     sparse_row_id_fn=None):
        """Yield (outputs without the padding rows, index, batch)."""
        for idx, batch in self._eval_batches(eval_data, num_batch, reset):
            trimmed = [out[0:out.shape[0] - batch.pad]
                       for out in self.get_outputs()]
            yield (trimmed, idx, batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, sparse_row_id_fn=None):
        """The outputs over ``eval_data``, padding rows dropped, merged
        across batches."""
        collected = []
        for _, batch in self._eval_batches(eval_data, num_batch, reset):
            collected.append([out[0:out.shape[0] - batch.pad].copy()
                              for out in self.get_outputs()])
        if not (collected and merge_batches):
            return collected
        if len({len(c) for c in collected}) != 1:
            raise ValueError("Cannot merge batches, as num of outputs is not "
                             "the same in mini-batches. Maybe bucketing is "
                             "used?")
        merged = [nd.concatenate(list(column), axis=0)
                  for column in zip(*collected)]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """Train for ``num_epoch`` epochs; score ``eval_data`` after each."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        if monitor is not None:
            raise NotImplementedError("Monitor is not ported")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            epoch_start = time.time()
            eval_metric.reset()
            eval_name_vals = []
            # one batch ahead: the next batch is drawn (and its copy to the
            # device queued) once the current step is enqueued
            feed = iter(train_data)
            batch = next(feed, None)
            nbatch = 0
            while batch is not None:
                self.forward_backward(batch)
                self.update()
                upcoming = next(feed, None)
                if upcoming is not None:
                    self.prepare(upcoming)
                self.update_metric(eval_metric, batch.label)
                if upcoming is None:
                    eval_name_vals = eval_metric.get_name_value()
                _fire(batch_end_callback, epoch=epoch, nbatch=nbatch,
                      eval_metric=eval_metric, locals=locals())
                batch = upcoming
                nbatch += 1
            for name, val in eval_name_vals:
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - epoch_start)
            synced_args, synced_auxs = self.get_params()
            self.set_params(synced_args, synced_auxs)
            for cb in _as_list(epoch_end_callback or []):
                cb(epoch, self.symbol, synced_args, synced_auxs)
            if eval_data:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    # -- symbol / params ---------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        """Save the parameters as ``arg:`` / ``aux:`` entries."""
        args, auxs = self.get_params()
        table = {"arg:%s" % k: v for k, v in args.items()}
        table.update(("aux:%s" % k, v) for k, v in auxs.items())
        nd.save(fname, table)

    def load_params(self, fname):
        """Load parameters saved by :meth:`save_params` (either package's
        file)."""
        groups = {"arg": {}, "aux": {}}
        for k, value in nd.load(fname, ctx=cpu()).items():
            kind, _, name = k.partition(":")
            if kind not in groups or not name:
                raise ValueError("Invalid param file " + fname)
            groups[kind][name] = value
        self.set_params(groups["arg"], groups["aux"])

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Ready a batch before its step."""

    # -- computation interface --------------------------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()
