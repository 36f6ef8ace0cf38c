"""Evaluation metrics of the PyTorch port.

Counterpart of ``mxtpu/metric.py``'s ``EvalMetric`` (``update``,
``get``, ``get_name_value``, ``reset``, and the device-side
accumulation: ``device_batch``, ``supports_device_update``,
``update_async`` / ``detach_async`` / ``_drain_async``),
``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``, ``F1``, ``MCC``,
``Perplexity``, ``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``,
``NegativeLogLikelihood``, ``PearsonCorrelation``, ``Loss`` (and its
``Torch`` and ``Caffe`` names), ``CustomMetric`` and ``np`` (a metric from
a numpy function of the label and the prediction, read back to the host
each batch) and ``create`` (of a name, an alias, a list, a callable or an
instance).

``Accuracy`` and ``CrossEntropy`` accumulate on the predictions' device:
``update`` adds the batch's sum to a tensor there (labels are moved to
that device first) and counts its rows on the host, and only ``get``
reads the sum back. So a training step makes no host sync for its
metric; a reader such as ``Speedometer`` pays one when it asks. Sums
accumulate in float32, as in ``mxtpu``. Under the fused ``Module`` train
step the step itself adds each batch's ``device_batch`` to a (sum, count)
tensor that the trainer owns (``update_async``); ``get`` reads it.
``Perplexity`` has no device rule, as in ``mxtpu``: it picks each row's
label probability and masks the ignored labels on the predictions'
device, then reads the picked values back, one host read of a value a
row, and finishes the batch on the host as ``mxtpu`` does.

The metrics ``mxtpu`` computes in numpy on the host with a device rule
beside (``TopKAccuracy``, whose ranking is numpy's ``argsort`` on the host
and a stable one on the device, as ``jnp.argsort`` is), or with none
(``F1``, ``MCC``, ``PearsonCorrelation``), read each batch back and run
the same numpy; ``MAE`` / ``MSE`` / ``RMSE``, the probability NLLs and
``Loss`` accumulate on the device.
"""
from __future__ import annotations

import math

import numpy
import torch

from . import ndarray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "register", "get"]


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Raise unless labels and predictions pair up (by count, or by
    shape with ``shape``)."""
    measure = (lambda x: x.shape) if shape else len
    got_l, got_p = measure(labels), measure(preds)
    if got_l != got_p:
        raise ValueError(
            "Shape of labels {} does not match shape of predictions {}"
            .format(got_l, got_p))
    if wrap:
        if isinstance(labels, ndarray.NDArray):
            labels = [labels]
        if isinstance(preds, ndarray.NDArray):
            preds = [preds]
    return labels, preds


def _tensor(arr, device=None):
    """The tensor of an NDArray (or array-like), on ``device`` if given;
    a copy to the card is queued without a wait."""
    t = arr.data if isinstance(arr, ndarray.NDArray) \
        else torch.as_tensor(numpy.asarray(arr))
    if device is not None and t.device != device:
        t = t.to(device, non_blocking=True)
    return t


def _host(arr, dtype=None):
    """An array of the batch as host numpy (halves as float32), cast to
    ``dtype`` if given."""
    t = _tensor(arr)
    if t.dtype in (torch.float16, torch.bfloat16):
        t = t.float()
    out = t.detach().cpu().numpy()
    return out if dtype is None else out.astype(dtype, copy=False)


def _listed(x):
    return x if isinstance(x, list) else [x]


class EvalMetric:
    """Base metric: a running (sum, count) whose ratio ``get`` returns."""

    def __init__(self, name, output_names=None, label_names=None,
                 **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        """The metric's constructor arguments, with its class and name."""
        return dict(self._kwargs, metric=self.__class__.__name__,
                    name=self.name, output_names=self.output_names,
                    label_names=self.label_names)

    def update(self, labels, preds):
        """Accumulate a batch. Metrics with :meth:`device_batch` add its
        sum on the device; the count is known on the host."""
        labels, preds = check_label_shapes(labels, preds, True)
        batch = self.device_batch(labels, preds)
        if batch is None:
            raise NotImplementedError()
        self._accum_device(*batch)

    # -- device-side accumulation ------------------------------------------
    def device_batch(self, labels, preds):
        """One batch's (sum tensor on the predictions' device, count), or
        None where the metric has no device rule."""
        return None

    def supports_device_update(self):
        """True when the metric has a :meth:`device_batch` and pairs all
        outputs with all labels (the fused step hands it the outputs as
        they are)."""
        return (type(self).device_batch is not EvalMetric.device_batch
                and self.output_names is None and self.label_names is None)

    def update_async(self, read_fn, reset_fn=None):
        """Route accumulation through a (sum, count) accumulator that the
        caller owns (the fused train step): ``read_fn()`` returns the
        pair accumulated since its last call, and zeroes it; it is called
        at :meth:`get`. ``reset_fn()`` discards the accumulation."""
        self._async_reader = read_fn
        self._async_resetter = reset_fn

    def detach_async(self):
        self._async_reader = self._async_resetter = None

    def _drain_async(self):
        if self._pending is not None:
            self.sum_metric += float(self._pending)
            self._pending = None
        reader = getattr(self, "_async_reader", None)
        if reader is not None:
            total, count = reader()
            self._accum(total, count)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._pending = None        # the device sum not yet read back
        resetter = getattr(self, "_async_resetter", None)
        if resetter is not None:
            resetter()

    def _accum(self, total, count):
        self.sum_metric += total
        self.num_inst += count

    def _accum_device(self, total, count):
        self._pending = total if self._pending is None \
            else self._pending + total
        self.num_inst += count

    def get(self):
        self._drain_async()
        value = self.sum_metric / self.num_inst if self.num_inst \
            else float("nan")
        return (self.name, value)

    def get_name_value(self):
        name, value = self.get()
        return list(zip(_listed(name), _listed(value)))


_metric_registry = {}


def register(klass):
    _metric_registry[klass.__name__.lower()] = klass
    return klass


def alias(*names):
    def deco(klass):
        register(klass)
        for n in names:
            _metric_registry[n.lower()] = klass
        return klass
    return deco


def get(name, *args, **kwargs):
    try:
        klass = _metric_registry[name.lower()]
    except KeyError:
        raise ValueError("Cannot find metric %s" % name) from None
    return klass(*args, **kwargs)


def create(metric, *args, **kwargs):
    """A metric from a name, a list of them, or an instance."""
    if isinstance(metric, list):
        return CompositeEvalMetric([create(m, *args, **kwargs)
                                    for m in metric])
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, str):
        return get(metric, *args, **kwargs)
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    raise TypeError("metric should be a str, callable, list or EvalMetric")


@alias("composite")
class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for child in self.metrics:
            child.update(labels, preds)

    def reset(self):
        for child in getattr(self, "metrics", ()):
            child.reset()

    def get(self):
        names, values = [], []
        for child in self.metrics:
            name, value = child.get()
            names += _listed(name)
            values += [value] if isinstance(
                value, (float, int, numpy.generic)) else list(value)
        return (names, values)


@alias("acc")
class Accuracy(EvalMetric):
    """Share of rows whose argmax along ``axis`` is the label."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names)
        self.axis = axis

    def device_batch(self, labels, preds):
        hits, count = 0, 0
        for truth, scores in zip(labels, preds):
            scores = _tensor(scores)
            truth = _tensor(truth, scores.device)
            if scores.shape != truth.shape:
                scores = scores.argmax(dim=self.axis)
            decided = scores.to(torch.int32).reshape(-1)
            expected = truth.to(torch.int32).reshape(-1)
            check_label_shapes(expected, decided)
            hits = hits + (decided == expected).sum(dtype=torch.float32)
            count += decided.numel()
        return hits, count


@alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    """Share of rows whose label is among the ``top_k`` largest scores,
    ranked by an ascending argsort (ties fall as numpy's ``argsort``
    leaves them on the host, as a stable sort does on the device)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names)
        self.top_k = top_k
        if self.top_k <= 1:
            raise ValueError("Please use Accuracy if top_k is no more "
                             "than 1")
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for truth, scores in zip(labels, preds):
            if scores.ndim > 2:
                raise ValueError("Predictions should be no more than 2 "
                                 "dims")
            ranked = numpy.argsort(_host(scores, "float32"), axis=-1)
            expected = _host(truth, "int32")
            check_label_shapes(expected, ranked)
            if ranked.ndim == 1:
                hits = int((ranked.ravel() == expected.ravel()).sum())
            else:
                k = min(ranked.shape[1], self.top_k)
                best = ranked[:, ranked.shape[1] - k:]
                hits = int((best == expected.reshape(-1, 1)).any(1).sum())
            self._accum(hits, ranked.shape[0])

    def device_batch(self, labels, preds):
        hits, count = 0, 0
        for truth, scores in zip(labels, preds):
            scores = _tensor(scores)
            ranked = torch.argsort(scores.float(), dim=-1, stable=True)
            expected = _tensor(truth, scores.device).to(torch.int32)
            if ranked.ndim == 1:
                hit = ranked.reshape(-1) == expected.reshape(-1)
            else:
                k = min(ranked.shape[1], self.top_k)
                best = ranked[:, ranked.shape[1] - k:]
                hit = (best == expected.reshape(-1, 1)).any(1)
            hits = hits + hit.sum(dtype=torch.float32)
            count += ranked.shape[0]
        return hits, count


@alias("f1_score")
class F1(EvalMetric):
    """Binary F1 of each batch's argmax decisions, averaged over
    batches (on the host)."""

    def __init__(self, name="f1", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for truth, scores in zip(labels, preds):
            scores_np = _host(scores)
            expected = _host(truth, "int32")
            decided = numpy.argmax(scores_np, axis=1)
            check_label_shapes(expected, scores_np)
            if numpy.unique(expected).size > 2:
                raise ValueError("F1 currently only supports binary "
                                 "classification.")
            tp = float(((decided == 1) & (expected == 1)).sum())
            fp = float(((decided == 1) & (expected == 0)).sum())
            fn = float(((decided == 0) & (expected == 1)).sum())
            precision = tp / (tp + fp) if tp + fp else 0.0
            recall = tp / (tp + fn) if tp + fn else 0.0
            pr = precision + recall
            self._accum(2 * precision * recall / pr if pr else 0.0, 1)


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient of each batch's binary argmax
    decisions, averaged over batches (on the host)."""

    def __init__(self, name="mcc", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for truth, scores in zip(labels, preds):
            expected = _host(truth, "int32")
            decided = numpy.argmax(_host(scores), axis=1)
            tp, tn, fp, fn = (float(((decided == p) & (expected == t)).sum())
                              for p, t in ((1, 1), (0, 0), (1, 0), (0, 1)))
            denom = math.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
            self._accum((tp * tn - fp * fn) / denom if denom else 0.0, 1)


def _column(x):
    """A 1-d batch as a (n, 1) column, so errors broadcast as ``mxtpu``'s
    do; float32 before any reduction."""
    if x.is_floating_point():
        x = x.float()
    return x.reshape(x.shape[0], 1) if x.dim() == 1 else x


class _PairwiseError(EvalMetric):
    """The regression metrics: the mean of ``_measure(truth, pred)`` a
    batch, averaged over batches, summed on the device."""

    def device_batch(self, labels, preds):
        total, count = 0, 0
        for truth, scores in zip(labels, preds):
            scores = _column(_tensor(scores))
            truth = _column(_tensor(truth, scores.device))
            total = total + self._measure(truth, scores)
            count += 1
        return total, count


@register
class MAE(_PairwiseError):
    """Mean absolute error."""

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    @staticmethod
    def _measure(truth, scores):
        return (truth - scores).abs().mean()


@register
class MSE(_PairwiseError):
    """Mean squared error."""

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    @staticmethod
    def _measure(truth, scores):
        return (truth - scores).square().mean()


@register
class RMSE(_PairwiseError):
    """Root mean squared error."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    @staticmethod
    def _measure(truth, scores):
        return (truth - scores).square().mean().sqrt()


class _ProbNLL(EvalMetric):
    """CrossEntropy and NegativeLogLikelihood: the sum of -log(p + eps)
    of each row's probability for its label, over the rows."""

    def __init__(self, name, eps=1e-12, output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def device_batch(self, labels, preds):
        total, count = 0, 0
        for truth, scores in zip(labels, preds):
            scores = _tensor(scores)
            expected = _tensor(truth, scores.device).reshape(-1).long()
            rows = scores.shape[0]
            if expected.shape[0] != rows:
                raise ValueError("%d labels for %d rows"
                                 % (expected.shape[0], rows))
            chosen = scores[torch.arange(rows, device=scores.device),
                            expected].float()
            total = total - torch.log(chosen + self.eps).sum()
            count += rows
        return total, count


@alias("ce")
class CrossEntropy(_ProbNLL):
    """Mean of -log(p + eps) of each row's probability for its label."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)


@alias("nll_loss")
class NegativeLogLikelihood(_ProbNLL):
    """CrossEntropy's rule under the name ``nll-loss``."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)


@alias("pearsonr")
class PearsonCorrelation(EvalMetric):
    """Pearson's r of each batch's predictions and labels, averaged over
    batches (numpy's ``corrcoef`` on the host)."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for truth, scores in zip(labels, preds):
            check_label_shapes(truth, scores, False, True)
            r = numpy.corrcoef(_host(scores).ravel(),
                               _host(truth).ravel())[0, 1]
            self._accum(float(r), 1)


@register
class Loss(EvalMetric):
    """The mean of every output entry (a loss head's output), summed on
    the device in float32."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, _, preds):
        if isinstance(preds, ndarray.NDArray):
            preds = [preds]
        self._accum_device(*self.device_batch(None, preds))

    def device_batch(self, labels, preds):
        total, count = 0, 0
        for scores in preds:
            scores = _tensor(scores)
            total = total + scores.float().sum()
            count += scores.numel()
        return total, count


@register
class Torch(Loss):
    """Loss under the name ``torch``."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    """Loss under the name ``caffe``."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Perplexity(EvalMetric):
    """exp of the mean negative log-probability of each row's label, a
    value a batch, averaged over batches (``mxtpu``'s Perplexity); rows
    whose label is ``ignore_label`` are left out."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label, axis=axis,
                         output_names=output_names, label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def _picked(self, truth, scores):
        """Each row's probability of its label with the ignored rows set
        to 1, and the number ignored, in one host array (float32)."""
        scores = _tensor(scores)
        flat = _tensor(truth, scores.device).reshape(-1)
        classes = scores.shape[self.axis]
        if flat.numel() * classes != scores.numel():
            raise ValueError("shape mismatch: %s vs. %s"
                             % (tuple(flat.shape), tuple(scores.shape)))
        rows = torch.movedim(scores, self.axis, -1).reshape(-1, classes)
        idx = flat.to(torch.int64).clamp(0, classes - 1)
        picked = rows.gather(1, idx[:, None])[:, 0].float()
        ignored = picked.new_zeros(1)
        if self.ignore_label is not None:
            masked = flat == self.ignore_label
            picked = torch.where(masked, picked.new_ones(()), picked)
            ignored = masked.sum(dtype=torch.float32).reshape(1)
        return torch.cat([picked, ignored]).cpu().numpy()

    def update(self, labels, preds):
        if len(labels) != len(preds):
            raise ValueError("%d labels for %d predictions"
                             % (len(labels), len(preds)))
        neg_log = 0.0
        count = 0
        for truth, scores in zip(labels, preds):
            host = self._picked(truth, scores)
            picked = host[:-1]
            count -= int(host[-1])
            neg_log -= float(
                numpy.log(numpy.maximum(1e-10, picked)).sum())
            count += picked.size
        self._accum(
            numpy.exp(neg_log / count) if count > 0 else float("nan"), 1)


@register
class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` of numpy arrays, returning a
    value (counted once) or a (sum, count) pair. It has no device rule:
    each batch's labels and predictions are read back to the host."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = "custom(%s)" % name
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for scores, truth in zip(preds, labels):
            outcome = self._feval(_tensor(truth).cpu().numpy(),
                                  _tensor(scores).cpu().numpy())
            if isinstance(outcome, tuple):
                self._accum(*outcome)
            else:
                self._accum(outcome, 1)


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A :class:`CustomMetric` over ``numpy_feval(label, pred)``."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
