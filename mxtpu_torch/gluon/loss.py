"""Gluon losses of the PyTorch port.

Counterpart of ``mxtpu/gluon/loss.py``: the same loss blocks, each a
HybridBlock written through the op registry, so a loss runs on the nd
and the sym frontends alike. ``CTCLoss`` runs the port's ``ctc_loss``
op, a log-space DP over time in torch ops.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    """(reference gluon/loss.py:31)."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    return x.reshape(y.shape)


class Loss(HybridBlock):
    """Base loss (reference gluon/loss.py:49)."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (
            self.__class__.__name__, self._batch_axis, self._weight)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def _batch_mean(self, F, loss):
        axes = tuple(i for i in range(len(loss.shape))
                     if i != self._batch_axis) if hasattr(loss, "shape") \
            else None
        if axes is not None:
            if not axes:
                return loss
            return F.mean(loss, axis=axes)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L2Loss(Loss):
    """0.5 * (pred - label)^2 (reference loss.py:85)."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(pred - label)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return self._batch_mean(F, loss)


class L1Loss(Loss):
    """|pred - label| (reference loss.py:121)."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(pred - label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._batch_mean(F, loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """(reference loss.py:155) numerically-stable BCE on logits."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if not self._from_sigmoid:
            # max(x,0) - x*z + log(1+exp(-|x|))
            loss = F.relu(pred) - pred * label + \
                F.Activation(-F.abs(pred), act_type="softrelu")
        else:
            eps = 1e-12
            loss = -(F.log(pred + eps) * label +
                     F.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._batch_mean(F, loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """(reference loss.py:224)."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(F, label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._batch_mean(F, loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """(reference loss.py:291)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._batch_mean(F, loss)


class CTCLoss(Loss):
    """Connectionist temporal classification (reference loss.py:354;
    ``mxtpu``'s ``gluon/loss.py:150``): ``pred`` in ``layout`` (NTC or
    TNC), ``label`` in ``label_layout`` (NT or TN), the optional lengths
    and ``sample_weight`` a sample. Returns the loss a sample."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        batch_axis = label_layout.find("N")
        super().__init__(weight, batch_axis, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, dim1=0, dim2=1)
        if self._batch_axis == 1:
            label = F.swapaxes(label, dim1=0, dim2=1)
        loss = F.ctc_loss(pred, label, pred_lengths, label_lengths)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """(reference loss.py:422)."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(pred - label)
        loss = F.where(loss > self._rho,
                       loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._batch_mean(F, loss)


class HingeLoss(Loss):
    """(reference loss.py:462)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._batch_mean(F, loss)


class SquaredHingeLoss(Loss):
    """(reference loss.py:500)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._batch_mean(F, loss)


class LogisticLoss(Loss):
    """(reference loss.py:538)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError("unknown label_format %r" % label_format)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-F.abs(pred), act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._batch_mean(F, loss)


class TripletLoss(Loss):
    """(reference loss.py:587)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        positive = _reshape_like(F, positive, pred)
        negative = _reshape_like(F, negative, pred)
        axes = tuple(range(1, len(pred.shape)))
        loss = F.sum(F.square(pred - positive) - F.square(pred - negative),
                     axis=axes)
        loss = F.relu(loss + self._margin)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return loss
