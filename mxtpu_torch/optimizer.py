"""Optimizers of the PyTorch port.

Counterpart of ``mxtpu/optimizer.py``'s ``Optimizer`` (registry and
``create``, per-parameter lr / wd multipliers from ``set_lr_mult`` /
``set_wd_mult``, the symbol's ``__lr_mult__`` / ``__wd_mult__`` and
``param_dict``, ``rescale_grad``, ``clip_gradient``, ``lr_scheduler``,
``multi_precision``'s float32 master weights for float16 ones, update
counts), its 16 registered optimizers (``SGD``,
``Signum``, ``FTML``, ``LBSGD``, ``DCASGD``, ``NAG``, ``SGLD``, ``ccSGD``,
``Adam``, ``AdaGrad``, ``RMSProp``, ``AdaDelta``, ``Ftrl``, ``Adamax``,
``Nadam``, ``Test``), and the ``Updater`` with ``get_states`` /
``set_states``.

A row-sparse gradient takes the lazy update in SGD and Adam (unless
``lazy_update=False``), AdaGrad and Ftrl, as in ``mxtpu``
(:func:`_lazy_rsp_update`: the stored rows only); the others densify it.
An update runs in place on the weight's and the state's tensors under
``torch.no_grad()``, in ``mxtpu``'s order of operations (rescale, clip,
add ``wd * weight``, then the rule), so the tensors bound to an executor
stay the same from step to step.

:func:`functional_optimizer_step` runs the same ``update`` with the step
count ``t`` and the learning rate read from 0-dim tensors on the
weight's device (``mxtpu``'s traced scalars), so that a step captured in
a CUDA graph sees the schedule and Adam's bias correction move between
replays; ``state_to_tree`` / ``tree_to_state`` convert a state slot
between NDArrays and tensors. Every factor an update derives from ``t``
(``beta ** t``, Nadam's ``0.96 ** (t * decay)``, LBSGD's warmup) is then a
float64 tensor computed from it, never a Python float, which a capture
would freeze into the graph. State that ``mxtpu`` keeps on the optimizer
stays on the device there too: Nadam's running ``m_schedule`` becomes a
float64 0-dim tensor multiplied in place, once a parameter an update, in
update order, as the Python float is in eager steps. LBSGD's ``lars``
norms are sums on the device in both modes, and SGLD draws its noise
from :func:`~mxtpu_torch.ops.registry.next_generator`, which inside the
captured step is the step's registered generator.
"""
from __future__ import annotations

import logging
import math
import pickle
import warnings

import numpy as _np
import torch

from . import ndarray as nd
from .context import cpu
from .ndarray import NDArray
from .ops.registry import next_generator

__all__ = ["Optimizer", "SGD", "Signum", "FTML", "LBSGD", "DCASGD", "NAG",
           "SGLD", "ccSGD", "Adam", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl",
           "Adamax", "Nadam", "Test", "Updater", "create", "register",
           "get_updater", "functional_optimizer_step", "state_to_tree",
           "tree_to_state"]


class Optimizer:
    """Base optimizer: ``update(index, weight, grad, state)`` on NDArrays,
    ``create_state(index, weight)`` for its state."""

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad, self.lr, self.wd = rescale_grad, learning_rate, wd
        self.multi_precision = multi_precision
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.lr_mult, self.wd_mult = {}, {}
        self.begin_num_update = self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        if param_idx2name is not None and \
                not isinstance(param_idx2name, dict):
            raise TypeError("param_idx2name should be a dict of param "
                            "indexes to names.")
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ()
        # {index: an object with lr_mult and wd_mult} (a Gluon Parameter)
        self.param_dict = dict(param_dict or {})
        # (t, lr) as device tensors while functional_optimizer_step runs
        self._step_scalars = None
        self.set_lr_mult({})
        self.set_wd_mult({})

    # -- registry ----------------------------------------------------------
    @staticmethod
    def register(klass):
        key = klass.__name__.lower()
        if Optimizer.opt_registry.setdefault(key, klass) is not klass:
            warnings.warn("New optimizer %s.%s is overriding existing "
                          "optimizer %s" % (klass.__module__,
                                            klass.__name__, key))
            Optimizer.opt_registry[key] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        try:
            klass = Optimizer.opt_registry[name.lower()]
        except KeyError:
            raise ValueError("Cannot find optimizer %s" % name) from None
        return klass(**kwargs)

    # -- state -------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def _uses_master_weights(self, weight):
        return self.multi_precision and weight.dtype == _np.float16

    def create_state_multi_precision(self, index, weight):
        """The state of ``index``: under ``multi_precision`` a float16
        weight's is ``(float32 master copy, the master's state)``; any
        other weight's is :meth:`create_state`'s."""
        if self._uses_master_weights(weight):
            master = weight.astype(_np.float32)
            return (master, self.create_state(index, master))
        if weight.dtype == _np.float16:
            warnings.warn(
                "Accumulating with float16 in optimizer can lead to poor "
                "accuracy or slow convergence. Consider using "
                "multi_precision=True option of the optimizer")
        return self.create_state(index, weight)

    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update`, on the float32 master copy of a float16 weight
        under ``multi_precision`` (the weight then takes the master's
        value, rounded); on any other weight, the update itself."""
        if not self._uses_master_weights(weight):
            self.update(index, weight, grad, state)
            return
        master, inner = state
        self.update(index, master, grad.astype(_np.float32), inner)
        with torch.no_grad():
            weight._data.copy_(master._data)

    @property
    def learning_rate(self):
        """The scheduler's rate at ``num_update`` if there is a
        scheduler, else the static rate."""
        sched = self.lr_scheduler
        return self.lr if sched is None else sched(self.num_update)

    # -- multipliers -------------------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning(
                "LRScheduler of the optimizer has already been defined. "
                "Note that set_learning_rate can mutate the value of the "
                "learning rate of the optimizer only when the LRScheduler "
                "of the optimizer is undefined.")
        self.lr = lr

    def _sym_mults(self, tag):
        """Multipliers the symbol's variables declare (``__lr_mult__`` /
        ``__wd_mult__``)."""
        found = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                declared = attr.get(name, {})
                if tag in declared:
                    found[name] = float(declared[tag])
        return found

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._sym_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        # parameters other than *_weight / *_bias decay at 0 unless told
        self.wd_mult = {
            n: 0.0 for n in self.idx2name.values()
            if not n.endswith(("_weight", "_bias"))}
        self.wd_mult.update(self._sym_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    # -- bookkeeping -------------------------------------------------------
    def _update_count(self, index):
        count = self._index_update_count
        count[index] = count.get(index, self.begin_num_update) + 1
        self.num_update = max(count[index], self.num_update)

    def _scaled(self, index, base, mults, which):
        """``base`` times the slot's multiplier: ``param_dict``'s entry's
        ``which`` attribute, else one keyed by the index, else by the
        index's name."""
        if index in self.param_dict:
            return base * getattr(self.param_dict[index], which)
        if index in mults:
            return base * mults[index]
        if index in self.idx2name:
            return base * mults.get(self.idx2name[index], 1.0)
        return base

    def _get_lr(self, index):
        return self._scaled(index, self.learning_rate, self.lr_mult,
                            "lr_mult")

    def _get_wd(self, index):
        return self._scaled(index, self.wd, self.wd_mult, "wd_mult")

    def _begin_update(self, index):
        """Count the update; the slot's (lr, wd). Inside
        :func:`functional_optimizer_step` nothing is counted on the host
        and lr is the given tensor times the slot's multiplier."""
        if self._step_scalars is not None:
            lr = self._scaled(index, self._step_scalars[1], self.lr_mult,
                              "lr_mult")
            return lr, self._get_wd(index)
        self._update_count(index)
        return self._get_lr(index), self._get_wd(index)

    def _step_count(self, index):
        """The slot's update count: the given tensor inside
        :func:`functional_optimizer_step`."""
        if self._step_scalars is not None:
            return self._step_scalars[0]
        return self._index_update_count[index]

    def _rescale_clip(self, grad, weight, wd):
        """rescale_grad * grad, clipped to +-clip_gradient, plus wd *
        weight (a new tensor)."""
        g = grad * self.rescale_grad
        if self.clip_gradient is not None and self.clip_gradient >= 0:
            g.clamp_(-self.clip_gradient, self.clip_gradient)
        if wd != 0.0:       # + 0 * weight changes no finite value
            g += wd * weight
        return g


register = Optimizer.register
create = Optimizer.create_optimizer


def _clip(g, bound):
    """``g`` (a new tensor) clipped to +-bound in place wherever a bound
    is given (``mxtpu``'s ``_clip``: any bound but None)."""
    if bound is not None:
        g.clamp_(-bound, bound)
    return g


def _float_count(t):
    """The step count as the factors take it: a host int as it is, a
    device count as a float64 tensor."""
    return t.to(torch.float64) if isinstance(t, torch.Tensor) else t


def _pow(base, exponent):
    """``base ** exponent``: a Python float for a host exponent, a
    float64 tensor for a device one."""
    if isinstance(exponent, torch.Tensor):
        return torch.pow(base, exponent)
    return base ** exponent


def _is_rsp(x):
    return getattr(x, "stype", "default") == "row_sparse"


def _state_leaves(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for e in s for x in _state_leaves(e)]
    return [s]


def _lazy_rsp_update(opt, index, weight, grad, state):
    """The lazy update of a row-sparse gradient (``mxtpu``'s, MXNet's
    ``sgd_update`` FComputeEx on row_sparse): the optimizer's dense rule
    on the gradient's STORED rows only, which are gathered from the
    weight and the state, updated by ``opt.update`` as dense arrays and
    written back in place; every other row keeps its weight and its
    (stale) state. A compact weight takes the rows at the slots of their
    ids, which must be resident (``row_sparse_pull`` them first), and
    refuses a stateful optimizer: its state would follow the slots, not
    the rows."""
    from .ndarray.sparse import CompactRowSparseNDArray
    rows = grad.indices._data.to(weight._data.device)
    if rows.numel() == 0:
        opt._update_count(index)
        return
    g_rows = NDArray(grad.data._data.to(weight._data.device),
                     weight.context)
    if isinstance(weight, CompactRowSparseNDArray):
        if _state_leaves(state):
            raise NotImplementedError(
                "stateful optimizers on compact row_sparse weights are "
                "not supported on the worker side: keep the optimizer "
                "where the full table lives (kv.set_optimizer on a "
                "dense-backed store) or use sgd with momentum=0")
        held = weight._idx[:weight._nnz].to(torch.int64)
        slots = torch.searchsorted(held, rows).clamp_(
            max=max(held.numel() - 1, 0))
        found = held[slots] == rows if held.numel() \
            else torch.zeros_like(rows, dtype=torch.bool)
        if not bool(found.all()):
            missing = sorted(set(rows[~found].tolist()))[:5]
            raise KeyError(
                "gradient rows %s... not resident in compact weight "
                "(row_sparse_pull them first)" % missing)
        rows = slots

    def take(s):
        if s is None:
            return None
        if isinstance(s, (tuple, list)):
            return tuple(take(x) for x in s)
        return NDArray(s._data.index_select(0, rows), s.context)

    w_rows = NDArray(weight._data.detach().index_select(0, rows),
                     weight.context)
    s_rows = take(state)
    opt.update(index, w_rows, g_rows, s_rows)
    with torch.no_grad():
        weight._data.index_copy_(0, rows, w_rows._data)
        for s, sr in zip(_state_leaves(state), _state_leaves(s_rows)):
            s._data.index_copy_(0, rows, sr._data)
    if _is_rsp(weight) and not isinstance(weight, CompactRowSparseNDArray):
        weight._aux = None      # an assignment: stored rows found anew


def _zeros_like(weight, dtype=None):
    return nd.zeros(weight.shape, ctx=weight.context,
                    dtype=weight.dtype if dtype is None else dtype)


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum`` > 0:
    mom = momentum * mom - lr * g; weight += mom."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lazy_update = momentum, lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        if _is_rsp(grad) and self.lazy_update:
            return _lazy_rsp_update(self, index, weight, grad, state)
        lr, wd = self._begin_update(index)
        self._sgd_step(weight, grad, state, lr, wd)

    def _sgd_step(self, weight, grad, state, lr, wd):
        with torch.no_grad():
            w = weight._data
            g = self._rescale_clip(grad._data, w, wd)
            if state is not None:
                mom = state._data
                mom.mul_(self.momentum).sub_(lr * g)
                w.add_(mom)
            else:
                w.sub_(lr * g)


@register
class Adam(Optimizer):
    """Adam with ``mxtpu``'s bias correction folded into the rate."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype),
                nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype))

    def update(self, index, weight, grad, state):
        if _is_rsp(grad) and self.lazy_update:
            return _lazy_rsp_update(self, index, weight, grad, state)
        lr, wd = self._begin_update(index)
        t = self._step_count(index)
        if isinstance(t, torch.Tensor):
            # on the device, in float32, as mxtpu's traced step computes it
            tf = t.to(torch.float32)
            coef1 = 1.0 - torch.pow(self.beta1, tf)
            coef2 = 1.0 - torch.pow(self.beta2, tf)
            lr = lr * torch.sqrt(coef2) / coef1
        else:
            coef1 = 1.0 - self.beta1 ** t
            coef2 = 1.0 - self.beta2 ** t
            # in float32, as mxtpu computes it (jnp on Python floats)
            f32 = _np.float32
            lr = float(f32(f32(lr) * _np.sqrt(f32(coef2))) / f32(coef1))
        with torch.no_grad():
            w = weight._data
            mean, var = state[0]._data, state[1]._data
            g = self._rescale_clip(grad._data, w, wd)
            mean.mul_(self.beta1).add_((1.0 - self.beta1) * g)
            var.mul_(self.beta2).add_((1.0 - self.beta2) * g.square())
            w.sub_(lr * mean / (var.sqrt() + self.epsilon))


@register
class Signum(Optimizer):
    """signSGD without momentum, Signum with it: mom = momentum * mom -
    (1 - momentum) * (g + wd * w); w = (1 - lr * wd_lh) * w + lr *
    sign(mom)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.wd_lh = momentum, wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        lr, wd = self._begin_update(index)
        clip = self.clip_gradient
        with torch.no_grad():
            w = weight._data
            g = grad._data * self.rescale_grad
            if clip is not None and clip >= 0:
                g.clamp_(-clip, clip)
            if state is not None:
                mom = state._data
                mom.mul_(self.momentum).sub_((1 - self.momentum)
                                             * (g + wd * w))
                w.copy_((1 - lr * self.wd_lh) * w + lr * torch.sign(mom))
            else:
                w.sub_(lr * (torch.sign(g) + wd * w))


@register
class FTML(Optimizer):
    """FTML (Zheng and Kwok, 2017), state (d, v, z), with ``mxtpu``'s
    ``ftml_update`` rule; its bias corrections come from ``t``."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),
                _zeros_like(weight))

    def update(self, index, weight, grad, state):
        lr, wd = self._begin_update(index)
        t = _float_count(self._step_count(index))
        clip = self.clip_gradient
        with torch.no_grad():
            w = weight._data
            d, v, z = (s._data for s in state)
            g = grad._data * self.rescale_grad
            if clip is not None and clip >= 0:
                g.clamp_(-clip, clip)
            v.mul_(self.beta2).add_((1 - self.beta2) * g.square())
            d_t = (1 - _pow(self.beta1, t)) / lr * (
                (v / (1 - _pow(self.beta2, t))).sqrt() + self.epsilon)
            sigma_t = d_t - self.beta1 * d
            z.mul_(self.beta1).add_((1 - self.beta1) * g).sub_(sigma_t * w)
            w.copy_(-z / d_t - lr * wd * w)
            d.copy_(d_t)


@register
class LBSGD(Optimizer):
    """Large-batch SGD: SGD whose rate is scaled by a warmup multiplier
    (``linear``, ``power2``, ``sqrt``) of the update count, or by the
    layer's LARS ratio (``lars``: sqrt(|w|^2 / (|g|^2 + wd |w|^2)),
    clipped to [0.01, 100]). The count is ``num_update`` in eager steps
    and the device's ``t`` in the captured one; the LARS sums stay on the
    device in both."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(**kwargs)
        logging.info("Running Large-Batch SGD Algorithm")
        logging.info("(Batch_scale=%f, warmup_epochs=%d, warmup_strategy=%s, "
                     "updates_per_epoch=%d)", batch_scale, warmup_epochs,
                     warmup_strategy, updates_per_epoch)
        self.momentum, self.multi_precision = momentum, multi_precision
        self.warmup_strategy, self.warmup_epochs = (warmup_strategy,
                                                    warmup_epochs)
        self.batch_scale, self.updates_per_epoch = (batch_scale,
                                                    updates_per_epoch)
        self.init_updates = begin_epoch * updates_per_epoch

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def _get_lbmult(self, nup):
        """The warmup multiplier at update ``nup`` (an int, or a float64
        tensor: then every branch is a tensor expression)."""
        nwup = self.warmup_epochs * self.updates_per_epoch
        strategy = self.warmup_strategy
        maxmult = float(self.batch_scale)
        if nwup <= 1:
            ramp = 1.0
        elif strategy == "linear":
            ramp = 1.0 + (maxmult - 1) * nup / nwup
        elif strategy == "power2":
            ramp = 1.0 + (maxmult - 1) * (nup * nup) / (nwup * nwup)
        elif strategy == "sqrt":
            root = nup.div(nwup).sqrt() if isinstance(nup, torch.Tensor) \
                else math.sqrt(float(nup) / nwup)
            ramp = 1.0 + (maxmult - 1) * root
        else:
            ramp = 1.0
        if isinstance(nup, torch.Tensor):
            # filled on the device: a tensor made from a Python value
            # would be a copy from the host, which a capture refuses
            if not isinstance(ramp, torch.Tensor):
                ramp = torch.full_like(nup, ramp)
            return torch.where(nup >= nwup, torch.full_like(nup, maxmult),
                               ramp)
        return maxmult if nup >= nwup else ramp

    @staticmethod
    def _get_lars(weight, grad, wd):
        w2 = (weight * weight).sum().to(torch.float64)
        g2 = (grad * grad).sum().to(torch.float64)
        return torch.sqrt(w2 / (g2 + wd * w2 + 1e-18)).clamp(0.01, 100)

    def update(self, index, weight, grad, state):
        lr, wd = self._begin_update(index)
        if self.warmup_strategy == "lars":
            with torch.no_grad():
                lbmult = self._get_lars(weight._data, grad._data, wd)
        else:
            t = self._step_count(index)
            nup = _float_count(t) + self.init_updates \
                if isinstance(t, torch.Tensor) \
                else self.num_update + self.init_updates
            lbmult = self._get_lbmult(nup)
        self._sgd_step(weight, grad, state, lr * lbmult, wd)

    _sgd_step = SGD._sgd_step


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD: the state holds the momentum (or None) and
    the previous weight, both written in place."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lamda = momentum, lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else _zeros_like(weight)
        return (mom, weight.copy())

    def update(self, index, weight, grad, state):
        lr, wd = self._begin_update(index)
        with torch.no_grad():
            w = weight._data
            mom, previous = state
            prev = previous._data
            g = _clip(grad._data * self.rescale_grad, self.clip_gradient)
            comp = g + wd * w + self.lamda * g * g * (w - prev)
            if mom is not None:
                mom._data.mul_(self.momentum).sub_(lr * comp)
                delta = mom._data
            else:
                delta = -lr * comp
            prev.copy_(w)
            w.add_(delta)


@register
class NAG(Optimizer):
    """Nesterov's accelerated SGD: mom = momentum * mom + g; w -= lr *
    (momentum * mom + g), with g = rescaled, clipped grad + wd * w."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = float(momentum)

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        lr, wd = self._begin_update(index)
        with torch.no_grad():
            w = weight._data
            g = _clip(grad._data * self.rescale_grad, self.clip_gradient)
            g = g + wd * w
            if state is not None:
                mom = state._data
                mom.mul_(self.momentum).add_(g)
                g = self.momentum * mom + g
            w.sub_(lr * g)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: w -= lr / 2 * (g + wd *
    w), plus N(0, lr) noise drawn from ``next_generator()`` (the step's
    generator inside the captured step, so each replay draws anew)."""

    def update(self, index, weight, grad, state):
        lr, wd = self._begin_update(index)
        with torch.no_grad():
            w = weight._data
            g = _clip(grad._data * self.rescale_grad, self.clip_gradient)
            gen = next_generator()
            noise = torch.randn(w.shape, generator=gen, device=gen.device,
                                dtype=w.dtype).to(w.device)
            scale = lr.sqrt() if isinstance(lr, torch.Tensor) \
                else math.sqrt(lr)
            w.sub_(lr / 2 * (g + wd * w)).add_(noise * scale)


@register
class ccSGD(SGD):
    """The deprecated name of SGD."""


@register
class AdaGrad(Optimizer):
    """AdaGrad: history += g^2; w -= lr * (g / sqrt(history + eps) + wd *
    w)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        if _is_rsp(grad):
            return _lazy_rsp_update(self, index, weight, grad, state)
        lr, wd = self._begin_update(index)
        with torch.no_grad():
            w = weight._data
            g = _clip(grad._data * self.rescale_grad, self.clip_gradient)
            history = state._data
            history.add_(g * g)
            w.sub_(lr * (g / torch.sqrt(history + self.float_stable_eps)
                         + wd * w))


@register
class RMSProp(Optimizer):
    """RMSProp (Tieleman and Hinton), or with ``centered`` Graves's
    variant with state (n, g, delta); ``clip_weights`` clips the new
    weight."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered, self.epsilon = centered, epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        count = 3 if self.centered else 1
        return tuple(_zeros_like(weight) for _ in range(count))

    def update(self, index, weight, grad, state):
        lr, wd = self._begin_update(index)
        cw = self.clip_weights
        with torch.no_grad():
            w = weight._data
            g = self._rescale_clip(grad._data, w, wd)
            n = state[0]._data
            n.mul_(self.gamma1).add_((1 - self.gamma1) * g.square())
            if not self.centered:
                w.sub_(lr * g / torch.sqrt(n + self.epsilon))
            else:
                g_avg, delta = state[1]._data, state[2]._data
                g_avg.mul_(self.gamma1).add_((1 - self.gamma1) * g)
                delta.mul_(self.gamma2).sub_(
                    lr * g / torch.sqrt(n - g_avg.square() + self.epsilon))
                w.add_(delta)
            if cw is not None and cw > 0:
                w.clamp_(-cw, cw)


@register
class AdaDelta(Optimizer):
    """AdaDelta (Zeiler, 2012), state (acc_g, acc_delta); no learning
    rate."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight, _np.float32),
                _zeros_like(weight, _np.float32))

    def update(self, index, weight, grad, state):
        if self._step_scalars is None:
            self._update_count(index)
        wd = self._get_wd(index)
        with torch.no_grad():
            w = weight._data
            acc_g, acc_delta = (s._data for s in state)
            g = _clip(grad._data * self.rescale_grad, self.clip_gradient)
            acc_g.mul_(self.rho).add_((1.0 - self.rho) * g * g)
            current = torch.sqrt(acc_delta + self.epsilon) \
                / torch.sqrt(acc_g + self.epsilon) * g
            acc_delta.mul_(self.rho).add_((1.0 - self.rho) * current
                                          * current)
            w.copy_(w - current - wd * w)


@register
class Ftrl(Optimizer):
    """FTRL-Proximal (McMahan et al., 2013), state (z, n), with
    ``mxtpu``'s ``ftrl_update`` rule."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        if _is_rsp(grad):
            return _lazy_rsp_update(self, index, weight, grad, state)
        lr, wd = self._begin_update(index)
        clip = self.clip_gradient
        with torch.no_grad():
            w = weight._data
            z, n = (s._data for s in state)
            g = grad._data * self.rescale_grad
            if clip is not None and clip >= 0:
                g.clamp_(-clip, clip)
            sqrt_n = n.sqrt()
            n.add_(g.square())
            sigma = (n.sqrt() - sqrt_n) / lr
            z.add_(g).sub_(sigma * w)
            w.copy_(torch.where(
                z.abs() > self.lamda1,
                -(z - torch.sign(z) * self.lamda1)
                / ((self.beta + n.sqrt()) / lr + wd),
                torch.zeros_like(w)))


@register
class Adamax(Optimizer):
    """AdaMax (Kingma and Ba, section 7): the infinity norm in place of
    Adam's second moment; the rate corrected by 1 - beta1 ** t."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        lr, wd = self._begin_update(index)
        t = _float_count(self._step_count(index))
        lr = lr / (1.0 - _pow(self.beta1, t))
        with torch.no_grad():
            w = weight._data
            m_t, u_t = (s._data for s in state)
            g = _clip(grad._data * self.rescale_grad + wd * w,
                      self.clip_gradient)
            m_t.mul_(self.beta1).add_((1.0 - self.beta1) * g)
            torch.maximum(self.beta2 * u_t, g.abs(), out=u_t)
            w.sub_(lr * m_t / (u_t + 1e-12))


@register
class Nadam(Optimizer):
    """Nesterov-accelerated Adam (Dozat, 2016). ``m_schedule`` is the
    product of every momentum_t so far, taken once a parameter an update
    in update order, as ``mxtpu`` takes it: a Python float in eager
    steps, and from the first step on the device a float64 0-dim tensor
    multiplied in place (a captured step then carries it across
    replays)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _advance_schedule(self, momentum_t, t):
        """m_schedule *= momentum_t; the new product."""
        ms = self.m_schedule
        if isinstance(t, torch.Tensor) and not isinstance(ms, torch.Tensor):
            ms = self.m_schedule = torch.tensor(
                float(ms), dtype=torch.float64, device=t.device)
        if isinstance(ms, torch.Tensor):
            return ms.mul_(momentum_t)
        self.m_schedule = ms * momentum_t
        return self.m_schedule

    def update(self, index, weight, grad, state):
        lr, wd = self._begin_update(index)
        t = _float_count(self._step_count(index))
        decay = self.schedule_decay
        momentum_t = self.beta1 * (1.0 - 0.5 * _pow(0.96, t * decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * _pow(0.96, (t + 1) * decay))
        with torch.no_grad():
            m_schedule = self._advance_schedule(momentum_t, t)
            m_schedule_next = m_schedule * momentum_t_1
            w = weight._data
            m_t, v_t = (s._data for s in state)
            g = _clip(grad._data * self.rescale_grad + wd * w,
                      self.clip_gradient)
            m_t.mul_(self.beta1).add_((1.0 - self.beta1) * g)
            v_t.mul_(self.beta2).add_((1.0 - self.beta2) * g * g)
            grad_prime = g / (1.0 - m_schedule)
            m_t_prime = m_t / (1.0 - m_schedule_next)
            v_t_prime = v_t / (1.0 - _pow(self.beta2, t))
            m_t_bar = (1.0 - momentum_t) * grad_prime \
                + momentum_t_1 * m_t_prime
            w.sub_(lr * m_t_bar / (torch.sqrt(v_t_prime) + self.epsilon))


@register
class Test(Optimizer):
    """The test optimizer: w += rescale_grad * grad; the state takes the
    new weight. It counts no update, as in ``mxtpu``."""

    def create_state(self, index, weight):
        return _zeros_like(weight, _np.float32)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            weight._data.add_(grad._data * self.rescale_grad)
            state._data.copy_(weight._data)


def state_to_tree(state):
    """A state slot (None, an NDArray, or tuples of them) as tensors."""
    if state is None:
        return None
    if isinstance(state, NDArray):
        return state._data
    if isinstance(state, (tuple, list)):
        return tuple(state_to_tree(s) for s in state)
    return state


def tree_to_state(tree):
    """Tensors back as a state slot of NDArrays sharing them."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return tuple(tree_to_state(t) for t in tree)
    return NDArray(tree)


def functional_optimizer_step(optimizer, index, weight, grad, state_tree, t,
                              lr):
    """One ``optimizer.update`` of slot ``index`` on tensors, in place:
    ``weight`` and the state's tensors take their new values. The step
    count ``t`` (int32) and ``lr`` (float32) are 0-dim tensors on the
    weight's device, already advanced for this step; the slot's lr
    multiplier scales ``lr`` there. Nothing is counted on the host: the
    caller keeps ``num_update`` and the slots' counts. A gradient in
    another floating dtype than the weight's (a bfloat16 one under
    ``MXTPU_AMP=bf16``) is cast to the weight's first, so the update
    always runs in the master weight's precision, as in ``mxtpu``.
    Returns ``(weight, state_tree)``."""
    if grad.dtype != weight.dtype and grad.is_floating_point() and \
            weight.is_floating_point():
        grad = grad.to(weight.dtype)
    saved = optimizer._step_scalars
    optimizer._step_scalars = (t, lr)
    try:
        optimizer.update_multi_precision(index, NDArray(weight),
                                         NDArray(grad),
                                         tree_to_state(state_tree))
    finally:
        optimizer._step_scalars = saved
    return weight, state_tree


def _to_numpy(s):
    if isinstance(s, NDArray):
        return s.asnumpy()
    if isinstance(s, (tuple, list)):
        return type(s)(_to_numpy(x) for x in s)
    return s


def _from_numpy(s):
    if isinstance(s, _np.ndarray):
        return nd.array(s, ctx=cpu())
    if isinstance(s, (tuple, list)):
        return type(s)(_from_numpy(x) for x in s)
    return s


class Updater:
    """``updater(index, grad, weight)``: the optimizer's update with a
    state per index, created at the index's first update on the weight's
    context; :meth:`get_states` / :meth:`set_states` save and restore them
    (numpy inside a pickle)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def ensure_state(self, index, weight):
        """The state slot for ``index``, created or moved to the weight's
        context as ``__call__`` needs it."""
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            self.states[index] = self.sync_state_context(self.states[index],
                                                         weight.context)
            self.states_synced[index] = True
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update_multi_precision(
            index, weight, grad, self.ensure_state(index, weight))

    def sync_state_context(self, state, context):
        if isinstance(state, NDArray):
            return state.as_in_context(context)
        if isinstance(state, (tuple, list)):
            return type(state)(self.sync_state_context(s, context)
                               for s in state)
        return state

    def set_states(self, states):
        """Restore states written by :meth:`get_states`, in either
        package (``mxtpu``'s classes load as the port's:
        :mod:`~mxtpu_torch._unpickle`; a pickle runs code when loaded,
        so load only bytes of a program you trust)."""
        from ._unpickle import loads
        states = loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            states, self.optimizer = states
        self.states = {k: _from_numpy(v) for k, v in states.items()}
        self.states_synced = dict.fromkeys(self.states, False)

    def get_states(self, dump_optimizer=False):
        states = {k: _to_numpy(v) for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)


def get_updater(optimizer):
    """The optimizer as an :class:`Updater`."""
    return Updater(optimizer)

