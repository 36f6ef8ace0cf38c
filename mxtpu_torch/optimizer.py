"""Optimizers of the PyTorch port.

Counterpart of ``mxtpu/optimizer.py``'s ``Optimizer`` (registry and
``create``, per-parameter lr / wd multipliers from ``set_lr_mult`` /
``set_wd_mult``, the symbol's ``__lr_mult__`` / ``__wd_mult__`` and
``param_dict``, ``rescale_grad``, ``clip_gradient``, ``lr_scheduler``,
``multi_precision``'s float32 master weights for float16 ones, update
counts),
``SGD`` (momentum and weight decay, the dense path), ``Adam``, and the
``Updater`` with ``get_states`` / ``set_states``.

An update runs in place on the weight's and the state's tensors under
``torch.no_grad()``, in ``mxtpu``'s order of operations (rescale, clip,
add ``wd * weight``, then the rule), so the tensors bound to an executor
stay the same from step to step.

:func:`functional_optimizer_step` runs the same ``update`` with the step
count ``t`` and the learning rate read from 0-dim tensors on the
weight's device (``mxtpu``'s traced scalars), so that a step captured in
a CUDA graph sees the schedule and Adam's bias correction move between
replays; ``state_to_tree`` / ``tree_to_state`` convert a state slot
between NDArrays and tensors.
"""
from __future__ import annotations

import pickle
import warnings

import numpy as _np
import torch

from . import ndarray as nd
from .context import cpu
from .ndarray import NDArray

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "create", "register",
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
        return self.multi_precision and weight.dtype == torch.float16

    def create_state_multi_precision(self, index, weight):
        """The state of ``index``: under ``multi_precision`` a float16
        weight's is ``(float32 master copy, the master's state)``; any
        other weight's is :meth:`create_state`'s."""
        if self._uses_master_weights(weight):
            master = weight.astype(_np.float32)
            return (master, self.create_state(index, master))
        if weight.dtype == torch.float16:
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
            weight.data.copy_(master.data)

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


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum`` > 0:
    mom = momentum * mom - lr * g; weight += mom."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        lr, wd = self._begin_update(index)
        with torch.no_grad():
            w = weight.data
            g = self._rescale_clip(grad.data, w, wd)
            if state is not None:
                mom = state.data
                mom.mul_(self.momentum).sub_(lr * g)
                w.add_(mom)
            else:
                w.sub_(lr * g)


@register
class Adam(Optimizer):
    """Adam with ``mxtpu``'s bias correction folded into the rate."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype),
                nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype))

    def update(self, index, weight, grad, state):
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
            w = weight.data
            mean, var = state[0].data, state[1].data
            g = self._rescale_clip(grad.data, w, wd)
            mean.mul_(self.beta1).add_((1.0 - self.beta1) * g)
            var.mul_(self.beta2).add_((1.0 - self.beta2) * g.square())
            w.sub_(lr * mean / (var.sqrt() + self.epsilon))


def state_to_tree(state):
    """A state slot (None, an NDArray, or tuples of them) as tensors."""
    if state is None:
        return None
    if isinstance(state, NDArray):
        return state.data
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
    caller keeps ``num_update`` and the slots' counts. Returns ``(weight,
    state_tree)``."""
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
        """Restore states written by :meth:`get_states` (bytes this
        program wrote: a pickle runs code when loaded)."""
        states = pickle.loads(states)
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

