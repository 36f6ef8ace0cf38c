"""Gluon Trainer of the PyTorch port.

Counterpart of ``mxtpu/gluon/trainer.py``: applies an optimizer to a set
of Parameters after ``autograd.backward``. ``step(batch_size)`` sets
``rescale_grad`` to ``scale / batch_size`` and updates each parameter
through the port's ``Updater``, in place on the weight's tensor, so a
hybridized block's captured graph keeps reading the weights it was
captured on. As in ``mxtpu``'s single-device path, the kvstore
(``"device"`` and ``"local"`` make the port's local store) is created
and not used for the update: the gradients live on one card.
"""
from __future__ import annotations

from .. import kvstore as kvs
from .. import optimizer as opt
from .parameter import ParameterDict, Parameter

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be a list/dict of Parameters")
        self._params = []
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError("invalid parameter %r" % p)
            if p.grad_req != "null":
                self._params.append(p)
        optimizer_params = dict(optimizer_params or {})
        self._scale = optimizer_params.get("rescale_grad", 1.0)
        self._compression_params = compression_params
        self._init_optimizer(optimizer, optimizer_params)
        self._kv_initialized = False
        self._kvstore_arg = kvstore
        self._kvstore = None
        self._update_on_kvstore = update_on_kvstore

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: p for i, p in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError(
                    "optimizer_params must be empty when optimizer is an "
                    "Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = param_dict
        self._updaters = [opt.get_updater(self._optimizer)]

    def _init_kvstore(self):
        if isinstance(self._kvstore_arg, str):
            self._kvstore = kvs.create(self._kvstore_arg) \
                if self._kvstore_arg else None
        else:
            self._kvstore = self._kvstore_arg
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale the gradients by ``1 / batch_size`` and update."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Nothing to reduce on one card; creates the kvstore once, as
        ``mxtpu`` does."""
        if not self._kv_initialized:
            self._init_kvstore()

    def update(self, batch_size, ignore_stale_grad=False):
        updater = self._updaters[0]
        for i, p in enumerate(self._params):
            updater(i, p.grad(), p.data())

    def save_states(self, fname):
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states(dump_optimizer=False))

    def load_states(self, fname):
        """Restore states that :meth:`save_states` wrote (a pickle: load
        only files this program wrote)."""
        with open(fname, "rb") as f:
            states = f.read()
        for u in self._updaters:
            u.set_states(states)
