"""BucketingModule of the PyTorch port: one Module a bucket over one set
of parameters.

Counterpart of ``mxtpu/module/bucketing_module.py``: ``sym_gen(key)``
gives a bucket's ``(symbol, data_names, label_names)``; the default
bucket's module is bound first and every other bucket's module is bound
with it as ``shared_module``, so that all of them work on the default
bucket's parameter arrays (``Module.bind(shared_module=)``), and borrows
its optimizer (``Module.borrow_optimizer``), which on the fused path
makes every bucket a member of one fused group: one store, one set of
optimizer states, one step count and learning rate on the device, and
one CUDA graph a bucket. Every bucket works on that one store, so a
switch between buckets copies nothing, on the eager path as on the fused
one. A bucket whose parameter's shape follows the bucket cannot share it
and raises at its bind (``DataParallelExecutorGroup``).
"""
from __future__ import annotations

import logging
import warnings

from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """A module over bucketed (variable-shape) inputs."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise ValueError("default_bucket_key is required")
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        _symbol, data_names, label_names = sym_gen(default_bucket_key)
        mutable = (list(data_names or []) + list(label_names or []) +
                   list(state_names or []))
        fixed_param_names = fixed_param_names or []
        for name in fixed_param_names:
            if name in mutable:
                raise ValueError("fixed parameter %r is an input" % name)
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names or []
        self._context = context
        self._work_load_list = work_load_list
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._monitor = None
        self._grad_req = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    def _require(self, params=False, optimizer=False):
        if not self.binded:
            raise RuntimeError("call bind first")
        if params and not self.params_initialized:
            raise RuntimeError("call init_params first")
        if optimizer and not self.optimizer_initialized:
            raise RuntimeError("call init_optimizer first")

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        self._require()
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        self._require()
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        self._require()
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        self._require()
        return self._curr_module.symbol

    # -- params ------------------------------------------------------------
    def get_params(self):
        self._require(params=True)
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init="
                          "False. set_params call ignored.", stacklevel=2)
            return
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init,
                                     allow_extra=allow_extra)
        self._params_dirty = True
        self.params_initialized = True

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise RuntimeError("call bind before initializing the "
                               "parameters")
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init,
                                      allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    # -- bind --------------------------------------------------------------
    def _module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context,
                      work_load_list=self._work_load_list,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket's module."""
        if shared_module is not None:
            raise ValueError("shared_module for BucketingModule is not "
                             "supported")
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._grad_req = grad_req
        module = self._module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False, shared_module=None,
                    grad_req=self._grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module the current one, binding it on the
        default bucket's parameters (and lending it the optimizer) at its
        first use."""
        self._require()
        if bucket_key not in self._buckets:
            default = self._buckets[self._default_bucket_key]
            module = self._module(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False, shared_module=default,
                        grad_req=self._grad_req)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            if self.optimizer_initialized:
                module.borrow_optimizer(default)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    # -- computation -------------------------------------------------------
    def forward_backward(self, data_batch):
        """One train step on the batch's bucket (on the fused path one
        replay of the bucket's graph after its first two batches)."""
        self._require(params=True)
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward_backward(data_batch)

    def forward(self, data_batch, is_train=None):
        self._require(params=True)
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._require(params=True)
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._require(params=True, optimizer=True)
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        self._require(params=True)
        return self._curr_module.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require(params=True)
        if not self.inputs_need_grad:
            raise RuntimeError("bound without inputs_need_grad")
        return self._curr_module.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._require(params=True)
        self._curr_module.update_metric(eval_metric, labels)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Install the optimizer on the current bucket and lend it to
        every other bucket bound so far."""
        self._require(params=True)
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Ready the batch on its bucket's module (a switch there and
        back that copies no parameters)."""
        self._require()
        original = self._curr_bucket_key
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.prepare(data_batch,
                                  sparse_row_id_fn=sparse_row_id_fn)
        self.switch_bucket(original, None, None)

    def save_optimizer_states(self, fname):
        """The buckets' one Updater's states (the current module's)."""
        self._require(optimizer=True)
        self._curr_module.save_optimizer_states(fname)

    def load_optimizer_states(self, fname):
        self._require(optimizer=True)
        self._curr_module.load_optimizer_states(fname)

    def get_states(self, merge_multi_context=True):
        self._require(params=True)
        return self._curr_module.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        self._require(params=True)
        self._curr_module.set_states(states, value)

    def install_monitor(self, mon):
        self._require()
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)
