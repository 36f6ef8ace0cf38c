"""SequentialModule of the PyTorch port
(``mxtpu/module/sequential_module.py``): modules chained head to tail,
each one's outputs the next one's data.

``add(module, take_labels=True)`` routes the iterator's labels to that
module (its ``update_metric`` is the chain's); ``auto_wiring=True``
renames the data it receives to its own ``data_names``. Every module
after the first binds with ``inputs_need_grad``, and ``backward`` runs
from the last module to the first, handing each one's input gradients to
the one before as its output gradients. So a later ``Module`` keeps its
eager step (the fused step declines ``inputs_need_grad``), and the
chain's ``forward_backward`` is a forward and a backward of each module,
as in ``mxtpu``.
"""
from __future__ import annotations

import copy
import logging

from ..initializer import Uniform
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    """A container of modules that run one after another."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}

    def add(self, module, **kwargs):
        """Append ``module`` with its meta flags (``take_labels``,
        ``auto_wiring``); returns the container, for chaining."""
        for key in kwargs:
            if key not in self._meta_keys:
                raise ValueError('Unknown meta "%s", a typo?' % key)
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    def _takes_labels(self, i):
        return bool(self._metas[i].get(self.META_TAKE_LABELS, False))

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        self._require_bound()
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        self._require_bound()
        return self._label_shapes

    @property
    def output_shapes(self):
        self._require_bound()
        return self._modules[-1].output_shapes

    def _require_bound(self, params=False, optimizer=False):
        if not self.binded:
            raise RuntimeError("call bind first")
        if params and not self.params_initialized:
            raise RuntimeError("call init_params first")
        if optimizer and not self.optimizer_initialized:
            raise RuntimeError("call init_optimizer first")

    def get_params(self):
        self._require_bound(params=True)
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return (arg_params, aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Initialize each module's parameters; two modules may not share
        a parameter name."""
        if self.params_initialized and not force_init:
            return
        self._require_bound()
        for module in self._modules:
            module.init_params(initializer=initializer,
                               arg_params=arg_params, aux_params=aux_params,
                               allow_missing=allow_missing,
                               force_init=force_init, allow_extra=allow_extra)
        owners = ({}, {})
        for i_layer, module in enumerate(self._modules):
            for known, names in zip(owners, module.get_params()):
                for name in names:
                    if name in known:
                        raise ValueError(
                            'Duplicated parameter names: name "%s" in layer '
                            '%d (%s) is already used in layer %d (%s).'
                            % (name, i_layer, type(module),
                               known[name],
                               type(self._modules[known[name]])))
                    known[name] = i_layer
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind each module to the previous one's output shapes (the
        first to ``data_shapes``); the modules after the first need their
        inputs' gradients when training."""
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if inputs_need_grad and not for_training:
            raise ValueError("inputs_need_grad needs for_training")
        if shared_module is not None:
            raise ValueError("Shared module is not supported")
        if not self._modules:
            raise ValueError("Attempting to bind an empty SequentialModule")
        self.binded = True
        self._label_shapes = label_shapes
        my_data_shapes = data_shapes
        anybody_needs_label = False
        for i_layer, module in enumerate(self._modules):
            if self._takes_labels(i_layer):
                my_label_shapes = label_shapes
                anybody_needs_label = True
            else:
                my_label_shapes = None
            my_inputs_need_grad = bool(for_training and
                                       (inputs_need_grad or i_layer > 0))
            if self._metas[i_layer].get(self.META_AUTO_WIRING, False):
                data_names = module.data_names
                if len(data_names) != len(my_data_shapes):
                    raise ValueError("auto_wiring: %d data names for %d "
                                     "inputs" % (len(data_names),
                                                 len(my_data_shapes)))
                my_data_shapes = [(new_name, shape) for new_name, (_, shape)
                                  in zip(data_names, my_data_shapes)]
            module.bind(data_shapes=my_data_shapes,
                        label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=my_inputs_need_grad,
                        force_rebind=force_rebind, shared_module=None,
                        grad_req=grad_req)
            my_data_shapes = module.output_shapes
        if not anybody_needs_label:
            self._label_shapes = None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._require_bound(params=True)
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        self._require_bound(params=True)
        data_batch = copy.copy(data_batch)
        for i_layer, module in enumerate(self._modules):
            module.forward(data_batch, is_train=is_train)
            if i_layer + 1 == len(self._modules):
                break
            data_batch.data = module.get_outputs()
            if getattr(data_batch, "provide_data", None) is not None:
                data_names = [x[0] for x in module.output_shapes]
                data_batch.provide_data = [
                    (name, x.shape)
                    for name, x in zip(data_names, data_batch.data)]

    def backward(self, out_grads=None):
        self._require_bound(params=True)
        for i_layer in reversed(range(len(self._modules))):
            module = self._modules[i_layer]
            module.backward(out_grads=out_grads)
            if i_layer == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        self._require_bound(params=True, optimizer=True)
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        self._require_bound(params=True)
        return self._modules[-1].get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require_bound(params=True)
        if not self.inputs_need_grad:
            raise RuntimeError("bound without inputs_need_grad")
        return self._modules[0].get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._require_bound(params=True)
        for i_layer, module in enumerate(self._modules):
            if self._takes_labels(i_layer):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        self._require_bound()
        for module in self._modules:
            module.install_monitor(mon)
