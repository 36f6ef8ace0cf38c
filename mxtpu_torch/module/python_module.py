"""PythonModule and PythonLossModule of the PyTorch port
(``mxtpu/module/python_module.py``): modules whose computation is the
user's Python.

``PythonModule`` holds no parameters and binds to the shapes it is given;
a subclass computes its output shapes and its forward and backward.
``PythonLossModule`` is a loss layer: its output is its input scores, and
its backward hands ``grad_func(scores, labels)`` (the port's NDArrays in,
an NDArray or a numpy array out, placed on the scores' context) to the
module before it as that module's output gradient. Its
``update_metric`` feeds the metric its labels and scores, as upstream
MXNet's does, where ``mxtpu``'s raises NotImplementedError once the
module takes labels.
"""
from __future__ import annotations

import logging

from .. import ndarray as nd
from ..initializer import Uniform
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """A module computed in Python; subclasses give
    ``_compute_output_shapes``, ``forward``, ``backward`` and
    ``get_outputs``."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names) \
            if label_names is not None else None
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return ({}, {})

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        """Feed the metric the labels and this module's outputs, if it
        takes labels; else nothing (it computes no predictions)."""
        if self._label_shapes is None:
            return
        eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if grad_req != "write":
            raise ValueError("a PythonModule supports grad_req='write' "
                             "only")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """A loss layer: forward passes the scores through; backward computes
    their gradient by ``grad_func(scores, labels)``."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        if len(data_names) != 1 or len(label_names) != 1:
            raise ValueError("a loss module takes one data and one label")
        if grad_func is not None and not callable(grad_func):
            raise TypeError("grad_func must be callable")
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise ValueError("For a loss module, out_grads should be None")
        if not self.for_training:
            raise RuntimeError("bound for inference")
        self._backward_impl()

    def _backward_impl(self):
        if self._grad_func is None:
            raise NotImplementedError()
        grad = self._grad_func(self._scores, self._labels)
        if not isinstance(grad, nd.NDArray):
            grad = nd.array(grad, ctx=self._scores.context)
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
