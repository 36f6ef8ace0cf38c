"""Data-parallel executor group of the PyTorch port.

Counterpart of ``mxtpu/module/executor_group.py``: one executor a
context, each bound to its slice of the batch; the group copies a
batch's arrays into the executors' input arrays, runs forward and
backward on each, gathers outputs and feeds the metric.

The parameter store. The first executors the group binds (or those of a
``shared_group``, a bucketing module's default bucket) hold the
parameter and aux arrays, one set a context; every executor bound later
aliases them (:meth:`Executor.adopt_arrays`). A rebind for other input
shapes keeps the executors it bound before, one set a signature (data
and label shapes and dtypes), and finds them again when the shapes come
back; so a rebind copies no parameter, and a CUDA graph captured over an
executor's tensors stays valid for that signature.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import ndarray as nd
from ..context import cpu
from ..io import DataDesc
from ..ndarray import NDArray

__all__ = ["DataParallelExecutorGroup"]


def _split_input_slice(batch_size, work_load_list):
    """Slices of the batch in proportion to the work loads."""
    total = sum(work_load_list)
    counts = [round(batch_size * (float(w) / total)) for w in work_load_list]
    counts[-1] += batch_size - sum(counts)
    slices, start = [], 0
    for n in counts:
        slices.append(slice(start, start + int(n)))
        start += int(n)
    return slices


def _rows(arr, islice):
    """``arr``'s tensor, cut to ``islice`` along axis 0 unless the slice
    covers it."""
    t = arr.data
    if islice.start == 0 and islice.stop == t.shape[0]:
        return t
    return t[islice]


def _load_general(data, targets):
    """Copy each batch array (or its slice) into the executors' arrays."""
    with torch.no_grad():
        for d_src, d_targets in zip(data, targets):
            for islice, d_dst in d_targets:
                src = d_src.data if d_src.shape[0] == d_dst.shape[0] \
                    else _rows(d_src, islice)
                d_dst.data.copy_(src, non_blocking=d_dst.data.is_cuda)


class DataParallelExecutorGroup:
    """Executors, one a context, each on its slice of the batch."""

    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, fixed_param_names=None, grad_req="write",
                 state_names=None):
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload if workload else [1] * len(contexts)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = fixed_param_names or []
        self.state_names = state_names or []
        if not for_training:
            grad_req = "null"
        data_names = [x.name if isinstance(x, DataDesc) else x[0]
                      for x in data_shapes]
        if isinstance(grad_req, str):
            self.grad_req = {}
            for k in self.arg_names:
                if k in self.param_names:
                    self.grad_req[k] = "null" \
                        if k in self.fixed_param_names else grad_req
                elif k in data_names:
                    self.grad_req[k] = grad_req if inputs_need_grad \
                        else "null"
                else:
                    self.grad_req[k] = "null"
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        elif isinstance(grad_req, dict):
            self.grad_req = {k: "null" for k in self.arg_names}
            self.grad_req.update(grad_req)
        else:
            raise ValueError("invalid grad_req")
        self.execs = []
        self.data_shapes = self.label_shapes = None
        self.data_layouts = self.label_layouts = None
        self.output_layouts = [
            DataDesc.get_batch_axis(self.symbol[i].attr("__layout__"))
            for i in range(len(self.symbol.list_outputs()))]
        # executors by signature, and the (params, aux) store a context
        self._bound = {}
        self._stores = None if shared_group is None \
            else list(shared_group._stores)
        self.bind_exec(data_shapes, label_shapes)

    def decide_slices(self, data_shapes):
        """The batch axis of each input; sets ``batch_size`` and the
        contexts' slices."""
        major_axis = [DataDesc.get_batch_axis(getattr(x, "layout", "NCHW"))
                      for x in data_shapes]
        for desc, axis in zip(data_shapes, major_axis):
            if axis == -1:
                continue
            batch_size = desc.shape[axis]
            if self.batch_size is not None:
                if batch_size != self.batch_size:
                    raise ValueError(
                        "all data must have the same batch size: batch_size"
                        " = %d, but %s has shape %s"
                        % (self.batch_size, desc.name, desc.shape))
            else:
                self.batch_size = batch_size
                self.slices = _split_input_slice(self.batch_size,
                                                 self.workload)
        return major_axis

    @staticmethod
    def _signature(data_shapes, label_shapes):
        """The input names, shapes and dtypes that an executor is bound
        for (a dtype given as a class, a name or a numpy dtype alike)."""
        return tuple((x.name, tuple(x.shape),
                      _np.dtype(getattr(x, "dtype", _np.float32)).name)
                     for x in list(data_shapes) + list(label_shapes or []))

    def bind_exec(self, data_shapes, label_shapes):
        """One executor a context on its slice's shapes: those bound
        before for the same signature (reseeded, as binding anew would
        be), else new ones; either way on the group's parameter store."""
        self.batch_size = None
        self.data_layouts = self.decide_slices(data_shapes)
        if label_shapes is not None:
            self.label_layouts = self.decide_slices(label_shapes)
        sig = self._signature(data_shapes, label_shapes)
        execs = self._bound.get(sig)
        if execs is None:
            execs = []
            for i, ctx in enumerate(self.contexts):
                descs = self._sliced_shape(data_shapes, i,
                                           self.data_layouts)
                if label_shapes is not None:
                    descs += self._sliced_shape(label_shapes, i,
                                                self.label_layouts)
                execs.append(self.symbol.simple_bind(
                    ctx=ctx, grad_req=self.grad_req,
                    **{x.name: x.shape for x in descs}))
            self._bound[sig] = execs
        else:
            for exec_ in execs:
                exec_.reseed()
        self.execs = execs
        if self._stores is None:
            self._stores = [
                ({n: e.arg_dict[n] for n in self.param_names
                  if n in e.arg_dict},
                 {n: e.aux_dict[n] for n in self.aux_names})
                for e in execs]
        self._adopt()
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.data_names = [x.name for x in data_shapes]
        if label_shapes is not None:
            self.label_names = [x.name for x in label_shapes]
        self._collect_arrays()

    def _adopt(self):
        """Alias the executors to the store. A parameter whose shape
        follows the inputs' cannot be shared and raises here, at the bind
        (``mxtpu`` fails later, at the step, where the store's weights do
        not fit the data)."""
        for exec_, (params, aux) in zip(self.execs, self._stores):
            exec_.adopt_arrays(params, aux)
            for table, store in ((exec_.arg_dict, params),
                                 (exec_.aux_dict, aux)):
                for name, arr in store.items():
                    if name in table and table[name] is not arr:
                        raise ValueError(
                            "parameter %r has shape %s for these inputs, "
                            "%s in the bound store" % (
                                name, tuple(table[name].shape),
                                tuple(arr.shape)))

    def reshape(self, data_shapes, label_shapes):
        if data_shapes == self.data_shapes and \
                label_shapes == self.label_shapes:
            return
        self.bind_exec(data_shapes, label_shapes)

    def adopt_store(self, param_store, aux_store):
        """Alias every executor's parameter and aux slots, now and after
        every rebind, to the given arrays (``mxtpu``'s ``adopt_store``;
        the fused step's group store, one context)."""
        self._stores = [(param_store, aux_store)] * len(self.contexts)
        self._adopt()
        self._collect_arrays()

    def _sliced_shape(self, shapes, i, major_axis):
        sliced = []
        for desc, axis in zip(shapes, major_axis):
            shape = list(desc.shape)
            if axis >= 0:
                shape[axis] = self.slices[i].stop - self.slices[i].start
            sliced.append(DataDesc(desc.name, tuple(shape),
                                   getattr(desc, "dtype", _np.float32),
                                   getattr(desc, "layout", "NCHW")))
        return sliced

    def _collect_arrays(self):
        def per_exec(name, table="arg_dict"):
            return [getattr(e, table).get(name) for e in self.execs]
        self.data_arrays = [list(zip(self.slices, per_exec(n)))
                            for n in self.data_names]
        self.label_arrays = None if self.label_shapes is None else [
            list(zip(self.slices, per_exec(n))) for n in self.label_names
            if n in self.execs[0].arg_dict]
        params = [n for n in self.param_names if n in self.arg_names]
        self.param_arrays = [per_exec(n) for n in params]
        self.grad_arrays = [per_exec(n, "grad_dict") for n in params] \
            if self.for_training else None
        self.aux_arrays = [per_exec(n, "aux_dict") for n in self.aux_names]
        self.input_grad_arrays = [per_exec(n, "grad_dict")
                                  for n in self.data_names] \
            if self.inputs_need_grad else None
        self.state_arrays = [per_exec(n) for n in self.state_names]

    # -- params ------------------------------------------------------------
    def set_params(self, arg_params, aux_params, allow_extra=False):
        for exec_ in self.execs:
            exec_.copy_params_from(arg_params, aux_params,
                                   allow_extra_params=allow_extra)

    @staticmethod
    def _device_mean(block):
        """The mean of a parameter's copies on the devices, on the
        first one's device."""
        acc = block[0].data
        if len(block) > 1:
            acc = sum(b.data.to(acc.device) for b in block) / len(block)
        return acc

    def get_params(self, arg_params, aux_params):
        """Put host copies of the devices' parameters (their mean over
        devices) into the dicts, as new arrays of the entries' dtypes."""
        for table, names, blocks in ((arg_params, self.param_names,
                                      self.param_arrays),
                                     (aux_params, self.aux_names,
                                      self.aux_arrays)):
            for name, block in zip(names, blocks):
                value = self._device_mean(block).detach()
                dtype = table[name].dtype if name in table else value.dtype
                table[name] = NDArray(value.to("cpu", dtype, copy=True),
                                      cpu())

    # -- execution ---------------------------------------------------------
    def load_batch(self, data_batch):
        """Copy a batch into the executors' input arrays."""
        _load_general(data_batch.data, self.data_arrays)
        if self.label_arrays is not None and data_batch.label:
            _load_general(data_batch.label, self.label_arrays)

    def forward(self, data_batch, is_train=None):
        self.load_batch(data_batch)
        if is_train is None:
            is_train = self.for_training
        for exec_ in self.execs:
            exec_.forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise RuntimeError("re-bind with for_training=True to run "
                               "backward")
        for i, exec_ in enumerate(self.execs):
            if out_grads is None:
                exec_.backward()
                continue
            mine = []
            for grad, axis in zip(out_grads, self.output_layouts):
                t = grad.data
                if axis >= 0:
                    t = t.narrow(axis, self.slices[i].start,
                                 self.slices[i].stop - self.slices[i].start)
                mine.append(NDArray(t, grad.context).as_in_context(
                    self.contexts[i]))
            exec_.backward(out_grads=mine)

    def get_outputs(self, merge_multi_context=True, begin=0, end=None):
        if end is None:
            end = len(self.execs[0].outputs)
        outputs = [[exec_.outputs[i] for exec_ in self.execs]
                   for i in range(begin, end)]
        if merge_multi_context:
            outputs = _merge_multi_context(outputs, self.output_layouts)
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise RuntimeError("bound without inputs_need_grad")
        if merge_multi_context:
            return _merge_multi_context(self.input_grad_arrays,
                                        self.data_layouts)
        return self.input_grad_arrays

    def get_states(self, merge_multi_context=True):
        """The state inputs' arrays, one list (a array a context) a
        state."""
        if merge_multi_context:
            raise ValueError("merge_multi_context=True is not supported "
                             "for get_states yet.")
        return self.state_arrays

    def set_states(self, states=None, value=None):
        """Copy ``states`` (as :meth:`get_states` gives them) into the
        state arrays, or fill them with ``value``; one of the two."""
        if (states is None) == (value is None):
            raise ValueError("give one of states and value")
        with torch.no_grad():
            for i, d_dst in enumerate(self.state_arrays):
                for k, dst in enumerate(d_dst):
                    if states is None:
                        dst.data.fill_(value)
                    else:
                        src = states[i][k] if isinstance(
                            states[i], (list, tuple)) else states[i]
                        dst.data.copy_(src.data if isinstance(src, NDArray)
                                       else torch.as_tensor(src))

    def install_monitor(self, mon):
        for exe in self.execs:
            mon.install(exe)

    def update_metric(self, eval_metric, labels):
        """Feed each executor's outputs and its slice of the labels to the
        metric."""
        for exec_, islice in zip(self.execs, self.slices):
            mine = []
            for label, axis in zip(labels, self.label_layouts or
                                   [0] * len(labels)):
                if axis == 0:
                    mine.append(NDArray(_rows(label, islice), label.context))
                elif axis > 0:
                    mine.append(NDArray(label.data.narrow(
                        axis, islice.start, islice.stop - islice.start),
                        label.context))
                else:
                    mine.append(label)
            eval_metric.update(mine, exec_.outputs)


def _merge_multi_context(outputs, major_axis):
    """Concatenate the devices' outputs along the batch axis."""
    rets = []
    for tensors, axis in zip(outputs, major_axis):
        if len(tensors) == 1 or axis < 0:
            rets.append(tensors[0])
        else:
            rets.append(nd.concatenate(tensors, axis=axis))
    return rets
