"""Module of the PyTorch port: training and inference over a Symbol.

Counterpart of ``mxtpu/module/module.py``'s eager step: ``bind``,
``init_params`` (host copies of the parameters, drawn or given, then
copied to the context), ``init_optimizer`` (``rescale_grad`` = 1/batch;
the optimizer runs at the kvstore when one updates there, else in the
module's Updater), ``forward`` / ``backward`` / ``update`` /
``update_metric``, ``get_params`` / ``set_params``, ``reshape``,
``bind(shared_module=)`` and ``borrow_optimizer`` (a bucketing module's
buckets: one set of parameter arrays, one optimizer) and the checkpoint
pair ``save_checkpoint`` / ``load``. The context defaults to the current
one, ``gpu(0)``.

Fused train step (``MXTPU_MODULE_FUSED``, default on, as in ``mxtpu``):
on one context with the optimizer in the module's Updater,
``forward_backward`` runs forward, backward, the whole update and the
metric's device (sum, count) as one step (``module/fused.py``), on the
card as one CUDA graph replayed a batch; ``update()`` acknowledges it
and ``update_metric`` adds nothing on the host. ``get_outputs()`` then
returns the step's outputs, which the next step overwrites. Everything
else, and ``MXTPU_MODULE_FUSED=0``, takes the eager step: a forward, a
backward and one update a parameter.
"""
from __future__ import annotations

import logging
import warnings

import numpy as _np
import torch

from .. import context as ctx_mod
from .. import ndarray as nd
from .. import optimizer as opt
from ..context import cpu
from ..initializer import InitDesc, Uniform
from ..io import stage_batch
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint)
from ..ndarray import NDArray
from . import fused as fused_mod
from .base_module import BaseModule, _check_input_names, _parse_data_desc
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]

_ALREADY_INIT = ("%s already initialized and force_init=False. "
                 "%s call ignored.")


def _fill_from(dst, src):
    """Copy a given parameter (an NDArray of either package, or an array)
    into host array ``dst``."""
    if isinstance(src, NDArray):
        value = src.data
    else:
        value = torch.as_tensor(_np.asarray(
            src.asnumpy() if hasattr(src, "asnumpy") else src))
    with torch.no_grad():
        dst.data.copy_(value)


class Module(BaseModule):
    """A Symbol bound for training or inference on its contexts."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        ctxs = context if context is not None else ctx_mod.current_context()
        self._context = [ctxs] if isinstance(ctxs, ctx_mod.Context) \
            else list(ctxs)
        self._work_load_list = (work_load_list if work_load_list is not None
                                else [1] * len(self._context))
        if len(self._work_load_list) != len(self._context):
            raise ValueError("one work load a context")
        self._symbol = symbol
        name_groups = {
            "data": list(data_names or []),
            "label": list(label_names or []),
            "state": list(state_names or []),
            "fixed_param": list(fixed_param_names or []),
        }
        for kind, names in name_groups.items():
            _check_input_names(symbol, names, kind, kind != "label")
        self._data_names = name_groups["data"]
        self._label_names = name_groups["label"]
        self._state_names = name_groups["state"]
        self._fixed_param_names = name_groups["fixed_param"]
        # every argument that the iterator does not feed is a parameter
        fed = set(self._data_names + self._label_names + self._state_names)
        self._param_names = [a for a in symbol.list_arguments()
                             if a not in fed]
        self._aux_names = list(symbol.list_auxiliary_states())
        self._output_names = list(symbol.list_outputs())
        self._arg_params = self._aux_params = None
        self._params_dirty = False
        self._optimizer = self._kvstore = self._updater = None
        self._update_on_kvstore = self._preload_opt_states = None
        self._grad_req = None
        self._exec_group = self._data_shapes = self._label_shapes = None
        # fused train step (module/fused.py), made by init_optimizer
        self._fused = None
        self._fused_update_pending = False

    def _require(self, params=False, optimizer=False):
        if not self.binded:
            raise RuntimeError("call bind first")
        if params and not self.params_initialized:
            raise RuntimeError("call init_params first")
        if optimizer and not self.optimizer_initialized:
            raise RuntimeError("call init_optimizer first")

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module from a checkpoint (``prefix-symbol.json`` and
        ``prefix-%04d.params``, written by either package); the parameters
        are copied to the context at bind."""
        sym, args, auxs = load_checkpoint(prefix, epoch, ctx=cpu())
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Save ``prefix-symbol.json``, ``prefix-%04d.params`` (and the
        optimizer's states)."""
        self._symbol.save("%s-symbol.json" % prefix)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        logging.info('Saved checkpoint to "%s"', param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info('Saved optimizer state to "%s"', state_name)

    def _reset_bind(self):
        self.binded = False
        self._exec_group = self._data_shapes = self._label_shapes = None
        self._fused = None
        self._fused_update_pending = False

    # -- properties --------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        self._require()
        return self._data_shapes

    @property
    def label_shapes(self):
        self._require()
        return self._label_shapes

    @property
    def output_shapes(self):
        self._require()
        outputs = self._exec_group.get_outputs()
        if outputs:
            return list(zip(self._output_names, [o.shape for o in outputs]))
        known = {name: shape for name, shape in
                 (self._data_shapes or []) + (self._label_shapes or [])}
        _, out_shapes, _ = self._symbol.infer_shape(**known)
        return list(zip(self._output_names, out_shapes))

    # -- params ------------------------------------------------------------
    def get_params(self):
        """The host copies ``(arg_params, aux_params)``, brought up to the
        devices' values first."""
        self._require(params=True)
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Fill the host copies (a given value wins, else the initializer
        draws one on the CPU), then copy them to the executors."""
        if self.params_initialized and not force_init:
            warnings.warn(_ALREADY_INIT % ("Parameters", "init_params"),
                          stacklevel=2)
            return
        if not self.binded:
            raise RuntimeError("call bind before initializing the "
                               "parameters")

        def host_mirror(names, group_arrays):
            return {name: nd.zeros(arr[0].shape, ctx=cpu(),
                                   dtype=arr[0].dtype)
                    for name, arr in zip(names, group_arrays)}

        if self._arg_params is None:
            self._arg_params = host_mirror(self._param_names,
                                           self._exec_group.param_arrays)
        if self._aux_params is None:
            self._aux_params = host_mirror(self._aux_names,
                                           self._exec_group.aux_arrays)
        attrs = self._symbol.attr_dict()

        def fill(desc, arr, provided):
            if provided is None:
                if initializer is not None:
                    initializer(desc, arr)
            elif desc in provided:
                if provided[desc] is not arr:
                    _fill_from(arr, provided[desc])
            elif not allow_missing:
                raise RuntimeError("%s is not presented" % desc)
            elif initializer is not None:
                initializer(desc, arr)

        for table, provided in ((self._arg_params, arg_params),
                                (self._aux_params, aux_params)):
            for name in sorted(table):
                fill(InitDesc(name, attrs.get(name)), table[name], provided)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=allow_extra)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        """Set the parameters to the given values."""
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            warnings.warn(_ALREADY_INIT % ("Parameters", "set_params"),
                          stacklevel=2)
            return
        self._exec_group.set_params(arg_params, aux_params,
                                    allow_extra=allow_extra)
        self._params_dirty = True
        self.params_initialized = True

    # -- bind --------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind one executor a context for these input shapes."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if inputs_need_grad and not for_training:
            raise ValueError("inputs_need_grad needs for_training")
        self.for_training, self.inputs_need_grad = (for_training,
                                                    inputs_need_grad)
        self._grad_req = grad_req
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self.data_names, self.label_names, data_shapes, label_shapes)
        shared_group = None
        if shared_module is not None:
            if not isinstance(shared_module, Module):
                raise TypeError("shared_module must be a Module")
            shared_module._require(params=True)
            shared_group = shared_module._exec_group
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group,
            fixed_param_names=self._fixed_param_names,
            grad_req=grad_req, state_names=self._state_names)
        self.binded = True
        if shared_module is not None:
            # the executors work on the shared module's parameter arrays,
            # and the host copies are its too
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self._params_dirty = shared_module._params_dirty
            self.params_initialized = True
        elif self._arg_params is not None:
            # parameters loaded before bind (Module.load)
            self._exec_group.set_params(self._arg_params, self._aux_params,
                                        allow_extra=True)
            self.params_initialized = True

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind for new input shapes. The executors of the new shapes
        (found again if bound before) work on the same parameter arrays,
        so nothing is copied."""
        self._require()
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self.data_names, self.label_names, data_shapes, label_shapes)
        self._exec_group.reshape(self._data_shapes, self._label_shapes)

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Install the optimizer: at the kvstore when it updates there,
        else in this module's Updater (slot ``i * num_device + k``);
        ``rescale_grad`` defaults to 1/batch."""
        self._require(params=True)
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, "
                                "ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        batch_size = self._exec_group.batch_size
        if kvstore and "dist" in kvstore.type and "_sync" in kvstore.type:
            batch_size *= kvstore.num_workers
        rescale_grad = 1.0 / batch_size
        names = self._exec_group.param_names
        n_dev = len(self._context)
        if update_on_kvstore:
            idx2name = dict(enumerate(names))
        else:
            idx2name = {i * n_dev + k: n
                        for i, n in enumerate(names) for k in range(n_dev)}
        if isinstance(optimizer, str):
            conf = dict(optimizer_params)
            conf.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name, **conf)
        else:
            if not isinstance(optimizer, opt.Optimizer):
                raise TypeError("optimizer must be a name or an Optimizer")
            if optimizer.rescale_grad != rescale_grad:
                warnings.warn(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size/"
                    "num_workers (%s vs. %s). Is this intended?" % (
                        optimizer.rescale_grad, rescale_grad), stacklevel=2)
            if not optimizer.idx2name:
                optimizer.idx2name = idx2name.copy()
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        if kvstore:
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._param_names,
                                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            self._updater = None
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None
        self._fused = fused_mod.maybe_create(self)

    def borrow_optimizer(self, shared_module):
        """Share ``shared_module``'s optimizer, kvstore and Updater (a
        bucketing module's buckets), and join its fused step's group: one
        parameter store, one set of optimizer states, one step count."""
        if not shared_module.optimizer_initialized:
            raise RuntimeError("the lender has no optimizer yet")
        for attr in ("_optimizer", "_kvstore", "_update_on_kvstore",
                     "_updater"):
            setattr(self, attr, getattr(shared_module, attr))
        self.optimizer_initialized = True
        self._fused = fused_mod.attach_borrowed(self, shared_module)

    # -- computation -------------------------------------------------------
    def forward_backward(self, data_batch):
        """One train step: on the fused path one step covering forward,
        backward, the update and the metric, which ``update()`` then
        acknowledges; else a forward and a backward."""
        if self._fused is not None and self._fused.step(data_batch):
            self._fused_update_pending = True
            return
        self.forward(data_batch, is_train=True)
        self.backward()

    def forward(self, data_batch, is_train=None):
        """Forward of a batch; a batch of other shapes rebinds first."""
        self._require(params=True)
        if self._fused is not None:
            self._fused.note_eager_forward()
        curr_data_shapes = tuple(i.shape for i in self._data_shapes)
        new_data_shapes = tuple(i.shape for i in data_batch.data)
        if curr_data_shapes != new_data_shapes:
            self.reshape(*self._shapes_for_batch(data_batch,
                                                 new_data_shapes))
        self._exec_group.forward(data_batch, is_train)

    def _shapes_for_batch(self, data_batch, new_data_shapes):
        def redescribe(descs, shapes):
            return [type(d)(d.name, s) if hasattr(d, "name") else (d[0], s)
                    for d, s in zip(descs, shapes)]
        if getattr(data_batch, "provide_data", None):
            new_dshape = data_batch.provide_data
        else:
            new_dshape = redescribe(self._data_shapes, new_data_shapes)
        if getattr(data_batch, "provide_label", None):
            new_lshape = data_batch.provide_label
        elif getattr(data_batch, "label", None):
            new_lshape = redescribe(self._label_shapes,
                                    [j.shape for j in data_batch.label])
        else:
            new_lshape = None
        return new_dshape, new_lshape

    def backward(self, out_grads=None):
        self._require(params=True)
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Apply the optimizer to the last backward's gradients."""
        self._require(params=True, optimizer=True)
        self._params_dirty = True
        if self._fused_update_pending:
            # the fused step applied this update already
            self._fused_update_pending = False
            return
        group = self._exec_group
        if self._update_on_kvstore:
            _update_params_on_kvstore(group.param_arrays, group.grad_arrays,
                                      self._kvstore, group.param_names)
        else:
            _update_params(group.param_arrays, group.grad_arrays,
                           self._updater, len(self._context),
                           kvstore=self._kvstore,
                           param_names=group.param_names)

    def get_outputs(self, merge_multi_context=True):
        self._require(params=True)
        return self._exec_group.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require(params=True)
        return self._exec_group.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        if self._fused is not None and self._fused.note_metric(eval_metric):
            return  # the fused step added the batch on the device
        self._exec_group.update_metric(eval_metric, labels)

    def _sync_params_from_devices(self):
        """Bring the host copies up to the devices' (and the kvstore's)
        values."""
        self._exec_group.get_params(self._arg_params, self._aux_params)
        if self._kvstore and self._update_on_kvstore:
            for param_name, param_val in sorted(self._arg_params.items()):
                self._kvstore.pull(param_name, param_val)
        self._params_dirty = False

    def save_optimizer_states(self, fname):
        if not self.optimizer_initialized:
            raise RuntimeError("call init_optimizer first")
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if not self.optimizer_initialized:
            raise RuntimeError("call init_optimizer first")
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def install_monitor(self, mon):
        """Attach a monitor (its ``install(executor)``) to the executors;
        the fused step gives way to the eager one."""
        self._require()
        self._exec_group.install_monitor(mon)

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Queue the batch's copy to the (one) context ahead of its step."""
        self._require()
        if len(self._context) == 1:
            stage_batch(data_batch, self._context[0])
