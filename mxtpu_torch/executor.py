"""Executor of the PyTorch port: a bound symbolic graph.

Counterpart of ``mxtpu/executor.py``'s ``Executor`` (``simple_bind`` /
``bind``, ``forward``, ``backward``, ``copy_params_from``, ``reshape``).
Where ``mxtpu`` traces the graph into jitted XLA programs, the port runs
:func:`~mxtpu_torch.symbol.eval_graph` eagerly: a training forward runs
under torch autograd with the arguments whose ``grad_req`` is not
``null`` as leaves, and :meth:`Executor.backward` differentiates that
recorded graph, writing the gradients into the bound gradient arrays in
place (``write`` overwrites, ``add`` accumulates). Without head
gradients every floating output gets a cotangent of ones, as for a loss
head (``mxtpu``'s ``_ones_cot``).

The argument, gradient and aux arrays keep their tensors for the
executor's life: values are copied into them (``forward(**kwargs)``,
``copy_params_from``) and optimizers update them in place. That is what
lets :meth:`Executor.make_fused_train_step`'s one function over those
tensors be captured once in a CUDA graph and replayed on every batch.
:meth:`Executor.adopt_arrays` aliases the parameter and aux slots to
another executor's arrays, so that executors of several input shapes
work on one set of parameter tensors.
"""
from __future__ import annotations

import numpy as _np
import torch

from . import ndarray as nd
from .base import canonical_dtype
from .ndarray import NDArray
from .ops.registry import rng_scope
from .symbol import eval_graph

__all__ = ["Executor"]


def _normalize_grad_req(grad_req, arg_names):
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    out = {n: "null" for n in arg_names}
    out.update(grad_req)
    return out


def _copy_into(dst, src):
    """Copy ``src`` (NDArray, tensor or array-like) into NDArray ``dst``'s
    own tensor, converting device and dtype."""
    if isinstance(src, NDArray):
        src = src.data
    elif not isinstance(src, torch.Tensor):
        src = torch.as_tensor(_np.asarray(src))
    with torch.no_grad():
        # a copy to the card from pageable memory is staged before the
        # call returns, so it need not wait for the card
        dst.data.copy_(src.detach(), non_blocking=dst.data.is_cuda)


class Executor:
    """A symbol bound to arrays on one context."""

    def __init__(self, sym, ctx, arg_dict, grad_dict, grad_req_dict,
                 aux_dict):
        self._symbol = sym
        self._ctx = ctx
        self.arg_dict = arg_dict
        self.grad_dict = grad_dict
        self.aux_dict = aux_dict
        self._grad_req = grad_req_dict
        self._arg_names = sym.list_arguments()
        self._aux_names = sym.list_auxiliary_states()
        self._grad_args = [n for n in self._arg_names
                           if grad_req_dict.get(n, "null") != "null"]
        self.arg_arrays = [arg_dict[n] for n in self._arg_names]
        self.grad_arrays = [grad_dict.get(n) for n in self._arg_names]
        self.aux_arrays = [aux_dict[n] for n in self._aux_names]
        self._outputs = None
        self._out_shapes = None
        self._tape = None           # (outputs, leaves) of a training forward
        self._monitor_callback = None
        # stateful ops (Dropout) draw from the executor's own generator,
        # seeded from numpy's global RNG: one draw an executor, as mxtpu
        # draws its PRNG key, so both packages consume numpy's stream alike
        self._generator = torch.Generator().manual_seed(
            int(_np.random.randint(0, 2 ** 31 - 1)))

    # -- binding constructors ---------------------------------------------
    @staticmethod
    def _simple_bind(sym, ctx, grad_req, type_dict, shape_kwargs):
        arg_names = sym.list_arguments()
        arg_shapes, out_shapes, aux_shapes = sym.infer_shape(**shape_kwargs)
        type_dict = type_dict or {}
        req_dict = _normalize_grad_req(grad_req, arg_names)
        arg_dict, grad_dict = {}, {}
        for name, shape in zip(arg_names, arg_shapes):
            if shape is None:
                raise ValueError("could not infer shape for argument %r"
                                 % name)
            dt = canonical_dtype(type_dict.get(name, _np.float32))
            arg_dict[name] = nd.zeros(shape, ctx=ctx, dtype=dt)
            if req_dict.get(name, "null") != "null":
                grad_dict[name] = nd.zeros(shape, ctx=ctx, dtype=dt)
        aux_dict = {}
        for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
            if shape is None:
                raise ValueError("could not infer shape for aux state %r"
                                 % name)
            aux_dict[name] = nd.zeros(shape, ctx=ctx)
        exe = Executor(sym, ctx, arg_dict, grad_dict, req_dict, aux_dict)
        exe._out_shapes = [tuple(s) for s in out_shapes]
        return exe

    @staticmethod
    def _bind(sym, ctx, args, args_grad, grad_req, aux_states):
        arg_names = sym.list_arguments()
        aux_names = sym.list_auxiliary_states()
        arg_dict = dict(zip(arg_names, args)) \
            if isinstance(args, (list, tuple)) else dict(args)
        if args_grad is None:
            grad_dict = {}
        elif isinstance(args_grad, (list, tuple)):
            grad_dict = {n: g for n, g in zip(arg_names, args_grad)
                         if g is not None}
        else:
            grad_dict = dict(args_grad)
        req_dict = _normalize_grad_req(grad_req, arg_names)
        for n in arg_names:
            if n not in grad_dict:
                req_dict[n] = "null"
        if aux_states is None:
            aux_dict = {}
        elif isinstance(aux_states, (list, tuple)):
            aux_dict = dict(zip(aux_names, aux_states))
        else:
            aux_dict = dict(aux_states)
        return Executor(sym, ctx, arg_dict, grad_dict, req_dict, aux_dict)

    # -- execution ---------------------------------------------------------
    def _run(self, training, record):
        """Evaluate the graph on the bound arrays. With ``record``, the
        floating grad arguments enter as autograd leaves (views of the
        bound tensors). Returns (outputs, aux updates, leaves)."""
        feed = {n: self.arg_dict[n].data for n in self._arg_names}
        feed.update((n, self.aux_dict[n].data) for n in self._aux_names)
        leaves = {}
        if record:
            leaves = {n: feed[n].detach().requires_grad_()
                      for n in self._grad_args
                      if feed[n].is_floating_point()}
            feed.update(leaves)
        with torch.set_grad_enabled(record), rng_scope(self._generator):
            outs, aux_updates = eval_graph(
                self._symbol._outputs, feed, training,
                device=self._ctx.torch_device())
        return outs, aux_updates, leaves

    def forward(self, is_train=False, **kwargs):
        """Copy ``kwargs`` into the named argument arrays, then evaluate
        the graph; a training forward also records it for
        :meth:`backward` and writes the aux states' updates."""
        for k, v in kwargs.items():
            _copy_into(self.arg_dict[k], v)
        record = bool(is_train) and bool(self._grad_args)
        outs, aux_updates, leaves = self._run(bool(is_train), record)
        self._tape = (outs, leaves) if record else None
        if is_train:
            # an update that is the aux tensor itself (BatchNorm with
            # use_global_stats) is not copied: the copy would bump the
            # version of a tensor the recorded backward may hold
            for n, v in aux_updates.items():
                if n in self.aux_dict and v is not self.aux_dict[n].data:
                    _copy_into(self.aux_dict[n], v)
        self._outputs = [NDArray(o.detach(), self._ctx) for o in outs]
        if self._monitor_callback is not None:
            for name, arr in zip(self._symbol.list_outputs(), self._outputs):
                self._monitor_callback(name, arr)
        return self._outputs

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the last forward's outputs (weighted by
        ``out_grads``, else ones) into the grad arrays. After an
        inference forward, the training forward is recomputed first."""
        if not self._grad_args:
            return
        if self._outputs is None:
            raise RuntimeError("backward called before forward")
        tape, self._tape = self._tape, None
        if tape is None:
            outs, _aux, leaves = self._run(True, True)
        else:
            outs, leaves = tape
        if out_grads is None:
            cots = [torch.ones_like(o) if o.is_floating_point() else None
                    for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            cots = [None if g is None else
                    (g.data if isinstance(g, NDArray) else g).to(o.device)
                    for g, o in zip(out_grads, outs)]
        pairs = [(o, c) for o, c in zip(outs, cots)
                 if c is not None and o.requires_grad]
        names = list(leaves)
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    [leaves[n] for n in names],
                                    [c for _, c in pairs], allow_unused=True) \
            if pairs and names else [None] * len(names)
        with torch.no_grad():
            for n, g in zip(names, grads):
                tgt = self.grad_dict[n].data
                if self._grad_req.get(n) == "add":
                    if g is not None:
                        tgt.add_(g)
                elif g is None:
                    tgt.zero_()
                else:
                    tgt.copy_(g)

    def make_fused_train_step(self, train_names, optimizer, opt_slots,
                              metric_fn=None):
        """The whole train step as one function over the bound tensors
        (``mxtpu``'s ``make_fused_train_step``, its local form): forward,
        backward with ones as the head cotangents (the loss-head
        pattern), every trained parameter's update by
        :func:`~mxtpu_torch.optimizer.functional_optimizer_step` (slot
        ``opt_slots[i]`` for ``train_names[i]``) and, with ``metric_fn``,
        the metric's (sum, count) added to an accumulator.

        Returns ``(fn, other_names)``: ``other_names`` are the arguments
        that are not trained (data, labels, fixed parameters) in
        ``list_arguments()`` order, and ``fn(train_vals, state_trees,
        aux_vals, other_vals, generator, t, lr, metric_acc)`` takes
        tensors: the weights, their optimizer states, the aux states, the
        other arguments, the generator stateful ops draw from, the step
        count (int32, 0-dim), the learning rate (float32, 0-dim) and a
        float32 (sum, count) pair. It writes in place the weights, the
        states, the aux states, ``t`` (+1) and ``metric_acc``, and returns
        the outputs. Gradients stay inside it (``torch.autograd.grad``),
        and every tensor it writes keeps its storage, so one call can be
        captured in a CUDA graph and replayed on new values copied into
        the same tensors."""
        from .optimizer import functional_optimizer_step
        outputs_ref = self._symbol._outputs
        aux_names = tuple(self._aux_names)
        train_names = tuple(train_names)
        other_names = tuple(n for n in self._arg_names
                            if n not in set(train_names))
        opt_slots = tuple(opt_slots)
        device = self._ctx.torch_device()

        def fused(train_vals, state_trees, aux_vals, other_vals, generator,
                  t, lr, metric_acc):
            feed = dict(zip(other_names, other_vals))
            feed.update(zip(aux_names, aux_vals))
            leaves = [w.detach().requires_grad_() if w.is_floating_point()
                      else w for w in train_vals]
            feed.update(zip(train_names, leaves))
            with torch.enable_grad(), rng_scope(generator):
                outs, aux_updates = eval_graph(outputs_ref, feed, True,
                                               device=device)
            heads = [o for o in outs
                     if o.requires_grad and o.is_floating_point()]
            wrt = [i for i, w in enumerate(leaves) if w.requires_grad]
            grads = [None] * len(leaves)
            if heads and wrt:
                found = torch.autograd.grad(
                    heads, [leaves[i] for i in wrt],
                    [torch.ones_like(o) for o in heads], allow_unused=True)
                for i, g in zip(wrt, found):
                    grads[i] = g
            with torch.no_grad():
                for n, a in zip(aux_names, aux_vals):
                    if n in aux_updates and aux_updates[n] is not a:
                        a.copy_(aux_updates[n])
                t.add_(1)
                for slot, w, g, st in zip(opt_slots, train_vals, grads,
                                          state_trees):
                    functional_optimizer_step(
                        optimizer, slot, w,
                        torch.zeros_like(w) if g is None else g, st, t, lr)
                outs = [o.detach() for o in outs]
                if metric_fn is not None:
                    m_sum, m_cnt = metric_fn(dict(zip(other_names,
                                                      other_vals)), outs)
                    metric_acc[0].add_(m_sum)
                    metric_acc[1].add_(float(m_cnt))
            return outs

        return fused, other_names

    def adopt_arrays(self, arg_src, aux_src):
        """Alias this executor's argument and aux slots to the given
        NDArrays (``mxtpu``'s ``adopt_arrays``) where name, shape and
        dtype agree, so that executors of several input shapes (a
        rebound module, a bucketing module's buckets) share one set of
        parameter tensors: a step of any of them updates all, and a
        switch between them copies nothing."""
        for table, src in ((self.arg_dict, arg_src), (self.aux_dict, aux_src)):
            for name, arr in src.items():
                dst = table.get(name)
                if dst is not None and dst is not arr and \
                        dst.shape == arr.shape and dst.dtype == arr.dtype:
                    table[name] = arr
        self.arg_arrays = [self.arg_dict[n] for n in self._arg_names]
        self.aux_arrays = [self.aux_dict[n] for n in self._aux_names]

    def reseed(self):
        """Seed the stateful ops' generator anew from numpy's global RNG,
        as binding a new executor does (one draw): a rebind that finds
        this executor again draws what ``mxtpu``'s fresh executor draws."""
        self._generator.manual_seed(int(_np.random.randint(0, 2 ** 31 - 1)))

    def set_monitor_callback(self, callback):
        """Call ``callback(name, NDArray)`` on each output after every
        forward (``Monitor.install``)."""
        self._monitor_callback = callback

    @property
    def outputs(self):
        return self._outputs if self._outputs is not None else []

    @property
    def output_shapes(self):
        """Inferred output shapes, known before any forward."""
        if self._out_shapes is None:
            _, outs, _ = self._symbol.infer_shape(
                **{n: tuple(a.shape) for n, a in self.arg_dict.items()})
            self._out_shapes = [tuple(s) for s in outs]
        return self._out_shapes

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy parameter values into the bound arrays (converted to each
        array's device and dtype)."""
        for k, v in arg_params.items():
            if k in self.arg_dict:
                _copy_into(self.arg_dict[k], v)
            elif not allow_extra_params:
                raise ValueError("unknown argument %r" % k)
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                _copy_into(self.aux_dict[k], v)
            elif not allow_extra_params:
                raise ValueError("unknown aux state %r" % k)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                shared_args=None, **kwargs):
        """A new executor for new input shapes. Arrays whose shape stays
        are shared with this one (only those in ``shared_args``, when
        given; the others are copied); the rest are new zeros."""
        arg_shapes, out_shapes, aux_shapes = \
            self._symbol.infer_shape(**kwargs)
        share_ok = ((lambda n: True) if shared_args is None
                    else set(shared_args).__contains__)

        def keep_or_new(old, name, shape, dtype):
            if tuple(old.shape) == tuple(shape):
                return old if share_ok(name) else old.copy()
            return nd.zeros(shape, ctx=self._ctx, dtype=dtype)
        arg_dict = {n: keep_or_new(self.arg_dict[n], n, s,
                                   self.arg_dict[n].dtype)
                    for n, s in zip(self._arg_names, arg_shapes)}
        grad_dict = {n: nd.zeros(arg_dict[n].shape, ctx=self._ctx,
                                 dtype=arg_dict[n].dtype)
                     for n in self.grad_dict}
        aux_dict = {n: keep_or_new(self.aux_dict[n], n, s, None)
                    for n, s in zip(self._aux_names, aux_shapes)}
        new_exe = Executor(self._symbol, self._ctx, arg_dict, grad_dict,
                           self._grad_req, aux_dict)
        new_exe._out_shapes = [tuple(s) for s in out_shapes]
        return new_exe
