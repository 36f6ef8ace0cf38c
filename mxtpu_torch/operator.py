"""Custom operators of the PyTorch port: user Python ops inside graphs.

Counterpart of ``mxtpu/operator.py``: ``CustomOp`` / ``CustomOpProp`` /
``register``, invoked as ``nd.Custom(*args, op_type='name')`` or
``sym.Custom``, and the legacy ``NDArrayOp`` / ``NativeOp`` adapters.
The framework op ``Custom`` is a ``torch.autograd.Function`` whose
backward calls the user's ``backward``. Output shapes and dtypes come
from the prop's ``infer_shape`` and ``infer_type``; one operator instance
serves forward and backward for each (op_type, kwargs, input shapes,
dtypes, device), so an op may keep forward state on ``self`` for its
backward.

One deliberate difference: ``mxtpu`` runs the user's code on the host
and passes ``create_operator`` the string ``"cpu"``. The port runs it
where the inputs lie: ``create_operator`` receives their
:class:`~mxtpu_torch.context.Context`, ``forward`` and ``backward`` get
NDArrays on that device, and run inside ``with ctx:`` (so ``nd.array``
and friends default to it) with recording paused. That is what lets a
custom op launch ``mx.rtc`` kernels on the card.

A custom op may run inside a CUDA graph being captured (the fused
``Module`` train step). If torch or CUDA refuses its body there because
it reads the card from the host, the error is raised as
:class:`~mxtpu_torch.base.CaptureRefused` naming the op, so that the
caller can tell it from a fault of the step itself; every other error
is raised as it is.
"""
from __future__ import annotations

import numpy as _np
import torch

from . import autograd as _ag
from .base import (CaptureRefused, MXNetError, canonical_dtype,
                   is_capture_refusal)
from .context import Context, cpu
from .ndarray import NDArray
from .ops.registry import register as _register_op

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop",
           "custom_num_outputs", "NDArrayOp", "NativeOp"]

_CUSTOM_REGISTRY = {}


class CustomOp:
    """Base class for custom op implementations (reference CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError()

    def assign(self, dst, req, src):
        """Write ``src`` (an NDArray, tensor or array-like) into NDArray
        ``dst`` by grad req: ``write``/``inplace`` rebind ``dst`` to
        ``src``'s value, ``add`` adds it, ``null`` does nothing."""
        if req == "null":
            return
        if isinstance(src, NDArray):
            src = src.data
        elif not isinstance(src, torch.Tensor):
            src = torch.as_tensor(_np.asarray(src))
        src = src.to(dst.data.device)
        if req in ("write", "inplace"):
            dst._data = src
        elif req == "add":
            dst._data = dst.data + src
        else:
            raise ValueError("invalid req %r" % req)


class CustomOpProp:
    """Describes a custom op's signature (reference CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, (in_shape[0],), ()

    def infer_type(self, in_type):
        return in_type, (in_type[0],) * len(self.list_outputs()), \
            (in_type[0],) * len(self.list_auxiliary_states())

    def list_arguments(self):
        return ("data",)

    def list_outputs(self):
        return ("output",)

    def list_auxiliary_states(self):
        return ()

    def need_top_grad(self):
        return self.need_top_grad_

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps


def register(reg_name):
    """Register a CustomOpProp subclass under op_type ``reg_name``."""
    def deco(prop_cls):
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls
    return deco


def get_prop(op_type, kwargs=None):
    if op_type not in _CUSTOM_REGISTRY:
        raise MXNetError("custom op type %r is not registered "
                         "(use mx.operator.register)" % op_type)
    return _CUSTOM_REGISTRY[op_type](**{k: str(v)
                                        for k, v in (kwargs or {}).items()})


def _numpy_dtype(d):
    """A dtype a prop may name (numpy type or name, torch dtype) as
    numpy's, the currency of ``infer_type``."""
    return _np.dtype(str(d).replace("torch.", "") if isinstance(
        d, torch.dtype) else d)


class _Spec:
    """One (op_type, kwargs, shapes, dtypes, device) specialisation: the
    prop, the inferred outputs, and the operator instance shared by
    forward and backward."""

    def __init__(self, op_type, kwargs, in_shapes, in_dtypes, device):
        prop = get_prop(op_type, kwargs)
        self.op_type = op_type
        if prop.list_auxiliary_states():
            raise NotImplementedError(
                "custom ops with auxiliary states are not supported")
        self.prop = prop
        self.in_shapes = in_shapes
        self.in_dtypes = in_dtypes
        _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
        _, out_dtypes, _ = prop.infer_type(
            [_numpy_dtype(d) for d in in_dtypes])
        self.n_out = len(prop.list_outputs())
        self.out_shapes = [tuple(int(d) for d in s)
                           for s in out_shapes[:self.n_out]]
        self.out_dtypes = [canonical_dtype(_numpy_dtype(d))
                           for d in out_dtypes[:self.n_out]]
        self.device = device
        self.ctx = cpu() if device.type in ("cpu", "meta") \
            else Context("gpu", device.index or 0)
        self._op = None

    def operator(self):
        if self._op is None:
            self._op = self.prop.create_operator(
                self.ctx, [list(s) for s in self.in_shapes],
                [_numpy_dtype(d) for d in self.in_dtypes])
        return self._op

    def _arrays(self, tensors):
        return [NDArray(t, self.ctx) for t in tensors]

    def _zeros(self, shapes, dtypes):
        return [NDArray(torch.zeros(s, dtype=d, device=self.device), self.ctx)
                for s, d in zip(shapes, dtypes)]

    def _run_body(self, body, *args):
        """Call the user's ``forward`` or ``backward``; a host read that
        the stream's capture refused raises :class:`CaptureRefused`."""
        try:
            body(*args)
        except Exception as e:
            if self.device.type == "cuda" and is_capture_refusal(e) and \
                    torch.cuda.is_current_stream_capturing():
                raise CaptureRefused(self.op_type, str(e)) from e
            raise

    def forward(self, is_train, inputs):
        op = self.operator()
        in_data = self._arrays(inputs)
        out_data = self._zeros(self.out_shapes, self.out_dtypes)
        with Context(self.ctx), _ag.pause(train_mode=is_train):
            self._run_body(op.forward, is_train, ["write"] * self.n_out,
                           in_data, out_data, [])
        return [self._result(o, s, d, "output") for o, s, d in
                zip(out_data, self.out_shapes, self.out_dtypes)]

    def backward(self, out_grads, inputs, outputs):
        op = self.operator()
        n_in = len(inputs)
        in_grad = self._zeros(self.in_shapes, self.in_dtypes)
        with Context(self.ctx), _ag.pause(train_mode=True):
            self._run_body(op.backward, ["write"] * n_in,
                           self._arrays(out_grads), self._arrays(inputs),
                           self._arrays(outputs), in_grad, [])
        return [self._result(g, s, d, "input gradient") for g, s, d in
                zip(in_grad, self.in_shapes, self.in_dtypes)]

    def _result(self, arr, shape, dtype, what):
        t = arr.data
        if tuple(t.shape) != tuple(shape):
            raise MXNetError("custom op %s: an %s has shape %s, infer_shape "
                             "says %s" % (type(self.prop).__name__, what,
                                          tuple(t.shape), tuple(shape)))
        return t.to(device=self.device, dtype=dtype)


class _CustomFunction(torch.autograd.Function):
    @staticmethod
    def forward(fctx, spec, is_train, *inputs):
        outs = spec.forward(is_train, inputs)
        fctx.spec = spec
        fctx.save_for_backward(*inputs, *outs)
        fctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(fctx, *grads):
        spec = fctx.spec
        saved = fctx.saved_tensors
        n_in = len(spec.in_shapes)
        grads = [torch.zeros(s, dtype=d, device=spec.device) if g is None
                 else g for g, s, d in zip(grads, spec.out_shapes,
                                           spec.out_dtypes)]
        in_grads = spec.backward(grads, saved[:n_in], saved[n_in:])
        return (None, None) + tuple(
            g if x.is_floating_point() else None
            for g, x in zip(in_grads, saved[:n_in]))


_SPECS = {}


def _custom_op_fn(*inputs, op_type=None, _training=False, **kwargs):
    """The ``Custom`` framework op: run registered op ``op_type`` on the
    tensors ``inputs``. On ``meta`` tensors (shape inference) it returns
    empty outputs of the inferred shapes and runs no user code."""
    if op_type is None:
        raise ValueError("Custom requires op_type=")
    device = inputs[0].device
    key = (op_type, tuple(sorted(kwargs.items())),
           tuple(tuple(x.shape) for x in inputs),
           tuple(x.dtype for x in inputs), device)
    spec = _SPECS.get(key)
    if spec is None:
        spec = _SPECS[key] = _Spec(op_type, kwargs, list(key[2]),
                                   list(key[3]), device)
    if device.type == "meta":
        outs = tuple(torch.empty(s, dtype=d, device=device)
                     for s, d in zip(spec.out_shapes, spec.out_dtypes))
    else:
        outs = _CustomFunction.apply(spec, bool(_training), *inputs)
    return outs if spec.n_out > 1 else outs[0]


_register_op("Custom", differentiable=True, needs_train_flag=True)(
    _custom_op_fn)


def custom_num_outputs(params):
    """Output arity of a Custom node (symbol layer hook)."""
    kwargs = {k: v for k, v in params.items()
              if k not in ("op_type", "_training")}
    return len(get_prop(params.get("op_type"), kwargs).list_outputs())


def custom_arg_shapes(params, in_shapes):
    """Shapes the prop infers for a Custom node's inputs (a label, say)
    from those known; ``in_shapes`` holds None for the unknown ones,
    passed to the prop as ``()``. Returns one shape or None per input."""
    kwargs = {k: v for k, v in params.items()
              if k not in ("op_type", "_training")}
    prop = get_prop(params.get("op_type"), kwargs)
    arg_shapes = prop.infer_shape([list(s) if s is not None else []
                                   for s in in_shapes])[0]
    out = [tuple(int(d) for d in s) if s is not None and len(s) else None
           for s in arg_shapes]
    return out + [None] * (len(in_shapes) - len(out))


class NDArrayOp:
    """Legacy v0.x custom-op base (reference operator.py NDArrayOp): a
    compatibility adapter over CustomOp. Subclass with forward/backward/
    list_arguments/list_outputs/infer_shape and call
    ``.get_symbol(*args)``."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def forward(self, in_data, out_data):
        raise NotImplementedError()

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError()

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def need_top_grad(self):
        return self.need_top_grad_

    def get_symbol(self, *args, **kwargs):
        """Wrap as a CustomOp-backed symbol (the modern path)."""
        legacy = self

        class _Prop(CustomOpProp):
            def __init__(self, **pkw):
                super().__init__(need_top_grad=legacy.need_top_grad())

            def list_arguments(self):
                return legacy.list_arguments()

            def list_outputs(self):
                return legacy.list_outputs()

            def infer_shape(self, in_shape):
                res = legacy.infer_shape(in_shape)
                return res if len(res) == 3 else (res[0], res[1], [])

            def create_operator(self, ctx, shapes, dtypes):
                class _Op(CustomOp):
                    def forward(self, is_train, req, in_data, out_data,
                                aux):
                        legacy.forward(in_data=in_data, out_data=out_data)

                    def backward(self, req, out_grad, in_data, out_data,
                                 in_grad, aux):
                        legacy.backward(out_grad=out_grad, in_data=in_data,
                                        out_data=out_data, in_grad=in_grad)
                return _Op()

        name = "_legacy_%s_%d" % (type(self).__name__, id(self))
        register(name)(_Prop)
        from . import symbol as sym
        return sym.Custom(*args, op_type=name, **kwargs)


class NativeOp(NDArrayOp):
    """Legacy NativeOp: in the port, native kernels of a custom op are
    ``mx.rtc`` CUDA C; the Python-side semantics are NDArrayOp's."""
