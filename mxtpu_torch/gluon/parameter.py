"""Gluon Parameter / ParameterDict of the PyTorch port.

Counterpart of ``mxtpu/gluon/parameter.py``: a Parameter owns its
weight array (an NDArray over a ``torch.Tensor`` on one context), its
gradient array and its initializer, with deferred initialization (the
shape found at the first forward), lr / wd multipliers and ``grad_req``
(``write``, ``add``, ``null``). The port holds one copy, on the context
``initialize`` names (default: the current context, ``gpu(0)``).

Updates keep the weight's storage: the Trainer updates the tensor in
place, and ``zero_grad`` zeroes the gradient in place, so a hybridized
block's captured graph keeps reading and writing the right memory.
What changes a weight's storage, dtype or device (``set_data`` on an
initialized parameter, ``cast``, ``reset_ctx``, a new ``grad_req``)
bumps the parameter's ``_version``, and a hybridized block builds a new
program when it sees one. ``grad_stype="row_sparse"`` gives a row-sparse
gradient array, the compact one (``grad_nnz_max`` row slots) when
``grad_nnz_max`` is given, as in ``mxtpu``; ``stype`` is kept and the
weight stays dense, as there.

:meth:`ParameterDict.load_dict` loads ``{name: numpy array}`` keyed by
``mxtpu``'s parameter names, which is how weights cross from ``mxtpu``
(``{k: v.asnumpy() for k, v in params.items()}``); ``save`` / ``load``
files cross both ways as they are (the ``.npz`` container both
packages' ``nd.save`` write).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as _np
import torch

from ..base import MXNetError, canonical_dtype
from ..context import Context, current_context
from .. import autograd as _ag
from .. import initializer as init_mod
from .. import ndarray as nd
from .. import symbol as _sym
from ..ndarray import NDArray

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """Parameter is waiting for its shape to be inferred from data."""


def _shape_known(shape):
    return shape is not None and all(s > 0 for s in shape)


def _one_ctx(ctx):
    if isinstance(ctx, (list, tuple)):
        ctx = ctx[0]
    return ctx or current_context()


class Parameter:
    """A weight of a Block (``mxtpu.gluon.Parameter``)."""

    def __init__(self, name, grad_req="write", shape=None, dtype=_np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default", grad_nnz_max=None):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = canonical_dtype(dtype) if dtype is not None else None
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._stype = stype
        self._grad_stype = grad_stype
        self._grad_nnz_max = grad_nnz_max
        self._data = None           # NDArray
        self._grad = None           # NDArray or None
        self._deferred_init = None  # (init, ctx, explicit) pending shape
        self._var = None
        self._ctx = None
        self._version = 0

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (
            self.name, self._shape, self.dtype)

    # -- shape ------------------------------------------------------------
    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is None:
            self._shape = tuple(new_shape)
            return
        # merge: unknown (0) dims adopt the new value
        if len(self._shape) != len(new_shape) or any(
                s not in (0, n) for s, n in zip(self._shape, new_shape)):
            raise AssertionError(
                "cannot reset shape of %s from %s to %s"
                % (self.name, self._shape, new_shape))
        self._shape = tuple(n if s == 0 else s
                            for s, n in zip(self._shape, new_shape))

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("invalid grad_req %r" % req)
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        self._version += 1
        if req == "null":
            self._grad = None
            if self._data is not None:
                self._data._grad = None
                self._data._data = self._data._data.detach()
        elif self._data is not None:
            self._init_grad()

    # -- init -------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        default_init = default_init or init_mod.Uniform()
        if self._data is not None and not force_reinit:
            return
        ctx = _one_ctx(ctx)
        chosen = init if init is not None else self.init
        explicit = chosen is not None
        if not explicit:
            chosen = default_init
        if not _shape_known(self._shape):
            if not self._allow_deferred_init:
                raise ValueError(
                    "Cannot initialize Parameter %s because it has invalid "
                    "shape %s; specify in_units/in_channels or use deferred "
                    "init inside a Block." % (self.name, self._shape))
            self._deferred_init = (chosen, ctx, explicit)
            return
        self._finish_init(chosen, ctx, explicit)

    def _finish_init(self, initializer, ctx, explicit=False):
        data = nd.zeros(self._shape, ctx=ctx, dtype=self.dtype)
        created = init_mod.create(initializer)
        desc = init_mod.InitDesc(self.name)
        if explicit:
            # a per-parameter initializer applies directly, bypassing the
            # name-suffix dispatch, as in mxtpu
            created._init_weight(desc, data)
        else:
            created(desc, data)
        self._set_array(data, ctx)

    def _set_array(self, data, ctx):
        """Own NDArray ``data`` (on ``ctx``) as the weight, with a zero
        gradient array unless ``grad_req`` is null."""
        self._data = data
        self._ctx = ctx
        self._deferred_init = None
        self._version += 1
        if self._grad_req != "null":
            self._init_grad()

    def _init_grad(self):
        if self._grad_stype == "row_sparse":
            self._grad = nd.sparse.zeros(
                "row_sparse", self._data.shape, ctx=self._data.context,
                dtype=self._data.dtype, nnz_max=self._grad_nnz_max)
        else:
            self._grad = NDArray(torch.zeros_like(self._data.data.detach()),
                                 self._data.context)
        _ag.mark_variables([self._data], [self._grad], [self._grad_req])

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if not _shape_known(self._shape):
            raise DeferredInitializationError(
                "Parameter %s has unknown shape %s. Run a forward pass or "
                "set the shape explicitly." % (self.name, self._shape))
        initializer, ctx, explicit = self._deferred_init
        self._finish_init(initializer, ctx, explicit)

    # -- access -----------------------------------------------------------
    def _check_initialized(self):
        if self._data is not None:
            return
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                "Parameter %s was not initialized yet: deferred init pending "
                "shape inference (run a forward pass first)." % self.name)
        raise RuntimeError(
            "Parameter %s has not been initialized. Call initialize() first."
            % self.name)

    def data(self, ctx=None):
        self._check_initialized()
        return self._data

    def list_data(self):
        self._check_initialized()
        return [self._data]

    def grad(self, ctx=None):
        self._check_initialized()
        if self._grad is None:
            raise RuntimeError(
                "Cannot get gradient of Parameter %s: grad_req='null'"
                % self.name)
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        self._check_initialized()
        return [self._ctx]

    def set_data(self, data):
        """Set the weight to ``data`` (an NDArray, numpy array or list).
        Before initialization it becomes the weight, on its own context;
        after, the weight takes its value on the weight's context and
        dtype, in a new tensor (a hybridized block builds a new
        program)."""
        if not isinstance(data, NDArray):
            data = nd.array(data, ctx=self._ctx)
        if _shape_known(self._shape) and tuple(data.shape) != self._shape:
            raise ValueError("shape mismatch for %s: expected %s, got %s"
                             % (self.name, self._shape, data.shape))
        self.shape = data.shape
        if self._data is None:
            t = data.data.detach()
            t = t.to(self.dtype, copy=True) if self.dtype else t.clone()
            self._set_array(NDArray(t, data.context), data.context)
            return
        self._data._set_data(data.data.detach().to(
            device=self._data.data.device, dtype=self._data.data.dtype,
            copy=True))
        self._version += 1

    def zero_grad(self):
        """Zero the gradient array in place."""
        if self._grad is None:
            return
        if isinstance(self._grad, nd.sparse.CompactRowSparseNDArray):
            self._grad._clear()
            return
        with torch.no_grad():
            self._grad._data.zero_()
        if self._grad.stype == "row_sparse":
            self._grad._aux = None

    def var(self):
        """The Symbol variable of this parameter (its name, shape, dtype
        and multipliers)."""
        if self._var is None:
            self._var = _sym.var(self.name, shape=self._shape,
                                 dtype=self.dtype, lr_mult=self.lr_mult,
                                 wd_mult=self.wd_mult)
        return self._var

    def cast(self, dtype):
        self.dtype = canonical_dtype(dtype)
        self._var = None  # the cached symbol carries the old dtype
        if self._data is not None:
            self._data._set_data(self._data.data.detach().to(self.dtype))
            if self._grad is not None:
                self._grad._data = self._grad._data.to(self.dtype)
            self._version += 1

    def reset_ctx(self, ctx):
        """Move the weight and its gradient to ``ctx``."""
        if self._data is None or ctx is None:
            return
        ctx = _one_ctx(ctx)
        dev = ctx.torch_device()
        self._data = NDArray(self._data.data.detach().to(dev), ctx)
        self._ctx = ctx
        self._version += 1
        if self._grad_req != "null":
            grad = self._grad.as_in_context(ctx) \
                if self._grad.stype != "default" \
                else NDArray(self._grad.data.to(dev), ctx)
            _ag.mark_variables([self._data], [grad], [self._grad_req])
            self._grad = grad


class Constant(Parameter):
    """A parameter of fixed value that is never updated."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = nd.array(value)
        self.value = value

        class _CInit(init_mod.Initializer):
            def _init_weight(self, desc, arr):
                arr._set_data(value.data.detach().to(arr.data.device))

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_CInit(),
                         differentiable=False)


class ParameterDict:
    """Parameters sharing a prefix (``mxtpu.gluon.ParameterDict``)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        s = "\n".join("  " + repr(p) for p in self._params.values())
        return "ParameterDict '%s' (\n%s\n)" % (self._prefix, s)

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, key):
        return key in self._params

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """Create or retrieve parameter ``self.prefix + name``."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        else:
            for k, v in kwargs.items():
                if k == "shape" and v is not None:
                    param.shape = (v,) if isinstance(v, int) else v
                elif v is not None and getattr(param, k, None) in (None, v):
                    setattr(param, k, v)
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError("no constant named %s" % name)
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError("duplicate parameter name %s" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for p in self.values():
            p.initialize(None, ctx, default_init=init or init_mod.Uniform(),
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        payload = {}
        for p in self.values():
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            payload[name] = p.data()
        nd.save(filename, payload)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load a file written by either package's ``save``."""
        self.load_dict(nd.load(filename, ctx=_load_ctx(ctx)), ctx,
                       allow_missing, ignore_extra, restore_prefix,
                       source="file %s" % filename)

    def load_dict(self, params, ctx=None, allow_missing=False,
                  ignore_extra=False, restore_prefix="", source="dict"):
        """Set the parameters from ``{name: array}`` (numpy arrays,
        NDArrays of either context, or lists), keyed by the parameters'
        names less ``restore_prefix``: the way weights cross from
        ``mxtpu`` (``{k: v.data().asnumpy()}`` of its ``collect_params()``).
        A parameter not yet initialized takes the value on ``ctx``
        (default: the current context)."""
        params = {restore_prefix + k: v for k, v in params.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in params:
                    raise IOError("Parameter %s missing in %s"
                                  % (name, source))
        for name, value in params.items():
            if name not in self._params:
                if ignore_extra:
                    continue
                raise IOError("Parameter %s in %s is not in this dict"
                              % (name, source))
            p = self._params[name]
            if isinstance(value, NDArray):
                value = value.data
            if not isinstance(value, torch.Tensor):
                value = nd.array(_np.asarray(value), ctx=_load_ctx(ctx)).data
            target = p._ctx if p._data is not None else _load_ctx(ctx)
            p.set_data(NDArray(value.detach().to(target.torch_device()),
                               target))


def _load_ctx(ctx):
    ctx = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
    return ctx if isinstance(ctx, Context) else current_context()
