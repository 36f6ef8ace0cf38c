"""Weight initializers of the PyTorch port.

Counterpart of ``mxtpu/initializer.py``: ``InitDesc``, an
``Initializer`` that dispatches on the parameter's name (``*weight``,
``*bias``, ``*gamma``, ``*beta``, running statistics, or a variable's
``__init__`` attribute), its registry and ``create``, and Zero, One,
Constant, Uniform, Normal, Xavier (with ``mxtpu``'s fan and
``hw_scale`` rule for convolution weights), MSRAPrelu (Xavier, Gaussian,
magnitude 2 / (1 + slope^2)), Orthogonal (a singular-vector factor of a
drawn matrix, scaled), Bilinear (the upsampling kernel of a
Deconvolution), LSTMBias (the forget gate's bias), Load (from a dict of
arrays, the rest by a default initializer), Mixed (an initializer by the
first pattern a name matches) and FusedRNN (a fused RNN's flat blob,
drawn block by block in ``mxtpu``'s order).

Draws come from :func:`mxtpu_torch.ops.registry.next_generator`, a CPU
generator (``mx.random.seed`` seeds it), and are then moved to the
array's context, so a seed gives the card and the CPU the same weights.
They are not ``jax.random``'s numbers: the two packages share each rule,
not its bits, and parity of training starts from weights carried over.
"""
from __future__ import annotations

import json
import logging
import re

import numpy as _np
import torch

from .ops.registry import next_generator

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Constant", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Bilinear", "LSTMBias", "Load", "Mixed", "FusedRNN"]

_INIT_REGISTRY = {}


def register(klass):
    """Register an initializer class under its lowercased name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class InitDesc(str):
    """The name of the array being initialized, with its attributes."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer: ``init(desc, arr)`` fills NDArray ``arr`` by the
    rule that ``desc``'s name (or ``__init__`` attribute) selects."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self._verbose = False
        self._print_func = None

    def set_verbosity(self, verbose=False, print_func=None):
        self._verbose = verbose
        if print_func is None:
            def asum_stat(x):
                return str((_np.abs(x.asnumpy()).mean(),))
            print_func = asum_stat
        self._print_func = print_func
        return self

    def _verbose_print(self, desc, init, arr):
        if self._verbose and self._print_func:
            logging.info("Initialized %s as %s: %s", desc, init,
                         self._print_func(arr))

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        if desc.global_init is None:
            desc.global_init = self
        init = desc.attrs.get("__init__", "")
        if init:
            klass, kwargs = json.loads(init) if init.startswith("[") \
                else (init, {})
            create(klass, **kwargs)._init_weight(desc, arr)
            self._verbose_print(desc, init, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
            self._verbose_print(desc, "weight", arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("min"):
            self._init_zero(desc, arr)
        elif name.endswith("max"):
            self._init_one(desc, arr)
        elif name.endswith("moving_mean") or name.endswith("running_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("moving_var") or name.endswith("moving_avg") \
                or name.endswith("running_var"):
            self._init_one(desc, arr)
        elif name.endswith("moving_inv_var"):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_bias(self, _, arr):
        arr[:] = 0.0

    def _init_gamma(self, _, arr):
        arr[:] = 1.0

    def _init_beta(self, _, arr):
        arr[:] = 0.0

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override _init_weight")

    def _init_default(self, name, arr):
        raise ValueError(
            "Unknown initialization pattern for %s. Default initialization "
            "is now limited to 'weight', 'bias', 'gamma', and 'beta'. Please "
            "use mx.sym.Variable(init=mx.init.*) to set the pattern." % name)

    def __eq__(self, other):
        return isinstance(other, self.__class__) \
            and self._kwargs == other._kwargs


_NAME_ALIASES = {"zeros": "zero", "ones": "one"}


def create(name, **kwargs):
    """An initializer from its registry name; instances pass through."""
    if isinstance(name, Initializer):
        return name
    if callable(name) and not isinstance(name, type):
        return name
    key = name.lower() if isinstance(name, str) else name
    key = _NAME_ALIASES.get(key, key)
    if key not in _INIT_REGISTRY:
        raise ValueError("unknown initializer %r" % (name,))
    return _INIT_REGISTRY[key](**kwargs)


def _set(arr, value):
    """Fill NDArray ``arr`` with ``value`` (a CPU f32 tensor drawn for
    it), moved to the array's device and dtype."""
    arr._set_data(value.to(device=arr._data.device, dtype=arr._data.dtype)
                  .reshape(arr.shape))


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        _set(arr, torch.empty(arr.shape).uniform_(
            -self.scale, self.scale, generator=next_generator()))


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        _set(arr, torch.randn(arr.shape, generator=next_generator())
             * self.sigma)


@register
class Xavier(Initializer):
    """Xavier/Glorot: U(-s, s) or N(0, s^2) with s = sqrt(magnitude /
    factor), the factor from fan in / out, which count the kernel's
    spatial size (``hw_scale``) for a convolution weight."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def scale(self, name, shape):
        """The bound (uniform) or deviation (gaussian) for ``shape``."""
        hw_scale = 1.0
        if len(shape) < 2:
            raise ValueError(
                "Xavier initializer cannot be applied to vector %s. It "
                "requires at least 2D." % name)
        if len(shape) > 2:
            hw_scale = float(_np.prod(shape[2:]))
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        return float(_np.sqrt(self.magnitude / factor))

    def _init_weight(self, name, arr):
        scale = self.scale(name, arr.shape)
        if self.rnd_type == "uniform":
            _set(arr, torch.empty(arr.shape).uniform_(
                -scale, scale, generator=next_generator()))
        elif self.rnd_type == "gaussian":
            _set(arr, torch.randn(arr.shape, generator=next_generator())
                 * scale)
        else:
            raise ValueError("Unknown random type")


@register
class Orthogonal(Initializer):
    """``scale`` times an orthonormal (nout, prod(shape[1:])) factor: the
    left singular vectors of a matrix drawn from U(-1, 1) (``rand_type``
    "uniform") or N(0, 1) where they have that shape, else the right ones
    (Saxe et al., 2013)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(_np.prod(arr.shape[1:])) if len(arr.shape) > 1 else 1
        if self.rand_type == "uniform":
            tmp = torch.empty(nout, nin).uniform_(-1.0, 1.0,
                                                  generator=next_generator())
        else:
            tmp = torch.randn(nout, nin, generator=next_generator())
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        _set(arr, self.scale * q)


@register
class MSRAPrelu(Xavier):
    """He et al.'s initialization for PReLU nets: Xavier, Gaussian, of
    magnitude 2 / (1 + slope^2) over the ``factor_type`` fan."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """A bilinear upsampling kernel in every (in, out) channel pair of a
    (C_in, C_out, kh, kw) Deconvolution weight: (1 - |x / f - c|) (1 -
    |y / f - c|) with f = ceil(kw / 2) and c = (2 f - 1 - f % 2) / (2 f),
    the rule of ``mxtpu``'s (and MXNet's) Bilinear."""

    def _init_weight(self, _, arr):
        shape = tuple(arr.shape)
        f = _np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = 1 - _np.abs(_np.arange(shape[3]) / f - c)
        y = 1 - _np.abs(_np.arange(shape[2]) / f - c)
        kernel = (y[:, None] * x[None, :]).astype("float32")
        _set(arr, torch.from_numpy(_np.ascontiguousarray(
            _np.broadcast_to(kernel, shape))))


@register
class LSTMBias(Initializer):
    """An LSTM's bias: zero but the forget gate's quarter (rows H to 2H
    of 4H), ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = torch.zeros(tuple(arr.shape))
        num_hidden = int(b.shape[0] / 4)
        b[num_hidden:2 * num_hidden] = self.forget_bias
        _set(arr, b)


def _host_tensor(src):
    """A CPU tensor of an array of either package or of numpy."""
    if isinstance(src, torch.Tensor):
        return src.detach().cpu()
    data = getattr(src, "data", None)
    if isinstance(data, torch.Tensor):
        return data.detach().cpu()
    return torch.as_tensor(_np.asarray(
        src.asnumpy() if hasattr(src, "asnumpy") else src))


@register
class Load:
    """The arrays of ``param`` (keys with an ``arg:`` / ``aux:`` prefix
    are taken without it) by name, of the same shape; any other name by
    ``default_init``, else ValueError."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != tuple(arr.shape):
                raise ValueError("Parameter %s cannot be initialized from "
                                 "loading. Shape mismatch, target %s vs "
                                 "loaded %s" % (name, arr.shape, src.shape))
            _set(arr, _host_tensor(src))
            if self.verbose:
                logging.info("Initialized %s by loading", name)
        else:
            if self.default_init is None:
                raise ValueError(
                    "Cannot Initialize parameter %s. Not found in loaded "
                    "param and no default initializer provided." % name)
            self.default_init(name, arr)
            if self.verbose:
                logging.info("Initialized %s by default", name)


@register
class Mixed:
    """The initializer of the first pattern (``re.match``) a name
    matches; ValueError if none does."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("one initializer a pattern")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError(
            "Parameter name %s did not match any pattern. Consider adding a "
            '".*" pattern at the and with default Initializer.' % name)


@register
class FusedRNN(Initializer):
    """The flat parameter blob of a fused RNN (``mxtpu``'s FusedRNN): each
    (layer, direction)'s i2h and h2h weight matrices drawn in turn by the
    wrapped initializer, in the blob's order (``ops/rnn.py``: all weights
    first, then all biases), the biases zero, and ``forget_bias`` split
    over the LSTM forget gate's two biases. ``init`` is an Initializer or
    its ``dumps()``; None means Xavier(factor_type="in",
    magnitude=2.34)."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        init_str = init.dumps() if isinstance(init, Initializer) \
            else (init or Xavier(factor_type="in", magnitude=2.34).dumps())
        super().__init__(init=init_str, num_hidden=num_hidden,
                         num_layers=num_layers, mode=mode,
                         bidirectional=bidirectional,
                         forget_bias=forget_bias)
        if isinstance(init, Initializer):
            self._init = init
        else:
            klass, kwargs = json.loads(init_str)
            self._init = create(klass, **kwargs)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def __call__(self, desc, arr):
        self._init_weight(desc, arr)

    def _init_weight(self, desc, arr):
        from . import ndarray as nd
        from .context import cpu
        from .ops.rnn import _GATES, rnn_param_size
        G, H, L = _GATES[self._mode], self._num_hidden, self._num_layers
        D = 2 if self._bidirectional else 1
        total = int(_np.prod(arr.shape))
        rest = rnn_param_size(self._mode, 0, H, L, self._bidirectional)
        isz = (total - rest) // (D * G * H)
        out = torch.zeros(total)
        off = 0
        for layer in range(L):
            in_sz = isz if layer == 0 else H * D
            for _ in range(D):
                for shape in ((G * H, in_sz), (G * H, H)):
                    w = nd.zeros(shape, ctx=cpu())
                    self._init._init_weight(desc, w)
                    n = shape[0] * shape[1]
                    out[off:off + n] = w.data.reshape(-1).float()
                    off += n
        for layer in range(L):
            for _ in range(D):
                for _half in range(2):
                    if self._mode == "lstm":
                        out[off + H:off + 2 * H] = self._forget_bias / 2.0
                    off += G * H
        _set(arr, out)
