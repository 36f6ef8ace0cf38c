"""Gluon basic layers of the PyTorch port.

Counterpart of ``mxtpu/gluon/nn/basic_layers.py``: the
Sequential/HybridSequential containers, Dense, Dropout, BatchNorm,
InstanceNorm, LayerNorm, Embedding, Flatten and Lambda/HybridLambda, each
a thin shell over the port's registered ops (``mxtpu_torch/ops``).
"""
from __future__ import annotations

from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "InstanceNorm", "LayerNorm", "Embedding", "Flatten", "Lambda", "HybridLambda"]


class Sequential(Block):
    """Stack of blocks executed in order (reference basic_layers.py:29)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        items = list(self._children.values())
        if isinstance(key, slice):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*items[key])
            return net
        return items[key]

    def __iter__(self):
        return iter(self._children.values())

    def hybridize(self, active=True, **kwargs):
        super().hybridize(active, **kwargs)


class HybridSequential(HybridBlock):
    """Hybridizable Sequential (reference basic_layers.py:87)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        items = list(self._children.values())
        if isinstance(key, slice):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*items[key])
            return net
        return items[key]

    def __iter__(self):
        return iter(self._children.values())


class Dense(HybridBlock):
    """Fully-connected layer (op: ops/nn.py FullyConnected)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._act = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self._act is not None:
            out = F.Activation(out, act_type=self._act)
        return out

    def __repr__(self):
        shape = self.weight.shape
        return "Dense(%s -> %s, %s)" % (
            shape[1] if shape[1] else None, shape[0],
            self._act if self._act else "linear")


class Dropout(HybridBlock):
    """(reference basic_layers.py:238; op: ops/nn.py Dropout)."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)

    def __repr__(self):
        return "Dropout(p = %s, axes=%s)" % (self._rate, self._axes)


class BatchNorm(HybridBlock):
    """(reference basic_layers.py:282; op: ops/nn.py BatchNorm)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self.in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           **self._kwargs)

    def __repr__(self):
        return "BatchNorm(axis=%s, in_channels=%s)" % (
            self._kwargs["axis"], self.in_channels)


class InstanceNorm(HybridBlock):
    """(reference basic_layers.py:374; op: ops/nn.py InstanceNorm, over
    axis 1 as in ``mxtpu``, whose layer passes no axis either)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._eps = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._eps)


class LayerNorm(HybridBlock):
    """(``mxtpu``'s gluon LayerNorm; op: ops/nn.py LayerNorm)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._eps = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._eps)


class Embedding(HybridBlock):
    """(reference basic_layers.py:427; op: ops/nn.py Embedding)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)

    def __repr__(self):
        return "Embedding(%d -> %d, %s)" % (
            self._kwargs["input_dim"], self._kwargs["output_dim"],
            self._kwargs["dtype"])


class Flatten(HybridBlock):
    """(reference basic_layers.py:472; op: flatten)."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return "Flatten"


class Lambda(Block):
    """Wrap an arbitrary nd-function as a Block
    (reference basic_layers.py:487)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd
            function = getattr(nd, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """(reference basic_layers.py:522)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_name = function if isinstance(function, str) else None
        self._func = function if callable(function) else None

    def hybrid_forward(self, F, *args):
        if self._func_name is not None:
            return getattr(F, self._func_name)(*args)
        return self._func(F, *args)
