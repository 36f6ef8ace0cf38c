"""Gluon convolution and pooling layers of the PyTorch port.

Counterpart of ``mxtpu/gluon/nn/conv_layers.py``: Conv1D/2D/3D over the
port's ``Convolution`` (cuDNN on the card), Conv1D/2D/3DTranspose over
its ``Deconvolution`` (``output_padding`` is MXNet's ``adj``; the weight
is (in, out / groups, *kernel), as ``mxtpu`` gives it) and the Max/Avg
pooling layers with their Global variants over ``Pooling``,
NC(D)(H)W.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D"]


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    """Shared conv shell (reference conv_layers.py:30 _Conv)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution",
                 adj=None, **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._in_channels = in_channels
        ndim = len(kernel_size)
        self._op_name = op_name
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups}
        if adj is not None:
            self._kwargs["adj"] = adj
        self._act = activation
        if op_name == "Convolution":
            wshape = (channels, in_channels // groups
                      if in_channels else 0) + kernel_size
        else:  # Deconvolution: weight layout (in, out/group, *kernel)
            wshape = (in_channels, channels // groups) + kernel_size
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        out = op(x, weight, bias, no_bias=bias is None, **self._kwargs)
        if self._act is not None:
            out = F.Activation(out, act_type=self._act)
        return out

    def __repr__(self):
        return "%s(%s, kernel_size=%s, stride=%s)" % (
            self.__class__.__name__, self._channels,
            self._kwargs["kernel"], self._kwargs["stride"])


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 1), _tuple(strides, 1),
                         _tuple(padding, 1), _tuple(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 2), _tuple(strides, 2),
                         _tuple(padding, 2), _tuple(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 3), _tuple(strides, 3),
                         _tuple(padding, 3), _tuple(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 1), _tuple(strides, 1),
                         _tuple(padding, 1), _tuple(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tuple(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 2), _tuple(strides, 2),
                         _tuple(padding, 2), _tuple(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tuple(output_padding, 2), **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 3), _tuple(strides, 3),
                         _tuple(padding, 3), _tuple(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tuple(output_padding, 3), **kwargs)


class _Pooling(HybridBlock):
    """(reference conv_layers.py:691 _Pooling)."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return "%s(size=%s, stride=%s, padding=%s)" % (
            self.__class__.__name__, self._kwargs["kernel"],
            self._kwargs["stride"], self._kwargs["pad"])


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 1),
                         _tuple(strides, 1) if strides is not None else None,
                         _tuple(padding, 1), ceil_mode, False, "max", **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 2),
                         _tuple(strides, 2) if strides is not None else None,
                         _tuple(padding, 2), ceil_mode, False, "max", **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 3),
                         _tuple(strides, 3) if strides is not None else None,
                         _tuple(padding, 3), ceil_mode, False, "max", **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_tuple(pool_size, 1),
                         _tuple(strides, 1) if strides is not None else None,
                         _tuple(padding, 1), ceil_mode, False, "avg",
                         count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuple(pool_size, 2),
                         _tuple(strides, 2) if strides is not None else None,
                         _tuple(padding, 2), ceil_mode, False, "avg",
                         count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuple(pool_size, 3),
                         _tuple(strides, 3) if strides is not None else None,
                         _tuple(padding, 3), ceil_mode, False, "avg",
                         count_include_pad, **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "max", **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "max", **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "max",
                         **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, (0,), True, True, "avg", **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg", **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), True, True, "avg",
                         **kwargs)
