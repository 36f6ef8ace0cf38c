"""MobileNet (reference python/mxnet/gluon/model_zoo/vision/mobilenet.py).
Depthwise-separable convolutions are grouped convolutions of the port's
``Convolution`` (cuDNN on the card)."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["MobileNet", "mobilenet1_0", "mobilenet0_75", "mobilenet0_5",
           "mobilenet0_25", "get_mobilenet"]


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm(scale=True))
    out.add(nn.Activation("relu"))


def _add_conv_dw(out, dw_channels, channels, stride):
    _add_conv(out, channels=dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels)
    _add_conv(out, channels=channels)


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                _add_conv(self.features, channels=int(32 * multiplier),
                          kernel=3, pad=1, stride=2)
                dw_channels = [int(x * multiplier) for x in
                               [32, 64] + [128] * 2 + [256] * 2
                               + [512] * 6 + [1024]]
                channels = [int(x * multiplier) for x in
                            [64] + [128] * 2 + [256] * 2 + [512] * 6
                            + [1024] * 2]
                strides = [1, 2, 1, 2, 1, 2] + [1] * 5 + [2, 1]
                for dwc, c, s in zip(dw_channels, channels, strides):
                    _add_conv_dw(self.features, dw_channels=dwc, channels=c,
                                 stride=s)
                self.features.add(nn.GlobalAvgPool2D())
                self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


def get_mobilenet(multiplier, pretrained=False, ctx=None, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights are unavailable offline")
    return MobileNet(multiplier, **kwargs)


def mobilenet1_0(**kwargs):
    return get_mobilenet(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return get_mobilenet(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return get_mobilenet(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return get_mobilenet(0.25, **kwargs)
