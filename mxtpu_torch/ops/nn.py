"""Neural-network ops of the PyTorch port.

Counterpart of the serving-path ops of ``mxtpu/ops/nn.py``:
FullyConnected, Activation, softmax, Embedding and the forward of
SoftmaxOutput.
None of them is a Pallas kernel in ``mxtpu`` (XLA lowers them there), so
here they are plain PyTorch: ``torch.matmul`` and ``index_select``.
"""
from __future__ import annotations

import torch

from .registry import register


@register("FullyConnected", aliases=("fully_connected",))
def fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                    flatten=True):
    x = data.reshape(data.shape[0], -1) if flatten else data
    out = torch.matmul(x, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


@register("Activation", aliases=("activation",))
def activation(data, act_type="relu"):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return torch.logaddexp(data, torch.zeros_like(data))
    if act_type == "softsign":
        return data / (1 + torch.abs(data))
    raise ValueError("unknown act_type %r" % act_type)


@register("softmax")
def softmax(data, axis=-1, temperature=None):
    x = data / temperature if temperature else data
    return torch.softmax(x, dim=axis)


@register("Embedding")
def embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    idx = data.reshape(-1).to(torch.int64)
    return weight.index_select(0, idx).reshape(
        tuple(data.shape) + (weight.shape[1],))


@register("SoftmaxOutput", aliases=("Softmax",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Forward of the softmax loss head (the label only matters to the
    backward, which the port does not have yet)."""
    if multi_output:
        return torch.softmax(data, dim=1)
    if preserve_shape:
        return torch.softmax(data, dim=-1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)
