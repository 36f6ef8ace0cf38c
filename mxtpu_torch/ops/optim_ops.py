"""Optimizer update ops of the PyTorch port.

Counterpart of ``mxtpu/ops/optim_ops.py`` (MXNet's
``src/operator/optimizer_op.*``): ``sgd_update``, ``sgd_mom_update``,
their float16 master-weight forms ``mp_*``, ``adam_update``,
``rmsprop_update``, ``rmspropalex_update``, ``ftml_update``,
``signsgd_update``, ``signum_update`` and ``ftrl_update``, each a
function of tensors returning the new weight and then the new states.
``nd.<op>(..., out=weight)`` writes the new weight into the weight array,
as MXNet's updates do (the call then returns that array); without
``out=`` it returns every output, as ``mxtpu``'s does. ``lr`` may be a
tensor on the device (the fused train step keeps it there), so no update
reads it on the host.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


def _rescale_clip(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _decayed(grad, rescale_grad, clip_gradient, wd, weight):
    return _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight


@register("sgd_update")
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """w - lr * (clip(rescale * g) + wd * w)."""
    return weight - lr * _decayed(grad, rescale_grad, clip_gradient, wd,
                                  weight)


@register("sgd_mom_update", num_outputs=2)
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """mom = momentum * mom - lr * g; w + mom. Returns (w, mom)."""
    g = _decayed(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


@register("mp_sgd_update", num_outputs=2)
def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """SGD on the float32 master copy ``weight32`` of a float16 weight.
    Returns (weight in its dtype, master)."""
    g = _decayed(grad.to(torch.float32), rescale_grad, clip_gradient, wd,
                 weight32)
    new_w32 = weight32 - lr * g
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", num_outputs=3)
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0):
    """Momentum SGD on the float32 master copy. Returns (weight, mom,
    master)."""
    g = _decayed(grad.to(torch.float32), rescale_grad, clip_gradient, wd,
                 weight32)
    new_mom = momentum * mom - lr * g
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("adam_update", num_outputs=3)
def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    """Adam without bias correction (the optimizer folds it into lr).
    Returns (w, mean, var)."""
    g = _decayed(grad, rescale_grad, clip_gradient, wd, weight)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_w, new_mean, new_var


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        return torch.clamp(w, -clip_weights, clip_weights)
    return w


@register("rmsprop_update", num_outputs=2)
def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    """RMSProp (Tieleman & Hinton). Returns (w, n)."""
    g = _decayed(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_w = weight - lr * g / torch.sqrt(new_n + epsilon)
    return _clip_weights(new_w, clip_weights), new_n


@register("rmspropalex_update", num_outputs=4)
def rmspropalex_update(weight, grad, n, g_state, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """RMSProp as in Graves (2013). Returns (w, n, g, delta)."""
    g = _decayed(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_g = (1 - gamma1) * g + gamma1 * g_state
    new_delta = gamma2 * delta - lr * g / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    new_w = _clip_weights(weight + new_delta, clip_weights)
    return new_w, new_n, new_g, new_delta


@register("ftml_update", num_outputs=3)
def ftml_update(weight, grad, d, v, z, lr, t=1, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    """Follow the Moving Leader (Zheng & Kwok, 2017). Returns (w, d, v,
    z): four outputs, as ``mxtpu``'s function returns them."""
    g = _rescale_clip(grad, rescale_grad, clip_grad)
    new_v = beta2 * v + (1 - beta2) * torch.square(g)
    d_t = (1 - beta1 ** t) / lr * (torch.sqrt(new_v / (1 - beta2 ** t))
                                   + epsilon)
    sigma_t = d_t - beta1 * d
    new_z = beta1 * z + (1 - beta1) * g - sigma_t * weight
    new_w = -new_z / d_t - lr * wd * weight
    return new_w, d_t, new_v, new_z


@register("signsgd_update")
def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """w - lr * (sign(g) + wd * w)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register("signum_update", num_outputs=2)
def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """Signum (Bernstein et al., 2018). Returns (w, mom)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * (g + wd * weight)
    new_w = (1 - lr * wd_lh) * weight + lr * torch.sign(new_mom)
    return new_w, new_mom


@register("ftrl_update", num_outputs=3)
def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-Proximal (McMahan et al., 2013). Returns (w, z, n)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) > lamda1,
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd),
        torch.zeros_like(weight))
    return new_w, new_z, new_n
