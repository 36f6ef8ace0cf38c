"""Contrib ops of the PyTorch port: 8-bit quantization, FFT and count
sketch.

Counterpart of ``mxtpu/ops/contrib_ops.py`` (MXNet's
``src/operator/contrib/``): ``_contrib_quantize`` /
``_contrib_dequantize`` (linear int8/uint8 over a calibration range),
``_contrib_fft`` / ``_contrib_ifft`` (the last axis, complex values
packed as interleaved (real, imag) pairs; the inverse unnormalized) and
``_contrib_count_sketch``. Reached as ``nd.contrib.quantize`` and so on.
"""
from __future__ import annotations

import torch

from ..base import canonical_dtype
from .registry import register

__all__ = []

_QRANGE = {"uint8": (0.0, 255.0, torch.uint8),
           "int8": (-127.0, 127.0, torch.int8)}


@register("_contrib_quantize", aliases=("quantize",), num_outputs=3,
          differentiable=False)
def quantize(data, min_range, max_range, out_type="uint8"):
    """``data`` linearly quantized over [min(min_range), max(max_range)]:
    (q, min, max)."""
    if out_type not in _QRANGE:
        raise ValueError("out_type must be int8/uint8")
    qmin, qmax, dt = _QRANGE[out_type]
    lo, hi = torch.min(min_range), torch.max(max_range)
    scale = (qmax - qmin) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp(torch.round((data - lo) * scale + qmin), qmin, qmax)
    return q.to(dt), lo.reshape(1), hi.reshape(1)


@register("_contrib_dequantize", aliases=("dequantize",),
          differentiable=False)
def dequantize(data, min_range, max_range, out_type="float32"):
    """The inverse of :func:`quantize`: uint8 over [0, 255], int8 over
    [-127, 127]."""
    lo, hi = torch.min(min_range), torch.max(max_range)
    qmin, qmax = (0.0, 255.0) if data.dtype == torch.uint8 \
        else (-127.0, 127.0)
    scale = torch.clamp(hi - lo, min=1e-12) / (qmax - qmin)
    out = (data.to(torch.float32) - qmin) * scale + lo
    return out.to(canonical_dtype(out_type))


@register("_contrib_fft", aliases=("fft",))
def fft(data, compute_size=128):
    """FFT of the last axis, (real, imag) interleaved: n -> 2n values."""
    out = torch.fft.fft(data.to(torch.complex64), dim=-1)
    packed = torch.stack([out.real, out.imag], dim=-1)
    return packed.reshape(tuple(data.shape[:-1]) + (2 * data.shape[-1],))


@register("_contrib_ifft", aliases=("ifft",))
def ifft(data, compute_size=128):
    """Inverse FFT of interleaved (real, imag) input, times n: the real
    part (MXNet's unnormalized convention)."""
    n = data.shape[-1] // 2
    pairs = data.reshape(tuple(data.shape[:-1]) + (n, 2))
    cplx = torch.complex(pairs[..., 0].to(torch.float32),
                         pairs[..., 1].to(torch.float32))
    return (torch.fft.ifft(cplx, dim=-1) * n).real


@register("_contrib_count_sketch", aliases=("count_sketch",))
def count_sketch(data, h, s, out_dim=0, processing_batch_size=32):
    """Count sketch projection: ``out[:, h[j]] += s[j] * data[:, j]``."""
    hh = h.reshape(-1).to(torch.int64)
    contrib = data * s.reshape(1, -1).to(data.dtype)
    out = torch.zeros((data.shape[0], int(out_dim)), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, hh, contrib)
