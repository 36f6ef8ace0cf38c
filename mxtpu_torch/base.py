"""Base types, dtype mapping and the error class of the PyTorch port.

Counterpart of ``mxtpu/base.py``: the same error type and dtype
vocabulary, with ``torch.dtype`` in place of numpy/JAX dtypes. Dtype
NAMES ("float32", "bfloat16", ...) are what crosses between the two
packages (symbol JSON, checkpoints), so both directions of the mapping
live here.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "MXTPUError", "CaptureRefused", "canonical_dtype",
           "dtype_name", "is_capture_refusal", "numpy_dtype"]


class MXTPUError(RuntimeError):
    """Framework error (same role as ``mxtpu.base.MXTPUError``)."""


MXNetError = MXTPUError


class CaptureRefused(MXTPUError):
    """A custom op's Python body did what a CUDA graph cannot hold (a
    read of the card from the host, say) while a train step was being
    captured. ``op`` names the op; the message gives torch's reason."""

    def __init__(self, op, reason):
        super().__init__("custom op %r cannot be captured in a CUDA graph: "
                         "%s" % (op, reason))
        self.op = op
        self.reason = reason


# How torch and CUDA word a refusal to record a host read into a CUDA
# graph: torch refuses a copy to unpinned host memory before it reaches
# CUDA; CUDA refuses a stream or device wait (``item()``, ``synchronize``)
# and then fails the rest of the capture.
_CAPTURE_REFUSALS = ("during CUDA graph capture",
                     "cudaErrorStreamCaptureUnsupported",
                     "cudaErrorStreamCaptureInvalidated")


def is_capture_refusal(exc):
    """True when ``exc`` is torch's or CUDA's refusal of a host read (a
    copy to the host, a wait for the card) while a CUDA graph is being
    captured; any other error is a fault of its own."""
    return any(s in str(exc) for s in _CAPTURE_REFUSALS)

_NAME_TO_DTYPE = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_ALIASES = {"float": "float32", "double": "float64", "half": "float16"}
_DTYPE_TO_NAME = {v: k for k, v in _NAME_TO_DTYPE.items()}


def canonical_dtype(dtype):
    """Normalise a dtype spec (name, numpy dtype, torch dtype, None) to a
    ``torch.dtype``; None means float32, as in ``mxtpu``."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        if dtype not in _DTYPE_TO_NAME:
            raise TypeError("unsupported dtype %r" % (dtype,))
        return dtype
    name = getattr(dtype, "name", None) if not isinstance(dtype, str) \
        else dtype
    if name is None:
        name = np.dtype(dtype).name
    name = _ALIASES.get(name, name)
    if name not in _NAME_TO_DTYPE:
        raise TypeError("unsupported dtype %r" % (dtype,))
    return _NAME_TO_DTYPE[name]


def dtype_name(dtype):
    """The dtype's name as both packages write it ("float32", ...)."""
    return _DTYPE_TO_NAME[canonical_dtype(dtype)]


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype; bfloat16 has none in numpy."""
    name = dtype_name(dtype)
    if name == "bfloat16":
        raise TypeError("numpy has no bfloat16; cast to float32 first")
    return np.dtype(name)


def _as_list(obj):
    """Return obj as a list (None -> [])."""
    if obj is None:
        return []
    if isinstance(obj, (list, tuple)):
        return list(obj)
    return [obj]
