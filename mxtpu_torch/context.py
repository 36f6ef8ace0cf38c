"""Device context model of the PyTorch port.

Counterpart of ``mxtpu/context.py``. A :class:`Context` names a
``torch.device``: ``gpu(i)`` is ``cuda:i`` and ``cpu()`` is the host.
The default context is ``gpu(0)`` — the port's entry points run on the
card unless the caller asks for the CPU. Resolving a GPU context on a
host without CUDA raises; nothing moves to the CPU on its own.
"""
from __future__ import annotations

import threading

import torch

from .base import MXTPUError

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus"]


class Context:
    """A device context (device_type, device_id) resolving to a
    ``torch.device``."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared"}
    devstr2type = {v: k for k, v in devtype2str.items()}

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in self.devstr2type:
                raise ValueError("unknown device type %r" % (device_type,))
            self.device_typeid = self.devstr2type[device_type]
            self.device_id = device_id
        self._old_ctx = None

    @property
    def device_type(self):
        return self.devtype2str[self.device_typeid]

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def torch_device(self):
        """The ``torch.device`` this context names. A GPU context on a
        host without CUDA (or past its device count) raises."""
        if self.device_type != "gpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXTPUError(
                "context gpu(%d) needs a CUDA device and this host has "
                "none; pass ctx=cpu() to run on the CPU" % self.device_id)
        if self.device_id >= torch.cuda.device_count():
            raise MXTPUError("gpu(%d) does not exist (%d CUDA devices)"
                             % (self.device_id, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)

    # -- scope protocol (with mx.Context(...):) ---------------------------
    def __enter__(self):
        self._old_ctx = Context.default_ctx()
        Context._default_ctx.value = self
        return self

    def __exit__(self, *args):
        Context._default_ctx.value = self._old_ctx

    @classmethod
    def default_ctx(cls):
        if not hasattr(cls._default_ctx, "value"):
            cls._default_ctx.value = Context("gpu", 0)
        return cls._default_ctx.value


def cpu(device_id=0):
    """Return a CPU context."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """Return a CUDA context (``cuda:device_id``)."""
    return Context("gpu", device_id)


def num_gpus():
    return torch.cuda.device_count()


def current_context():
    """The default context of the current scope: ``gpu(0)`` unless a
    ``with ctx:`` scope says otherwise."""
    return Context.default_ctx()
