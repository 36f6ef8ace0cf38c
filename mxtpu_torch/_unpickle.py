"""Loading pickles that ``mxtpu`` wrote, without ``mxtpu`` or JAX.

A Gluon trainer's states (``Updater.get_states(dump_optimizer=True)``,
what ``CheckpointManager.save`` and ``Trainer.save_states`` store)
pickle the optimizer itself, and with it its ``param_dict``: the
``Parameter``\\ s, their ``NDArray``\\ s and the JAX arrays inside. A
plain ``pickle.loads`` of such bytes would import ``mxtpu`` and JAX.
:func:`loads` unpickles through a ``find_class`` that maps each
``mxtpu.<module>.<Name>`` to the port's class of that name, and a JAX
array to the numpy array its pickle holds. What crosses:

- the optimizers and LR schedulers (``mxtpu.optimizer``,
  ``mxtpu.lr_scheduler``): their attributes, over a fresh instance of
  the port's class (so the port's own attributes keep their defaults);
- ``Parameter``, ``Context``, the initializers: their attributes;
- a dense ``NDArray``: its values, as a port ``NDArray`` on the CPU;
- a JAX array (``jax._src.array._reconstruct_array``): its values, as
  the numpy array that its pickle carries.

Anything else of ``mxtpu`` or JAX (a sparse array, a class the port does
not have, a bfloat16 array, whose numpy dtype lives in ``ml_dtypes``)
raises :class:`PickleCrossingError`, naming it. Nothing here imports
``mxtpu`` or JAX.
"""
from __future__ import annotations

import importlib
import io
import pickle

import numpy as _np

__all__ = ["PickleCrossingError", "loads"]

_PORT_MODULES = {"mxtpu.optimizer": "mxtpu_torch.optimizer",
                 "mxtpu.lr_scheduler": "mxtpu_torch.lr_scheduler",
                 "mxtpu.gluon.parameter": "mxtpu_torch.gluon.parameter",
                 "mxtpu.context": "mxtpu_torch.context",
                 "mxtpu.ndarray": "mxtpu_torch.ndarray",
                 "mxtpu.initializer": "mxtpu_torch.initializer"}


class PickleCrossingError(pickle.UnpicklingError):
    """A pickle written by ``mxtpu`` holds an object that the port cannot
    rebuild without importing ``mxtpu`` or JAX."""


def _numpy_from_jax(fun, args, arr_state, aval_state):
    """What ``jax.Array.__reduce__`` stores: numpy's own reconstruction
    of the array's host value (``fun(*args)`` and its state)."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return value


def _attributes(state):
    if isinstance(state, tuple):            # (dict, slots)
        merged = dict(state[0] or {})
        merged.update(state[1] or {})
        return merged
    return dict(state or {})


def _crossing_class(port_cls):
    """A subclass whose ``__setstate__`` takes ``mxtpu``'s attributes and
    turns the instance into ``port_cls``."""
    from .ndarray import NDArray
    from .optimizer import Optimizer

    if issubclass(port_cls, NDArray):
        if port_cls is not NDArray:
            raise PickleCrossingError(
                "a pickled mxtpu %s cannot be loaded by the port (only "
                "dense NDArrays cross)" % port_cls.__name__)

        def setstate(self, state):
            import torch
            from .context import cpu
            data = _np.array(_attributes(state).get("_data"))
            self.__class__ = NDArray
            NDArray.__init__(self, torch.from_numpy(data), cpu())
        return type(port_cls.__name__, (port_cls,),
                    {"__slots__": (), "__setstate__": setstate})

    def setstate(self, state):
        self.__class__ = port_cls
        if issubclass(port_cls, Optimizer):
            self.__dict__.update(port_cls().__dict__)
        self.__dict__.update(_attributes(state))
    return type(port_cls.__name__, (port_cls,), {"__setstate__": setstate})


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "jax._src.array" and name == "_reconstruct_array":
            return _numpy_from_jax
        root = module.split(".", 1)[0]
        if root in ("mxtpu", "jax", "jaxlib", "ml_dtypes"):
            port_module = _PORT_MODULES.get(module)
            port_cls = getattr(importlib.import_module(port_module), name,
                               None) if port_module else None
            if not isinstance(port_cls, type):
                raise PickleCrossingError(
                    "the pickle holds %s.%s, which the port cannot load "
                    "without importing %s" % (module, name, root))
            return _crossing_class(port_cls)
        return super().find_class(module, name)


def loads(data):
    """``pickle.loads`` of ``data``, with ``mxtpu``'s classes mapped to the
    port's (see the module's docstring)."""
    return _Unpickler(io.BytesIO(bytes(data))).load()
