"""mxtpu_torch — the PyTorch/CUDA port of mxtpu for NVIDIA Hopper.

The same public names as ``mxtpu`` (``mx.nd``, ``mx.sym``, ``mx.mod``
with ``Module.fit`` and ``BucketingModule``, ``mx.io``, ``mx.init``,
``mx.optimizer``, ``mx.metric``, ``mx.kv``, ``mx.callback``,
``mx.monitor``, ``mx.lr_scheduler``, ``mx.random``, ``mx.recordio``, ``mx.image``
(the record pipeline behind ``mx.io.ImageRecordIter``), ``mx.rnn`` (the cells and
``BucketSentenceIter``), ``mx.serving``, ``mx.parallel``,
``mx.autograd``, ``mx.engine``, ``mx.operator`` custom ops, ``mx.rtc``,
``mx.gluon`` (blocks, ``hybridize``, Trainer, layers, losses, data,
model zoo, fused RNN layers),
contexts, checkpoints),
computed with PyTorch: plain tensor code in torch, and every kernel that
``mxtpu`` wrote in Pallas for the TPU hand-written in CUDA C++ for
``sm_90a`` under ``csrc/``, built at first use
(:mod:`mxtpu_torch._build`); a user's own kernels are CUDA C compiled at
run time by ``mx.rtc.CudaModule`` (NVRTC). Entry points run on
``gpu(0)`` (``cuda:0``) unless the caller passes ``ctx=cpu()``.
The port imports neither JAX nor ``mxtpu``.
"""
from __future__ import annotations

__version__ = "0.1.0"

from .base import MXNetError, MXTPUError
from .context import Context, cpu, gpu, current_context, num_gpus
from . import ops
from . import engine
from . import autograd
from . import ndarray
from . import ndarray as nd
from . import symbol
from . import symbol as sym
from . import random
from . import lr_scheduler
from . import io
from . import recordio
from . import image
from . import initializer
from . import initializer as init
from . import optimizer
from . import metric
from . import kvstore
from . import kvstore as kv
from . import executor
from . import rnn
from . import model
from . import callback
from . import monitor
from . import module
from . import module as mod
from . import serving
from . import parallel
from . import operator
from . import rtc
from . import gluon
from . import checkpoint
from .ndarray import NDArray
from .attribute import AttrScope
from .symbol import Symbol
from .executor import Executor

__all__ = ["MXNetError", "MXTPUError", "Context", "cpu", "gpu",
           "current_context", "num_gpus", "ops", "ndarray", "nd", "symbol",
           "sym", "random", "lr_scheduler", "io", "recordio", "image",
           "initializer", "init",
           "optimizer", "metric", "kvstore", "kv", "executor", "rnn",
           "model", "callback", "monitor", "module", "mod", "serving", "parallel",
           "engine", "autograd", "operator", "rtc", "gluon", "NDArray",
           "AttrScope", "Symbol", "Executor"]
