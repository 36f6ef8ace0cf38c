"""Inference engine of the PyTorch port: per-bucket predict programs.

Counterpart of ``mxtpu/serving/engine.py``'s predict menu. A fixed menu
of batch sizes (the buckets); a request pads into the smallest bucket
that holds it and its outputs are sliced back to its rows. Where
``mxtpu`` compiles each bucket's forward ahead of time into one XLA
program, the port, which runs eagerly, prepares a closure per bucket:
shapes resolved, loss-head leftovers allocated on the device, and on a
CUDA context the hand-written kernels built before the first request.
Programs live in a :class:`~mxtpu_torch.module.fused.ProgramCache`,
whose ``compiles``/``hits`` keep their meaning: ``compiles`` equals the
number of buckets after :meth:`InferenceEngine.warm` and does not move
while requests are answered.

The engine runs on ``gpu(0)`` (``cuda:0``) unless the caller passes
``ctx=cpu()``; on a host without CUDA, a GPU context raises. Weights live
in per-version stores: :meth:`InferenceEngine.swap_weights` installs a
new version with the same names and shapes, and a request's version is
resolved once, so one batch is answered by one version.

A graph whose head is a ``Custom`` op (a classifier with a custom
softmax-with-loss head, say) serves as any other: the prop's shape hint
names the label argument's shape, which is fed as zeros, and the op runs
on the engine's device, where it may launch ``mx.rtc`` kernels.

Generation, sharded serving, canaries and program export wait for a
later slice.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

from ..base import canonical_dtype, dtype_name
from ..context import current_context
from ..module.fused import ProgramCache
from ..symbol import eval_graph

__all__ = ["InferenceEngine", "parse_buckets"]


def parse_buckets(spec):
    """``MXTPU_SERVE_BUCKETS`` grammar: comma-separated batch sizes,
    e.g. ``1,2,4,8,16,32`` — sorted, deduped, all positive."""
    sizes = sorted({int(b) for b in str(spec).split(",") if b.strip()})
    if not sizes or sizes[0] < 1:
        raise ValueError("bucket spec %r needs positive batch sizes"
                         % (spec,))
    return tuple(sizes)


class InferenceEngine:
    """Per-bucket predict programs over one loaded model."""

    _KEEP_VERSIONS = 2

    def __init__(self, symbol, arg_params, aux_params, data_shapes,
                 buckets=(1, 2, 4, 8, 16, 32), ctx=None, dtype="float32",
                 warm=True):
        self._symbol = symbol
        self._ctx = ctx if ctx is not None else current_context()
        self._dev = self._ctx.torch_device()
        self._buckets = parse_buckets(
            buckets if isinstance(buckets, str)
            else ",".join(str(b) for b in buckets))
        self._dtype = canonical_dtype(dtype)
        self._data_names = tuple(sorted(data_shapes))
        self._sample_shapes = {n: tuple(data_shapes[n])
                               for n in self._data_names}
        arg_names = symbol.list_arguments()
        missing = [n for n in self._data_names if n not in arg_names]
        if missing:
            raise ValueError("data inputs %r are not arguments of the "
                             "symbol (args: %r)" % (missing, arg_names))
        # serving inputs, checkpoint parameters, and loss-head leftovers
        # (label vars of a training head, fed as zeros per bucket)
        self._param_names = tuple(n for n in arg_names
                                  if n not in self._data_names
                                  and n in arg_params)
        self._extra_names = tuple(n for n in arg_names
                                  if n not in self._data_names
                                  and n not in arg_params)
        self._aux_names = tuple(symbol.list_auxiliary_states())
        param_vals = tuple(self._put(arg_params[n])
                           for n in self._param_names)
        aux_vals = tuple(self._put(aux_params[n]) for n in self._aux_names)
        self._param_specs = tuple((tuple(v.shape), v.dtype)
                                  for v in param_vals)
        self._store_lock = threading.Lock()
        self._stores = {0: (param_vals, aux_vals)}
        self._stable = 0
        self.cache = ProgramCache()
        self._stats_lock = threading.Lock()
        self._stats = {"predicts": 0, "rows": 0, "pad_rows": 0, "swaps": 0}
        if warm:
            self.warm()

    def _put(self, v):
        """One parameter on the engine's device: an NDArray or tensor
        keeps its dtype, anything else goes through numpy."""
        if hasattr(v, "data") and isinstance(v.data, torch.Tensor):
            v = v.data
        if not isinstance(v, torch.Tensor):
            host = v.asnumpy() if hasattr(v, "asnumpy") else _np.asarray(v)
            v = torch.from_numpy(_np.array(host, order="C"))
        return v.to(self._dev).contiguous()

    # -- construction ------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, prefix, epoch, data_shapes, **kw):
        """Load a ``save_checkpoint`` artifact (symbol json + params),
        written by either package, into a ready engine."""
        from ..context import cpu
        from ..model import load_checkpoint
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch,
                                                         ctx=cpu())
        return cls(symbol, arg_params, aux_params, data_shapes, **kw)

    # -- introspection -----------------------------------------------------
    @property
    def buckets(self):
        return self._buckets

    @property
    def max_bucket(self):
        return self._buckets[-1]

    @property
    def data_names(self):
        return self._data_names

    @property
    def device(self):
        return self._dev

    def stats(self):
        with self._stats_lock:
            out = dict(self._stats)
        out.update(self.cache.stats())
        with self._store_lock:
            out["version"] = self._stable
            out["versions"] = sorted(self._stores)
        return out

    # -- versioned weights -------------------------------------------------
    def swap_weights(self, arg_params):
        """Install ``arg_params`` (every checkpoint parameter, same shapes)
        as the next weight version and make it the one requests use; aux
        states carry over. The programs take weights as arguments, so a
        swap rebuilds nothing. Returns the version installed."""
        vals = []
        for name, (shape, dtype) in zip(self._param_names,
                                        self._param_specs):
            if name not in arg_params:
                raise ValueError("weight swap is missing param %r" % name)
            v = self._put(arg_params[name]).to(dtype)
            if tuple(v.shape) != shape:
                raise ValueError("weight swap: param %r has shape %r, the "
                                 "engine serves %r"
                                 % (name, tuple(v.shape), shape))
            vals.append(v)
        with self._store_lock:
            v = max(self._stores) + 1
            self._stores[v] = (tuple(vals), self._stores[self._stable][1])
            self._stable = v
            for old in sorted(self._stores)[:-self._KEEP_VERSIONS]:
                del self._stores[old]
        with self._stats_lock:
            self._stats["swaps"] += 1
        return v

    def _resolve_store(self, version):
        with self._store_lock:
            v = self._stable if version is None else int(version)
            if v not in self._stores:
                raise ValueError("weight version %d is not resident (have "
                                 "%r)" % (v, sorted(self._stores)))
            params, aux = self._stores[v]
        return params, aux, v

    # -- requests ----------------------------------------------------------
    def check_rows(self, arrays):
        """Validate one request payload (one numpy array per data input,
        in ``data_names`` order). Returns the row count."""
        if len(arrays) != len(self._data_names):
            raise ValueError(
                "payload has %d arrays, model takes %d inputs %r"
                % (len(arrays), len(self._data_names), self._data_names))
        rows = None
        for name, arr in zip(self._data_names, arrays):
            arr = _np.asarray(arr)
            want = self._sample_shapes[name]
            if arr.ndim != len(want) + 1 or tuple(arr.shape[1:]) != want:
                raise ValueError("input %r has shape %r, want (rows,)+%r"
                                 % (name, tuple(arr.shape), want))
            if rows is None:
                rows = int(arr.shape[0])
            elif int(arr.shape[0]) != rows:
                raise ValueError("inputs disagree on rows: %r has %d, "
                                 "expected %d" % (name, arr.shape[0], rows))
        if rows == 0:
            raise ValueError("empty request (0 rows)")
        if rows > self.max_bucket:
            raise ValueError("request rows %d exceed the largest bucket %d"
                             % (rows, self.max_bucket))
        return rows

    def bucket_for(self, rows):
        """Smallest configured bucket holding ``rows``."""
        for b in self._buckets:
            if rows <= b:
                return b
        raise ValueError("rows %d exceed the largest bucket %d"
                         % (rows, self.max_bucket))

    # -- programs ----------------------------------------------------------
    def _extra_shapes(self, bucket):
        """``(name, shape)`` of the non-data, non-parameter arguments for
        ``bucket`` (label vars of a training head), by shape inference."""
        if not self._extra_names:
            return ()
        kwargs = {n: (bucket,) + self._sample_shapes[n]
                  for n in self._data_names}
        arg_shapes, _outs, _aux = self._symbol.infer_shape(**kwargs)
        by_name = dict(zip(self._symbol.list_arguments(), arg_shapes))
        bad = [n for n in self._extra_names if by_name.get(n) is None]
        if bad:
            raise ValueError("symbol arguments %r are neither checkpoint "
                             "parameters nor data inputs, and their shapes "
                             "cannot be inferred" % (bad,))
        return tuple((n, tuple(by_name[n])) for n in self._extra_names)

    def _build_program(self, bucket):
        """The bucket's forward as a closure over the resolved graph."""
        data_names, param_names = self._data_names, self._param_names
        aux_names, dev = self._aux_names, self._dev
        outputs_ref = self._symbol._outputs
        extra = {n: torch.zeros(s, dtype=self._dtype, device=dev)
                 for n, s in self._extra_shapes(bucket)}

        def program(data_vals, param_vals, aux_vals):
            feed = dict(zip(param_names, param_vals))
            feed.update(zip(aux_names, aux_vals))
            feed.update(zip(data_names, data_vals))
            feed.update(extra)
            with torch.inference_mode():
                outs, _aux_updates = eval_graph(outputs_ref, feed, False,
                                                device=dev)
            return outs

        return program

    def program(self, bucket):
        """The prepared program for ``bucket`` (cached)."""
        if bucket not in self._buckets:
            raise ValueError("no bucket %d (configured: %r)"
                             % (bucket, self._buckets))
        program, _hit = self.cache.get(
            ("predict", bucket), lambda: self._build_program(bucket))
        return program

    def warm(self):
        """Prepare every bucket program now, and on a CUDA context build
        the kernels, so that no request pays for either. Returns the
        number of programs."""
        if self._dev.type == "cuda":
            from .._build import build_all
            build_all()
        for b in self._buckets:
            self.program(b)
        return len(self._buckets)

    # -- execution ---------------------------------------------------------
    def predict(self, arrays, rows=None):
        """Pad ``arrays`` into the smallest bucket, run its program on the
        current weights and return numpy outputs sliced to ``rows``."""
        outs, _v = self.predict_versioned(arrays, rows=rows)
        return outs

    def predict_versioned(self, arrays, rows=None, version=None):
        """As :meth:`predict`, against weight ``version`` (None: the
        current one); returns ``(outputs, answered_version)``."""
        if rows is None:
            rows = self.check_rows(arrays)
        bucket = self.bucket_for(rows)
        program = self.program(bucket)
        param_vals, aux_vals, answered = self._resolve_store(version)
        np_dtype = _np.float32 if self._dtype == torch.bfloat16 \
            else _np.dtype(dtype_name(self._dtype))
        data_vals = []
        for name, arr in zip(self._data_names, arrays):
            padded = _np.zeros((bucket,) + self._sample_shapes[name],
                               np_dtype)
            padded[:rows] = _np.asarray(arr)[:rows]
            data_vals.append(torch.from_numpy(padded)
                             .to(self._dev).to(self._dtype))
        outs = program(tuple(data_vals), param_vals, aux_vals)
        with self._stats_lock:
            self._stats["predicts"] += 1
            self._stats["rows"] += rows
            self._stats["pad_rows"] += bucket - rows
        return [_host(o[:rows]) for o in outs], answered


def _host(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
