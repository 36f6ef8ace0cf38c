"""Runtime-compiled CUDA kernels: ``mx.rtc.CudaModule`` on NVRTC.

Counterpart of ``mxtpu/rtc.py``, whose ``PallasModule`` (also bound as
``CudaModule``) runs kernel bodies written in Python for Pallas. On the
card the source is CUDA C, as in reference MXNet: NVRTC compiles it at
the first launch into a CUBIN for the card (``sm_90a`` on Hopper) and
``cuLaunchKernel`` runs it on NDArrays, on torch's current stream::

    mod = mx.rtc.CudaModule(r'''
    extern "C" __global__ void axpy(const float *x, const float *y,
                                    float alpha, float *out, int n) {
        int i = blockIdx.x * blockDim.x + threadIdx.x;
        if (i < n) out[i] = alpha * x[i] + y[i];
    }''')
    k = mod.get_kernel("axpy", "const float *x, const float *y, "
                               "float alpha, float *out, int n")
    k.launch((x, y, 3.0, out, 8), mx.gpu(0), (1, 1, 1), (8, 1, 1))

The protocol (module -> get_kernel -> launch), the signature grammar and
its errors are ``mxtpu``'s: ``const T *name`` is an input array, ``T
*name`` an output array, ``T name`` a scalar, for ``T`` in ``float double
half __half uint8_t int int32_t int8_t char int64_t``. What differs:

- the source is CUDA C, not Python for Pallas;
- kernels run only on a ``gpu`` context; a ``cpu`` one raises, as in
  reference MXNet;
- ``block_dims`` and ``shared_mem`` are CUDA's own. The default block
  ``(1, 1, 1)`` gives Pallas's model, one program per grid point, with
  ``blockIdx`` in place of ``pl.program_id``;
- scalars, int ones included, go by value as kernel arguments: a new
  value compiles nothing. (The JAX package keys a recompile on each int
  scalar, which it keeps static.) A module compiles once, at its first
  launch (``CudaModule.compiles``).

An array whose dtype is not the declared one, or that is not contiguous,
goes to the kernel as a converted contiguous copy; for an output, the
result is copied back into the caller's NDArray on the stream (the JAX
package's cast-and-rebind). Other outputs are written in place.
``launch`` returns the output NDArrays. There is no fallback: a failed
compile or launch raises :class:`MXTPUError`.
"""
from __future__ import annotations

import ctypes
import re
import threading
import time

import numpy as _np
import torch

from . import _nvrtc
from .base import MXTPUError, canonical_dtype
from .context import Context
from .ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel"]

_DTYPES = {
    "float": _np.float32, "double": _np.float64, "__half": _np.float16,
    "half": _np.float16, "uint8_t": _np.uint8, "int": _np.int32,
    "int32_t": _np.int32, "int8_t": _np.int8, "char": _np.int8,
    "int64_t": _np.int64,
}

# the C type each scalar travels as (a half as its 16 bits)
_CTYPES = {_np.float32: ctypes.c_float, _np.float64: ctypes.c_double,
           _np.float16: ctypes.c_uint16, _np.uint8: ctypes.c_uint8,
           _np.int32: ctypes.c_int32, _np.int8: ctypes.c_int8,
           _np.int64: ctypes.c_int64}


class _Param:
    __slots__ = ("name", "dtype", "is_ndarray", "is_const")

    def __init__(self, name, dtype, is_ndarray, is_const):
        self.name = name
        self.dtype = dtype
        self.is_ndarray = is_ndarray
        self.is_const = is_const


def _parse_signature(signature):
    params = []
    for tok in signature.split(","):
        tok = tok.strip()
        if not tok:
            continue
        is_const = False
        if tok.startswith("const "):
            is_const = True
            tok = tok[len("const "):].strip()
        is_ptr = "*" in tok
        tok = tok.replace("*", " ")
        parts = tok.split()
        if len(parts) != 2:
            raise ValueError("invalid function prototype: %r (expect "
                             "'[const] type [*] name')" % tok)
        tname, name = parts
        if tname not in _DTYPES:
            raise ValueError("unknown type %r in signature (supported: %s)"
                             % (tname, sorted(_DTYPES)))
        params.append(_Param(name, _DTYPES[tname], is_ptr, is_const))
    return params


def _pack_scalar(param, value):
    """``value`` as the C argument of scalar ``param``: converted by
    numpy's rules for the declared type, as the JAX package does."""
    v = param.dtype(value)
    if param.dtype is _np.float16:
        return ctypes.c_uint16(int(_np.asarray(v).view(_np.uint16)))
    return _CTYPES[param.dtype](v.item())


_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_LAUNCH_BOUNDS = re.compile(r"__launch_bounds__\s*\([^)]*\)")
_GLOBAL = re.compile(r"__global__\s+(?:\w+[\s*&]+)*?(\w+)\s*\(")
_EXTERN_C_BLOCK = re.compile(r'extern\s+"C"\s*\{')
_EXTERN_C_DECL = re.compile(r'extern\s+"C"\s*$')


def _kernels(source):
    """``{name: is_extern_c}`` of the ``__global__`` functions in
    ``source``, in order of definition."""
    src = _LAUNCH_BOUNDS.sub(" ", _COMMENT.sub(" ", source))
    blocks = []
    for m in _EXTERN_C_BLOCK.finditer(src):
        depth, i = 1, m.end()
        while i < len(src) and depth:
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            i += 1
        blocks.append((m.end(), i))
    found = {}
    for m in _GLOBAL.finditer(src):
        extern_c = bool(_EXTERN_C_DECL.search(src[:m.start()])) or \
            any(a <= m.start() < b for a, b in blocks)
        found.setdefault(m.group(1), extern_c)
    return found


class CudaModule:
    """CUDA C source compiled at run time (reference ``mx.rtc.CudaModule``).

    Construction is pure Python and needs no card: it finds the
    ``__global__`` kernels of ``source``; ``exports`` (default: all of
    them) names those :meth:`get_kernel` may return. A kernel that is not
    ``extern "C"`` is registered with NVRTC by name and launched under
    its lowered (mangled) name. ``options`` go to NVRTC after the
    architecture, ``-std=c++17`` and the toolkit's include directory.
    """

    def __init__(self, source, options=(), exports=()):
        self._source = source
        self._options = tuple(str(o) for o in options)
        defined = _kernels(source)
        self._extern_c = defined
        self._exports = list(exports) if exports else list(defined)
        for name in self._exports:
            if name not in defined:
                raise ValueError("exported kernel %r not defined in source"
                                 % name)
        self._lock = threading.Lock()
        self._cubin = None
        self._lowered = {}
        self._functions = {}       # device index -> {name: CUfunction}
        self.compiles = 0
        self.compile_ms = None

    @property
    def exports(self):
        return list(self._exports)

    def get_kernel(self, name, signature):
        """The launchable kernel ``name`` with the arguments of
        ``signature`` (see the module docstring)."""
        if name not in self._exports:
            raise ValueError("kernel %r not found (exports: %s)"
                             % (name, self._exports))
        return CudaKernel(self, name, _parse_signature(signature))

    def _compile(self, index):
        major, minor = torch.cuda.get_device_capability(index)
        arch = "sm_%d%d%s" % (major, minor, "a" if major == 9 else "")
        mangled = [n for n in self._exports if not self._extern_c[n]]
        t0 = time.perf_counter()
        cubin, lowered, _log = _nvrtc.compile_cubin(
            self._source, arch, self._options, mangled)
        self.compile_ms = (time.perf_counter() - t0) * 1e3
        self.compiles += 1
        self._cubin = cubin
        self._lowered = {n: lowered.get(n, n) for n in self._exports}

    def _function(self, name, index):
        """The CUfunction of kernel ``name`` on device ``index``: the
        module compiles at its first use and loads once per device."""
        fns = self._functions.get(index)
        if fns is None:
            with self._lock:
                fns = self._functions.get(index)
                if fns is None:
                    if self._cubin is None:
                        self._compile(index)
                    torch.cuda.synchronize(index)   # primary context current
                    if not _nvrtc.current_context():
                        raise MXTPUError("no CUDA context is current on "
                                         "device %d" % index)
                    module = _nvrtc.load_module(self._cubin)
                    fns = {n: _nvrtc.get_function(module, self._lowered[n])
                           for n in self._exports}
                    self._functions[index] = fns
        return fns[name]


def _dims(dims, what):
    d = [int(x) for x in dims]
    if not 1 <= len(d) <= 3 or min(d) < 1:
        raise ValueError("%s must be 1 to 3 positive ints, got %r"
                         % (what, tuple(dims)))
    return d + [1] * (3 - len(d))


class CudaKernel:
    """A launchable kernel (reference ``mx.rtc.CudaKernel``).
    ``launches`` counts the launches that ran: a launch recorded into a
    CUDA graph being captured runs at each replay instead (count the
    graph's nodes of :meth:`function`)."""

    def __init__(self, module, name, params):
        self._module = module
        self._name = name
        self._params = params
        self._smem_allowed = {}    # device index -> dynamic bytes allowed
        self.launches = 0

    def function(self, ctx):
        """The kernel's ``CUfunction`` handle on ``ctx``'s card (loading
        the module there first)."""
        return self._module._function(self._name,
                                      Context(ctx).torch_device().index)

    def launch(self, args, ctx, grid_dims=(1, 1, 1), block_dims=(1, 1, 1),
               shared_mem=0):
        """Launch on ``args`` (NDArrays and scalars, in signature order)
        over ``grid_dims`` blocks of ``block_dims`` threads with
        ``shared_mem`` bytes of dynamic shared memory, asynchronously on
        the current stream of ``ctx``'s card. Returns the output
        NDArrays."""
        if len(args) != len(self._params):
            raise ValueError("kernel %s expects %d args, got %d"
                             % (self._name, len(self._params), len(args)))
        for a, p in zip(args, self._params):
            if p.is_ndarray and not isinstance(a, NDArray):
                raise TypeError("arg %r must be NDArray" % p.name)
        grid = _dims(grid_dims, "grid_dims")
        block = _dims(block_dims, "block_dims")
        ctx = Context(ctx)
        if ctx.device_type != "gpu":
            raise MXTPUError("rtc kernels are CUDA C and run on a gpu "
                             "context, not %s" % ctx)
        dev = ctx.torch_device()
        packed, copies, outputs = [], [], []
        for a, p in zip(args, self._params):
            if not p.is_ndarray:
                packed.append(_pack_scalar(p, a))
                continue
            t = a.data
            if t.device != dev:
                raise MXTPUError("arg %r lies on %s; the launch is on %s"
                                 % (p.name, a.context, ctx))
            want = canonical_dtype(p.dtype)
            if t.dtype != want or not t.is_contiguous():
                c = t.detach().to(want).contiguous()
                if not p.is_const:
                    copies.append((t, c))
                t = c
            if not p.is_const:
                outputs.append(a)
            packed.append(ctypes.c_void_p(t.data_ptr()))
        index = dev.index
        fn = self._module._function(self._name, index)
        if shared_mem > 48 * 1024 and \
                shared_mem > self._smem_allowed.get(index, 0):
            _nvrtc.set_max_dynamic_shared(fn, shared_mem)
            self._smem_allowed[index] = shared_mem
        stream = torch.cuda.current_stream(dev).cuda_stream
        if torch.cuda.current_device() != index:
            with torch.cuda.device(index):
                _nvrtc.launch(fn, grid, block, shared_mem, stream, packed)
        else:
            _nvrtc.launch(fn, grid, block, shared_mem, stream, packed)
        if not torch.cuda.is_current_stream_capturing():
            self.launches += 1
        with torch.no_grad():
            for t, c in copies:
                t.copy_(c)
        return outputs
