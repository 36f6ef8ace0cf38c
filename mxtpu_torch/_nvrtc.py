"""ctypes bindings to NVRTC and libcuda, for :mod:`mxtpu_torch.rtc`.

NVRTC compiles a CUDA C source into a CUBIN for the card's architecture
(``sm_90a`` on Hopper), so libcuda loads machine code and does no PTX
JIT; libcuda's ``cu*`` API loads the CUBIN into the current (primary)
context, resolves kernel handles and launches them on a stream. Every call's
return code is checked: a failure raises :class:`MXTPUError` with the
library's own message (and, for a failed compile, NVRTC's log).

The libraries are found at first use, never at import: ``libnvrtc``
under ``$CUDA_HOME``, then ``/usr/local/cuda``, then the ``nvidia``
package that ships with the torch wheel (the way ``_build._nvcc()``
looks for ``nvcc``); ``libcuda`` is the one torch itself runs on.
Handles, pointers and streams pass as ``c_void_p``.
"""
from __future__ import annotations

import ctypes
import glob
import os
import threading
from pathlib import Path

from .base import MXTPUError

__all__ = ["compile_cubin", "load_module", "get_function", "launch",
           "set_max_dynamic_shared", "current_context", "toolkit_include_dirs",
           "graph_kernel_functions", "function_name", "capturing_graph"]

_P = ctypes.c_void_p
_lock = threading.Lock()
_libs = {}

# CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES, CU_GRAPH_NODE_TYPE_KERNEL,
# CU_STREAM_CAPTURE_STATUS_ACTIVE (cuda.h)
_MAX_DYNAMIC_SHARED = 8
_KERNEL_NODE = 0
_CAPTURE_ACTIVE = 1


def _toolkit_roots():
    roots = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    return list(dict.fromkeys(Path(r).resolve() for r in roots
                              if r and os.path.isdir(r)))


def _wheel_dirs():
    """``site-packages/nvidia/*`` directories of the installed wheels."""
    import torch
    nvidia = Path(torch.__file__).resolve().parent.parent / "nvidia"
    return sorted(p for p in nvidia.glob("*") if p.is_dir())


def _find_nvrtc():
    cands = []
    for root in _toolkit_roots():
        for sub in ("lib64", "lib"):
            cands += sorted(glob.glob(str(root / sub / "libnvrtc.so*")))
    for d in _wheel_dirs():
        cands += sorted(glob.glob(str(d / "lib" / "libnvrtc.so*")))
    for c in cands:
        if "builtins" not in c and os.path.isfile(c):
            return c
    raise MXTPUError("libnvrtc not found (looked under $CUDA_HOME, "
                     "/usr/local/cuda and the torch wheel's nvidia packages); "
                     "mx.rtc compiles CUDA C with NVRTC")


def toolkit_include_dirs():
    """``-I`` directories holding the toolkit's headers (``cuda_fp16.h``
    for ``half``/``__half``), in search order."""
    dirs = [r / "include" for r in _toolkit_roots()]
    dirs += [d / "include" for d in _wheel_dirs()]
    found = [str(d) for d in dirs if (d / "cuda_fp16.h").is_file()]
    return list(dict.fromkeys(found))


def _bind(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _nvrtc():
    with _lock:
        lib = _libs.get("nvrtc")
        if lib is not None:
            return lib
        lib = ctypes.CDLL(_find_nvrtc())
        _bind(lib, "nvrtcCreateProgram",
              (_P, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, _P, _P))
        _bind(lib, "nvrtcDestroyProgram", (_P,))
        _bind(lib, "nvrtcAddNameExpression", (_P, ctypes.c_char_p))
        _bind(lib, "nvrtcCompileProgram", (_P, ctypes.c_int, _P))
        _bind(lib, "nvrtcGetProgramLogSize", (_P, _P))
        _bind(lib, "nvrtcGetProgramLog", (_P, ctypes.c_char_p))
        _bind(lib, "nvrtcGetCUBINSize", (_P, _P))
        _bind(lib, "nvrtcGetCUBIN", (_P, ctypes.c_char_p))
        _bind(lib, "nvrtcGetLoweredName", (_P, ctypes.c_char_p, _P))
        lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        _libs["nvrtc"] = lib
        return lib


def _cuda():
    with _lock:
        lib = _libs.get("cuda")
        if lib is not None:
            return lib
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError as e:
            raise MXTPUError("libcuda.so.1 is not loadable: %s" % e) \
                from None
        _bind(lib, "cuModuleLoadData", (_P, _P))
        _bind(lib, "cuModuleGetFunction", (_P, _P, ctypes.c_char_p))
        _bind(lib, "cuFuncSetAttribute", (_P, ctypes.c_int, ctypes.c_int))
        _bind(lib, "cuLaunchKernel", (_P,) + (ctypes.c_uint,) * 7
              + (_P, _P, _P))
        _bind(lib, "cuCtxGetCurrent", (_P,))
        _bind(lib, "cuGraphGetNodes", (_P, _P, _P))
        _bind(lib, "cuGraphNodeGetType", (_P, _P))
        _bind(lib, "cuGraphKernelNodeGetParams_v2", (_P, _P))
        _bind(lib, "cuGetErrorString", (ctypes.c_int, _P))
        _libs["cuda"] = lib
        return lib


def _check_nvrtc(lib, res, what):
    if res != 0:
        msg = lib.nvrtcGetErrorString(res)
        raise MXTPUError("%s failed: %s (nvrtcResult %d)"
                         % (what, msg.decode() if msg else "?", res))


def _check_cu(res, what):
    if res != 0:
        s = ctypes.c_char_p()
        _cuda().cuGetErrorString(res, ctypes.byref(s))
        raise MXTPUError("%s failed: %s (CUresult %d)"
                         % (what, s.value.decode() if s.value else "?", res))


def compile_cubin(source, arch, options=(), name_expressions=(),
                  filename="rtc.cu"):
    """Compile ``source`` for ``arch`` (e.g. ``"sm_90a"``) with NVRTC.

    Returns ``(cubin, lowered, log)``: the CUBIN bytes, ``{expression:
    lowered (mangled) name}`` for each of ``name_expressions`` (kernels
    that are not ``extern "C"``), and NVRTC's log. A failed compile
    raises :class:`MXTPUError` carrying the log."""
    lib = _nvrtc()
    opts = ["--gpu-architecture=%s" % arch, "-std=c++17"]
    opts += ["-I%s" % d for d in toolkit_include_dirs()]
    opts += [str(o) for o in options]
    prog = ctypes.c_void_p()
    _check_nvrtc(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), filename.encode(), 0, None,
        None), "nvrtcCreateProgram")
    try:
        exprs = [e.encode() for e in name_expressions]
        for e in exprs:
            _check_nvrtc(lib, lib.nvrtcAddNameExpression(prog, e),
                         "nvrtcAddNameExpression(%s)" % e.decode())
        c_opts = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        res = lib.nvrtcCompileProgram(prog, len(opts), c_opts)
        size = ctypes.c_size_t()
        _check_nvrtc(lib, lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)),
                     "nvrtcGetProgramLogSize")
        buf = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetProgramLog(prog, buf),
                     "nvrtcGetProgramLog")
        log = buf.value.decode(errors="replace")
        if res != 0:
            msg = lib.nvrtcGetErrorString(res)
            raise MXTPUError("NVRTC could not compile the module (%s):\n%s"
                             % (msg.decode() if msg else res, log))
        _check_nvrtc(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for e in exprs:
            name = ctypes.c_char_p()
            _check_nvrtc(lib, lib.nvrtcGetLoweredName(prog, e,
                                                      ctypes.byref(name)),
                         "nvrtcGetLoweredName(%s)" % e.decode())
            lowered[e.decode()] = name.value.decode()
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))
    return cubin.raw, lowered, log


def current_context():
    """The calling thread's current CUDA context (0 when there is none)."""
    ctx = ctypes.c_void_p()
    _check_cu(_cuda().cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
    return ctx.value or 0


def load_module(cubin):
    """Load a CUBIN into the current context; returns the module handle.
    The bytes must stay alive only for the call."""
    mod = ctypes.c_void_p()
    image = ctypes.create_string_buffer(cubin, len(cubin))
    _check_cu(_cuda().cuModuleLoadData(ctypes.byref(mod), image),
              "cuModuleLoadData")
    return mod.value


def get_function(module, name):
    fn = ctypes.c_void_p()
    _check_cu(_cuda().cuModuleGetFunction(ctypes.byref(fn), module,
                                          name.encode()),
              "cuModuleGetFunction(%s)" % name)
    return fn.value


def set_max_dynamic_shared(function, nbytes):
    """Allow ``function`` ``nbytes`` of dynamic shared memory (needed
    above 48 KB)."""
    _check_cu(_cuda().cuFuncSetAttribute(function, _MAX_DYNAMIC_SHARED,
                                         int(nbytes)),
              "cuFuncSetAttribute(max dynamic shared memory %d)" % nbytes)


def launch(function, grid, block, shared_mem, stream, params):
    """``cuLaunchKernel`` with ``params``, a sequence of ctypes values
    (one per kernel parameter, in order); asynchronous on ``stream``."""
    arr = (ctypes.c_void_p * len(params))(
        *[ctypes.addressof(p) for p in params])
    _check_cu(_cuda().cuLaunchKernel(
        function, grid[0], grid[1], grid[2], block[0], block[1], block[2],
        shared_mem, stream, arr if params else None, None), "cuLaunchKernel")


def function_name(function):
    """The (mangled) name of a ``CUfunction``, as ``cuFuncGetName`` gives
    it (libcuda of CUDA 12.3 or later)."""
    lib = _cuda()
    with _lock:
        fn = _libs.get("cuFuncGetName")
        if fn is None:
            fn = _libs["cuFuncGetName"] = _bind(lib, "cuFuncGetName",
                                                (_P, _P))
    name = ctypes.c_char_p()
    _check_cu(fn(ctypes.byref(name), ctypes.c_void_p(function)),
              "cuFuncGetName")
    return name.value.decode()


def capturing_graph(stream):
    """The ``CUgraph`` that the capture under way on ``stream`` (a
    ``CUstream`` handle, as ``torch.cuda.Stream.cuda_stream`` gives it)
    records into, as ``cuStreamGetCaptureInfo`` gives it; raises where no
    capture is under way. Reading the graph's nodes is allowed during the
    capture."""
    lib = _cuda()
    with _lock:
        fn = _libs.get("cuStreamGetCaptureInfo_v2")
        if fn is None:
            fn = _libs["cuStreamGetCaptureInfo_v2"] = _bind(
                lib, "cuStreamGetCaptureInfo_v2", (_P,) * 6)
    status, ident, graph = ctypes.c_int(), ctypes.c_uint64(), _P()
    _check_cu(fn(_P(stream), ctypes.byref(status), ctypes.byref(ident),
                 ctypes.byref(graph), None, None), "cuStreamGetCaptureInfo")
    if status.value != _CAPTURE_ACTIVE:
        raise MXTPUError("no capture is under way on stream %#x (status %d)"
                         % (stream, status.value))
    return graph.value


def graph_kernel_functions(graph):
    """The ``CUfunction`` of each kernel node of CUDA graph ``graph`` (a
    ``CUgraph`` handle, as ``torch.cuda.CUDAGraph.raw_cuda_graph()``
    gives it), in node order, and the count of its other nodes (copies,
    memsets, events)."""
    count = ctypes.c_size_t()
    _check_cu(_cuda().cuGraphGetNodes(graph, None, ctypes.byref(count)),
              "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _check_cu(_cuda().cuGraphGetNodes(graph, nodes, ctypes.byref(count)),
              "cuGraphGetNodes")
    functions, others = [], 0
    # CUDA_KERNEL_NODE_PARAMS_v2 starts with the CUfunction; 128 bytes
    # hold the whole struct
    params = ctypes.create_string_buffer(128)
    for node in nodes[:count.value]:
        kind = ctypes.c_int()
        _check_cu(_cuda().cuGraphNodeGetType(node, ctypes.byref(kind)),
                  "cuGraphNodeGetType")
        if kind.value != _KERNEL_NODE:
            others += 1
            continue
        _check_cu(_cuda().cuGraphKernelNodeGetParams_v2(node, params),
                  "cuGraphKernelNodeGetParams")
        functions.append(ctypes.c_void_p.from_buffer(params).value)
    return functions, others
