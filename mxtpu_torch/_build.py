"""Build and load the port's hand-written CUDA kernels.

Each source under ``mxtpu_torch/csrc/`` compiles with ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use (or through :func:`build_all`), from the
sources in the checkout, into ``build/mxtpu_torch/`` at the repository
root; each library's file name carries a hash of its source, of every
header under ``csrc/`` and under any ``-I`` directory the flags name,
and of the flags, so an edited source or header rebuilds and an
unchanged one loads as it is. All
sources compile in parallel, one ``nvcc`` each. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .base import MXTPUError

__all__ = ["SOURCES", "NVCC_FLAGS", "build_dir", "build_all", "load",
           "library_path"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = {"rnn_scan": CSRC / "rnn_scan.cu",
           "flash_attention": CSRC / "flash_attention.cu",
           "flash_attention_sm90": CSRC / "flash_attention_sm90.cu",
           "vision": CSRC / "vision.cu"}
_HEADER_SUFFIXES = (".h", ".cuh", ".hpp", ".inl")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# (argtypes) of each C entry: pointers and the stream as c_void_p, sizes
# and flags as c_int, reals as c_float; every entry returns
# cudaGetLastError() as an int
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "rnn_scan": {
        "mx_lstm_scan": (_P,) * 7 + (_I,) * 11 + (_P,),
        "mx_gru_scan": (_P,) * 7 + (_I,) * 11 + (_P,),
        "mx_rnn_max_active_clusters": (_I,) * 10 + (_P,),
    },
    "flash_attention": {
        "mx_flash_fwd": (_P,) * 6 + (_I,) * 6 + (_P,),
        "mx_flash_bwd_dq": (_P,) * 8 + (_I,) * 6 + (_P,),
        "mx_flash_bwd_dkv": (_P,) * 9 + (_I,) * 6 + (_P,),
    },
    "flash_attention_sm90": {
        "mx_flash_fwd_sm90": (_P,) * 6 + (_I,) * 5 + (_P,),
        "mx_flash_bwd_dq_sm90": (_P,) * 8 + (_I,) * 5 + (_P,),
        "mx_flash_bwd_dkv_sm90": (_P,) * 9 + (_I,) * 5 + (_P,),
    },
    "vision": {
        "mx_multibox_nms": (_P,) * 3 + (_I,) * 3 + (_F,) + (_I,) * 2 + (_P,),
    },
}

_lock = threading.Lock()
_loaded = {}
build_log = {}     # name -> nvcc's output (ptxas register/smem report)


def build_dir():
    return _PKG.parent / "build" / "mxtpu_torch"


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise MXTPUError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                     "the port's CUDA kernels build from source")


def _header_dirs():
    """``csrc/`` and every directory the flags name with ``-I``."""
    dirs = [CSRC]
    for i, flag in enumerate(NVCC_FLAGS):
        if flag == "-I" and i + 1 < len(NVCC_FLAGS):
            dirs.append(Path(NVCC_FLAGS[i + 1]))
        elif flag.startswith("-I") and len(flag) > 2:
            dirs.append(Path(flag[2:]))
    return dirs


def library_path(name):
    """The library of source ``name``: its file name hashes the source,
    every header a source may include (see :func:`_header_dirs`) and the
    flags."""
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for d in _header_dirs():
        for h in sorted(p for p in Path(d).rglob("*")
                        if p.suffix in _HEADER_SUFFIXES and p.is_file()):
            digest.update(str(h.relative_to(d)).encode() + b"\0")
            digest.update(h.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / ("%s-%s.so" % (name, digest.hexdigest()[:16]))


def build_all(names=None):
    """Compile every named source whose library is missing, all at once
    (one ``nvcc`` process per source). Returns the library paths."""
    names = list(SOURCES) if names is None else list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(".so.tmp%d" % os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[n] = out.decode(errors="replace")
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s"
                          % (n, proc.returncode, build_log[n]))
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise MXTPUError("kernel build failed: " + "\n".join(failed))
    return paths


def load(name):
    """The ctypes library of source ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _loaded[name] = lib
        return lib
