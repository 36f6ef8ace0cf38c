"""mx.rtc of the port on the CPU, against mxtpu's rtc.

The port's CudaModule compiles CUDA C with NVRTC and launches it only on
a gpu context, so here it is held to mxtpu on what needs no card: the
signature grammar and its errors, export discovery and enforcement,
launch validation, and the packing of each scalar type. The six launch
cases that chip_smoke.py runs as CUDA C on the card have plain torch
versions there; those are held to mxtpu's PallasModule running the JAX
test bodies (tests/test_legacy_api.py) in interpret mode. The values are
small exact floats: tolerance 1e-6.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu.rtc as jrtc
import mxtpu_torch as mt
import mxtpu_torch.rtc as trtc
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  str(ROOT / "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SIGNATURES = [
    "const float *x, const float *y, float alpha, float *out",
    "float *out",
    "float *out, const float *x",
    "const float *x, int n, float *o",
    "const double *a, half h, __half *o, uint8_t u, int32_t i, int8_t c, "
    "char ch, int64_t l",
    "  const float * x ,, float*y  ",
    "const int64_t* idx, double d",
    "",
]
BAD_SIGNATURES = ["blob *x", "const float", "float *x y", "const *x",
                  "unsigned int n", "float x, bool b"]


@pytest.mark.parametrize("sig", SIGNATURES)
def test_parse_signature_matches_mxtpu(sig):
    got = [(p.name, p.dtype, p.is_ndarray, p.is_const)
           for p in trtc._parse_signature(sig)]
    want = [(p.name, p.dtype, p.is_ndarray, p.is_const)
            for p in jrtc._parse_signature(sig)]
    assert got == want
    assert trtc._DTYPES == jrtc._DTYPES


@pytest.mark.parametrize("sig", BAD_SIGNATURES)
def test_parse_signature_errors_match_mxtpu(sig):
    with pytest.raises(ValueError) as want:
        jrtc._parse_signature(sig)
    with pytest.raises(ValueError) as got:
        trtc._parse_signature(sig)
    assert str(got.value) == str(want.value)


def test_exports_found_and_enforced(smoke):
    mod = mt.rtc.CudaModule(smoke.RTC_SOURCE)
    assert mod.exports == ["axpy", "fill_rows", "dbl", "rows", "scale",
                           "rep"]
    # extern "C" kernels launch under their own names; C++ ones (dbl,
    # rep) are registered with NVRTC and launched under lowered names
    assert trtc._kernels(smoke.RTC_SOURCE) == {
        "axpy": True, "fill_rows": True, "dbl": False, "rows": True,
        "scale": True, "rep": False}
    assert trtc._kernels(smoke.CS_SOURCE) == {"cs_softmax_fwd": True,
                                               "cs_softmax_bwd": True}
    assert trtc._kernels(smoke.RTC_EXTRA_SOURCE) == {"hscale": True,
                                                      "smem_reverse": True}
    only = mt.rtc.CudaModule(smoke.RTC_SOURCE, exports=["axpy"])
    only.get_kernel("axpy", smoke.RTC_SIGNATURES["axpy"])
    with pytest.raises(ValueError):
        only.get_kernel("dbl", smoke.RTC_SIGNATURES["dbl"])   # not exported
    with pytest.raises(ValueError):
        mod.get_kernel("missing", "float *x")
    assert mod.compiles == 0        # construction compiles nothing


def test_kernel_discovery_reads_code_not_comments():
    src = r'''
    // __global__ void commented(float *o) {}
    /* __global__ void blocked(float *o) {} */
    extern "C" {
    __global__ void __launch_bounds__(128) bounded(float *o) {}
    }
    template <typename T> __device__ T helper(T v) { return v; }
    __global__ static void cpp_kernel(const float *x, float *o) {}
    '''
    assert trtc._kernels(src) == {"bounded": True, "cpp_kernel": False}


def test_export_errors_match_mxtpu():
    # tests/test_legacy_api.py:90-99 and :136-141, with a CUDA C body
    jmod = mx.rtc.PallasModule("def f(o_ref):\n    o_ref[...] = 0.0\n",
                               exports=["f"])
    tmod = mt.rtc.CudaModule('extern "C" __global__ void f(float *o) '
                             '{ o[0] = 0.f; }', exports=["f"])
    for mod in (jmod, tmod):
        with pytest.raises(ValueError):
            mod.get_kernel("f", "blob *x")
        with pytest.raises(ValueError):
            mod.get_kernel("missing", "float *x")
        with pytest.raises(ValueError):
            mod.get_kernel("f", "float *x").launch((), mx.cpu(0)
                                                   if mod is jmod
                                                   else mt.cpu())
    with pytest.raises(ValueError):
        mod.get_kernel("jnp", "float *x")
    with pytest.raises(ValueError):
        mx.rtc.PallasModule("x = 1\n", exports=["g"])
    with pytest.raises(ValueError):
        mt.rtc.CudaModule("int x = 1;\n", exports=["g"])


def test_launch_validation():
    mod = mt.rtc.CudaModule(
        'extern "C" __global__ void f(const float *x, float a, float *o) {}')
    k = mod.get_kernel("f", "const float *x, float a, float *o")
    x, o = mt.nd.ones((4,), ctx=mt.cpu()), mt.nd.zeros((4,), ctx=mt.cpu())
    with pytest.raises(ValueError):
        k.launch((x, 1.0), mt.cpu())
    with pytest.raises(TypeError):
        k.launch((x, 1.0, np.zeros(4, np.float32)), mt.cpu())
    with pytest.raises(mt.MXTPUError):       # CUDA C needs a gpu context
        k.launch((x, 1.0, o), mt.cpu())
    if not torch.cuda.is_available():
        with pytest.raises(mt.MXTPUError):   # no card: gpu(0) raises too
            k.launch((x, 1.0, o), mt.gpu(0))
    with pytest.raises(ValueError):
        k.launch((x, 1.0, o), mt.gpu(0), grid_dims=(0, 1, 1))
    assert k.launches == 0 and mod.compiles == 0
    # the same count and type errors as mxtpu
    jk = mx.rtc.PallasModule(
        "def f(x_ref, o_ref, *, a):\n    o_ref[...] = x_ref[...] * a\n"
    ).get_kernel("f", "const float *x, float a, float *o")
    with pytest.raises(ValueError):
        jk.launch((mx.nd.ones((4,)), 1.0), mx.cpu())
    with pytest.raises(TypeError):
        jk.launch((mx.nd.ones((4,)), 1.0, np.zeros(4, np.float32)),
                  mx.cpu())


@pytest.mark.parametrize("tname", sorted(trtc._DTYPES))
def test_scalar_packing(tname):
    """Each scalar travels as the bytes numpy gives it in the declared
    type (a half as its 16 bits), as mxtpu converts with dtype(value)."""
    p = trtc._parse_signature("%s v" % tname)[0]
    dtype = jrtc._parse_signature("%s v" % tname)[0].dtype
    for value in (3, -2.75, 100.5, True):
        if np.issubdtype(dtype, np.unsignedinteger) and value < 0:
            continue
        packed = trtc._pack_scalar(p, value)
        want = np.asarray(dtype(value))
        assert bytes(packed) == want.tobytes(), (tname, value)
        assert len(bytes(packed)) == want.itemsize


def test_scalar_packing_refuses_what_numpy_refuses():
    p = trtc._parse_signature("int8_t v")[0]
    with pytest.raises((OverflowError, ValueError)):
        trtc._pack_scalar(p, 300)


def _pallas(src, name, sig, args, grid=(1, 1, 1)):
    k = mx.rtc.PallasModule(src).get_kernel(name, sig)
    return [o.asnumpy() for o in k.launch(args, mx.cpu(0), grid)]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_axpy_plain_matches_pallas(smoke):
    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    y = np.ones((2, 4), np.float32)
    (want,) = _pallas("def axpy(x_ref, y_ref, out_ref, *, alpha):\n"
                      "    out_ref[...] = alpha * x_ref[...] + y_ref[...]\n",
                      "axpy", "const float *x, const float *y, float alpha, "
                      "float *out", (mx.nd.array(x), mx.nd.array(y), 3.0,
                                     mx.nd.zeros((2, 4))))
    got = smoke.rtc_axpy_plain(_t(x), _t(y), 3.0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fill_rows_plain_matches_pallas(smoke):
    (want,) = _pallas("def fill_rows(out_ref):\n"
                      "    i = pl.program_id(0)\n"
                      "    out_ref[i, :] = jnp.full((4,), i, jnp.float32)\n",
                      "fill_rows", "float *out", (mx.nd.zeros((3, 4)),),
                      (3, 1, 1))
    got = smoke.rtc_fill_rows_plain(3, 4, torch.device("cpu"))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dbl_plain_matches_pallas(smoke):
    x = np.arange(4, dtype=np.float32)
    (want,) = _pallas("def dbl(out_ref, x_ref):\n"
                      "    out_ref[...] = x_ref[...] * 2.0\n",
                      "dbl", "float *out, const float *x",
                      (mx.nd.zeros((4,)), mx.nd.array(x)))
    np.testing.assert_allclose(smoke.rtc_dbl_plain(_t(x)).numpy(), want,
                               **TOL)


def test_rows_plain_matches_pallas(smoke):
    (want,) = _pallas("def rows(out_ref):\n"
                      "    j = pl.program_id(1)\n"
                      "    out_ref[0, j] = j * 1.0\n",
                      "rows", "float *out", (mx.nd.zeros((1, 3)),),
                      (1, 3, 1))
    got = smoke.rtc_rows_plain(3, torch.device("cpu"))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("alpha", [1.0, 2.0, 3.0])
def test_scale_plain_matches_pallas(smoke, alpha):
    x = np.random.RandomState(0).randn(4).astype(np.float32)
    (want,) = _pallas("def f(x_ref, o_ref, *, alpha):\n"
                      "    o_ref[...] = x_ref[...] * alpha\n",
                      "f", "const float *x, float alpha, float *o",
                      (mx.nd.array(x), alpha, mx.nd.zeros((4,))))
    np.testing.assert_allclose(smoke.rtc_scale_plain(_t(x), alpha).numpy(),
                               want, **TOL)


@pytest.mark.parametrize("n", [3, 5])
def test_rep_plain_matches_pallas(smoke, n):
    x = np.random.RandomState(1).randn(4).astype(np.float32)
    (want,) = _pallas("def rep(x_ref, o_ref, *, n):\n"
                      "    acc = x_ref[...]\n"
                      "    for _ in range(n - 1):\n"
                      "        acc = acc + x_ref[...]\n"
                      "    o_ref[...] = acc\n",
                      "rep", "const float *x, int n, float *o",
                      (mx.nd.array(x), n, mx.nd.zeros((4,))))
    np.testing.assert_allclose(smoke.rtc_rep_plain(_t(x), n).numpy(), want,
                               **TOL)
