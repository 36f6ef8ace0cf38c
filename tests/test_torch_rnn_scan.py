"""The port's LSTM/GRU time loops (mxtpu_torch/ops/rnn_scan.py) against
mxtpu's Pallas kernels (interpret mode on the CPU) and their lax.scan
references, on the same seeded inputs.

On the CPU the wrappers run their plain PyTorch versions; the CUDA
kernels are held against those same plain versions on the card by
chip_smoke.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxtpu.ops import pallas_rnn
from mxtpu_torch.ops import rnn_scan

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# f32: the kernel and its reference differ only in summation order over
# H=8 terms per step (same bound as tests/test_pallas_rnn.py)
F32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16 outputs: both sides carry f32 and round to bf16 once per step; a
# last-bit difference in f32 can flip one rounding, i.e. one bf16 ulp
# (2**-8 relative, <= 2**-8 absolute for |h| < 1); allow two
BF16_TOL = dict(atol=2 * 2.0 ** -8, rtol=2 * 2.0 ** -8)


def _lstm_inputs(T=6, N=4, H=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((T, N, 4 * H)).astype(np.float32),
            rng.standard_normal((N, H)).astype(np.float32),
            rng.standard_normal((N, H)).astype(np.float32),
            (rng.standard_normal((H, 4 * H)) * 0.3).astype(np.float32))


def _gru_inputs(T=6, N=4, H=8, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((T, N, 3 * H)).astype(np.float32),
            rng.standard_normal((N, H)).astype(np.float32),
            (rng.standard_normal((H, 2 * H)) * 0.3).astype(np.float32),
            (rng.standard_normal((H, H)) * 0.3).astype(np.float32),
            (rng.standard_normal((H,)) * 0.1).astype(np.float32))


def _to_jax(arrays, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _to_torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _assert_all_close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np32(g), _np32(w), **tol)


@pytest.mark.parametrize("ref", ["pallas", "scan"])
def test_lstm_scan_matches_mxtpu_f32(ref):
    a = _lstm_inputs()
    want = (pallas_rnn.lstm_scan if ref == "pallas"
            else pallas_rnn._scan_reference)(*_to_jax(a, jnp.float32))
    got = rnn_scan.lstm_scan(*_to_torch(a, torch.float32))
    _assert_all_close(got, want, F32_TOL)


@pytest.mark.parametrize("ref", ["pallas", "scan"])
def test_gru_scan_matches_mxtpu_f32(ref):
    a = _gru_inputs()
    want = (pallas_rnn.gru_scan if ref == "pallas"
            else pallas_rnn._gru_scan_reference)(*_to_jax(a, jnp.float32))
    got = rnn_scan.gru_scan(*_to_torch(a, torch.float32))
    _assert_all_close(got, want, F32_TOL)


def test_lstm_scan_matches_mxtpu_bf16():
    a = _lstm_inputs(seed=5)
    want = pallas_rnn._scan_reference(*_to_jax(a, jnp.bfloat16))
    got = rnn_scan.lstm_scan(*_to_torch(a, torch.bfloat16))
    assert all(g.dtype == torch.bfloat16 for g in got)
    _assert_all_close(got, want, BF16_TOL)


def test_gru_scan_matches_mxtpu_bf16():
    a = _gru_inputs(seed=6)
    want = pallas_rnn._gru_scan_reference(*_to_jax(a, jnp.bfloat16))
    got = rnn_scan.gru_scan(*_to_torch(a, torch.bfloat16))
    assert all(g.dtype == torch.bfloat16 for g in got)
    _assert_all_close(got, want, BF16_TOL)


def test_mixed_dtypes_keep_each_outputs_dtype():
    """bf16 sequence with an f32 state: ys follows x_proj, hT/cT the
    state (the Pallas kernel's out_shape rule)."""
    xp, h0, c0, wh = _lstm_inputs(T=3, N=2, H=4, seed=2)
    ys, hT, cT = rnn_scan.lstm_scan(
        torch.from_numpy(xp).bfloat16(), torch.from_numpy(h0),
        torch.from_numpy(c0), torch.from_numpy(wh).bfloat16())
    assert ys.dtype == torch.bfloat16
    assert hT.dtype == cT.dtype == torch.float32


def test_cpu_path_counts_no_launch():
    rnn_scan.reset_launches()
    rnn_scan.lstm_scan(*_to_torch(_lstm_inputs(T=2, N=1, H=4), torch.float32))
    rnn_scan.gru_scan(*_to_torch(_gru_inputs(T=2, N=1, H=4), torch.float32))
    assert rnn_scan.LAUNCHES == {"lstm_scan": 0, "gru_scan": 0}


def test_meta_tensors_give_output_shapes():
    meta = torch.device("meta")
    T, N, H = 5, 3, 7
    ys, hT, cT = rnn_scan.lstm_scan(
        torch.empty(T, N, 4 * H, device=meta),
        torch.empty(N, H, device=meta), torch.empty(N, H, device=meta),
        torch.empty(H, 4 * H, device=meta))
    assert ys.shape == (T, N, H) and hT.shape == cT.shape == (N, H)
    ys, hT = rnn_scan.gru_scan(
        torch.empty(T, N, 3 * H, device=meta), torch.empty(N, H, device=meta),
        torch.empty(H, 2 * H, device=meta), torch.empty(H, H, device=meta),
        torch.empty(H, device=meta))
    assert ys.shape == (T, N, H) and hT.shape == (N, H)


@pytest.mark.parametrize("bad", ["shape", "dtype", "contiguity"])
def test_kernel_argument_checks_raise(bad):
    """The checks the CUDA wrapper runs before a launch refuse what the
    kernel does not take."""
    H = 4
    wh = torch.zeros(H, 4 * H)
    if bad == "shape":
        wh, want = torch.zeros(H + 1, 4 * H), ValueError
    elif bad == "dtype":
        wh, want = torch.zeros(H, 4 * H, dtype=torch.float64), TypeError
    else:
        wh, want = torch.zeros(4 * H, H).t(), ValueError
    with pytest.raises(want):
        rnn_scan._check("lstm_scan", [("wh_t", wh)], [(H, 4 * H)],
                        [torch.float32], torch.device("cpu"))


def test_unsupported_kernel_dtype_raises():
    with pytest.raises(TypeError):
        rnn_scan._check_dtypes("lstm_scan", torch.float16, torch.float32)
