"""Gradients of the port's LSTM/GRU time loops and of its fused RNN op
against mxtpu's, on the same seeded inputs.

On the card, lstm_scan and gru_scan run their kernels under the autograd
Functions ``_LstmScan`` / ``_GruScan``, whose backward recomputes through
the plain loop as mxtpu's ``custom_vjp`` backward recomputes through
``lax.scan``. Here, on the CPU, the CUDA branch (``_lstm_on_card`` /
``_gru_on_card``) runs with its launch replaced by a no-grad call of the
kernel's plain version, so the Functions' forward and backward are the
ones the card runs; chip_smoke.py holds the same gradients on the card
against the CPU. mxtpu's side is ``jax.vjp`` of ``pallas_rnn.lstm_scan`` /
``gru_scan`` (the Pallas kernels in interpret mode, as
tests/test_torch_rnn_scan.py runs them) and ``jax.vjp`` of its RNN op.

Tolerances. float32: both sides differentiate the same f32 loop and sum
in another order, over at most 6 steps of width 8: 1e-5. bfloat16: both
carry and differentiate in f32 and round each gradient to bf16 once; a
last-bit difference in f32 can flip that rounding by one bf16 ulp, at
most 2^-7 of the value (bf16 keeps 8 significant bits), so rtol 2^-7,
with the f32 atol for values near 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu.ops import pallas_rnn
from mxtpu.ops import rnn as jrnn
from mxtpu_torch.ops import rnn as trnn
from mxtpu_torch.ops import rnn_scan
from torch_threads import torch_threads_shared  # noqa: F401

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-5, rtol=2.0 ** -7)
T, N, H = 6, 3, 8


@pytest.fixture
def kernels(monkeypatch):
    """Replace the CUDA launches by no-grad calls of the plain versions;
    returns the launch count per kernel."""
    launches = {"lstm_scan": 0, "gru_scan": 0}

    def stub(name, plain):
        def launch(*args):
            with torch.no_grad():
                out = plain(*args)
            launches[name] += 1
            return out
        return launch
    monkeypatch.setattr(rnn_scan, "_lstm_cuda",
                        stub("lstm_scan", rnn_scan.lstm_scan_reference))
    monkeypatch.setattr(rnn_scan, "_gru_cuda",
                        stub("gru_scan", rnn_scan.gru_scan_reference))
    return launches


def _inputs(kind, seed):
    rng = np.random.RandomState(seed)
    G = 4 if kind == "lstm" else 3
    shapes = [(T, N, G * H), (N, H)]
    shapes += [(N, H), (H, 4 * H)] if kind == "lstm" \
        else [(H, 2 * H), (H, H), (H,)]
    scale = [1.0, 0.5, 0.5, 0.3] if kind == "lstm" else [1.0, 0.5, 0.3, 0.3,
                                                         0.1]
    arrays = [(rng.standard_normal(s) * c).astype(np.float32)
              for s, c in zip(shapes, scale)]
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in [(T, N, H), (N, H), (N, H)][:3 if kind == "lstm" else 2]]
    return arrays, cots


def _assert_close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("unused_state", [False, True],
                         ids=["all_cotangents", "final_state_unused"])
def test_scan_function_gradients_match_mxtpu(kernels, kind, dtype,
                                             unused_state):
    """Every input's gradient through the CUDA branch's Function against
    mxtpu's custom_vjp. ``final_state_unused`` leaves the last output
    (LSTM's cT, GRU's hT) out of the loss: the Function gets None for its
    cotangent, mxtpu zeros."""
    arrays, cots = _inputs(kind, seed=3 if kind == "lstm" else 4)
    if unused_state:
        cots[-1] = np.zeros_like(cots[-1])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jfn = pallas_rnn.lstm_scan if kind == "lstm" else pallas_rnn.gru_scan
    _, vjp = jax.vjp(jfn, *[jnp.asarray(a).astype(jdt) for a in arrays])
    want = vjp(tuple(jnp.asarray(c).astype(jdt) for c in cots))
    on_card = rnn_scan._lstm_on_card if kind == "lstm" \
        else rnn_scan._gru_on_card
    xs = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrays]
    outs = on_card(*xs)
    name = kind + "_scan"
    assert kernels == {"lstm_scan": 0, "gru_scan": 0, name: 1}
    assert all(o.grad_fn is not None and o.dtype == tdt for o in outs)
    used = len(cots) - 1 if unused_state else len(cots)
    got = torch.autograd.grad(
        outs[:used], xs, [torch.from_numpy(c).to(tdt) for c in cots[:used]])
    assert kernels[name] == 1          # the backward launches nothing
    assert all(g.dtype == tdt for g in got)
    _assert_close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_scan_function_keeps_each_inputs_dtype(kernels, kind):
    """A bf16 sequence with an f32 state: each gradient comes back in its
    input's dtype, as the forward's outputs keep theirs."""
    arrays, cots = _inputs(kind, seed=5)
    dts = [torch.bfloat16, torch.float32] + (
        [torch.float32, torch.bfloat16] if kind == "lstm"
        else [torch.bfloat16] * 3)
    xs = [torch.from_numpy(a).to(d).requires_grad_()
          for a, d in zip(arrays, dts)]
    on_card = rnn_scan._lstm_on_card if kind == "lstm" \
        else rnn_scan._gru_on_card
    outs = on_card(*xs)
    got = torch.autograd.grad(outs[0].float().sum(), xs)
    assert [g.dtype for g in got] == dts


@pytest.mark.parametrize("grad_mode,requires_grad",
                         [("no_grad", True), ("inference_mode", True),
                          ("enabled", False)])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_no_gradient_wanted_launches_the_kernel_directly(
        kernels, monkeypatch, kind, grad_mode, requires_grad):
    """The serving path (no grad, or nothing that requires grad) calls the
    kernel itself, not the Function: its launches stay one a call."""
    class Refused(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            raise AssertionError("the Function ran without a gradient")
    monkeypatch.setattr(rnn_scan, "_LstmScan", Refused)
    monkeypatch.setattr(rnn_scan, "_GruScan", Refused)
    arrays, _ = _inputs(kind, seed=6)
    xs = [torch.from_numpy(a).requires_grad_(requires_grad) for a in arrays]
    on_card = rnn_scan._lstm_on_card if kind == "lstm" \
        else rnn_scan._gru_on_card
    scope = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
             "enabled": torch.enable_grad}[grad_mode]
    with scope():
        outs = on_card(*xs)
    assert kernels[kind + "_scan"] == 1
    assert all(o.grad_fn is None for o in outs)


# ---------------------------------------------------------------------------
# the fused RNN op: parameter, state and data gradients
# ---------------------------------------------------------------------------

I = 5


def _rnn_case(mode, layers, bidirectional, seed=9):
    rng = np.random.RandomState(seed)
    D = 2 if bidirectional else 1
    psize = jrnn.rnn_param_size(mode, I, H, layers, bidirectional)
    arrays = [rng.standard_normal((T, N, I)).astype(np.float32),
              (rng.standard_normal(psize) * 0.3).astype(np.float32),
              (rng.standard_normal((layers * D, N, H)) * 0.5).astype(
                  np.float32)]
    if mode == "lstm":
        arrays.append((rng.standard_normal((layers * D, N, H)) * 0.5)
                      .astype(np.float32))
    outs = [(T, N, D * H), (layers * D, N, H)] + (
        [(layers * D, N, H)] if mode == "lstm" else [])
    cots = [rng.standard_normal(s).astype(np.float32) for s in outs]
    return arrays, cots


@pytest.mark.parametrize("route", ["plain", "function"])
@pytest.mark.parametrize("layers,bidirectional",
                         [(1, False), (2, False), (1, True), (2, True)])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_op_gradients_match_mxtpu(kernels, monkeypatch, mode, layers,
                                      bidirectional, route):
    """Gradients of data, the flat parameters (through the transposed,
    folded and flipped views the op makes of them) and the states, against
    jax.vjp of mxtpu's RNN op. ``function`` sends the op's time loops
    through the CUDA branch's Functions; ``plain`` differentiates the CPU
    loop."""
    arrays, cots = _rnn_case(mode, layers, bidirectional)
    kw = dict(state_size=H, num_layers=layers, bidirectional=bidirectional,
              mode=mode, state_outputs=True)
    try:
        jrnn.USE_PALLAS_RNN = True       # mxtpu's custom_vjp route
        _, vjp = jax.vjp(lambda *a: tuple(jrnn.rnn(*a, **kw)),
                         *[jnp.asarray(a) for a in arrays])
        want = vjp(tuple(jnp.asarray(c) for c in cots))
    finally:
        jrnn.USE_PALLAS_RNN = None
    if route == "function":
        monkeypatch.setattr(trnn, "lstm_scan", rnn_scan._lstm_on_card)
        monkeypatch.setattr(trnn, "gru_scan", rnn_scan._gru_on_card)
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = trnn.rnn(*xs, **kw)
    got = torch.autograd.grad(outs, xs, [torch.from_numpy(c) for c in cots])
    runs = layers * (2 if bidirectional else 1)
    assert kernels[mode + "_scan"] == (runs if route == "function" else 0)
    _assert_close(got, want, F32_TOL)
