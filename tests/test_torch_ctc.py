"""``ctc_loss`` and Gluon's ``CTCLoss`` of the PyTorch port held to
``mxtpu``'s (``mxtpu/ops/nn.py`` ``ctc_loss``, ``gluon.loss.CTCLoss``) on
the CPU: the per-sample losses, and the gradient of a weighted sum of them
(torch's autograd against ``jax.vjp``), from seeded numpy inputs.

The cases: blank "first" (0 pads) and "last" (-1 pads, which index the
last class as JAX's negative indices do); with and without each length
input; a repeated label (no skip between equal symbols); an empty label
(its one all-blank path); a T just long enough for its label and one too
short (every path is impossible: a finite loss near 1e30, and a gradient
that must equal JAX's where ``lse3``'s maxima tie at -1e30); float16
data. The Gluon loss in both layouts, with ``label_layout="TN"``, a
``sample_weight`` and the length inputs, the port's eager and
hybridized against mxtpu's hybridized (one jitted program to compile).

Tolerances: the losses are float32 sums of a few hundred log-sum-exps in
the same order in both packages: 1e-5 relative (float16 data: the result
is rounded to float16 in both, so one float16 ulp, 1e-3 relative). The
gradients within 1e-5 of the largest entry; in the impossible case the
loss is 1e30 and rounding at that scale is 6e22, so only the gradient is
compared there, within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxtpu as mx
import mxtpu.ops.nn as jnn
import mxtpu_torch as mt
import mxtpu_torch.ops.nn as tnn
from torch_threads import torch_threads_shared  # noqa: F401

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5

# name: (T, N, C, labels, blank, data_lengths, label_lengths)
CASES = {
    "first": (12, 3, 6, [[1, 2, 3], [4, 4, 0], [5, 0, 0]], "first",
              None, None),
    "last": (12, 3, 6, [[0, 1, 2], [3, 3, -1], [4, -1, -1]], "last",
             None, None),
    "data lengths": (10, 3, 5, [[1, 2, 0], [3, 0, 0], [1, 1, 2]], "first",
                     [10, 6, 8], None),
    "label lengths": (10, 3, 5, [[1, 2, 3], [3, 2, 0], [1, 1, 2]], "first",
                      None, [2, 1, 3]),
    "both lengths, last": (9, 2, 4, [[0, 1, 2], [2, 2, 1]], "last",
                           [9, 5], [3, 2]),
    "repeated label": (8, 2, 4, [[2, 2, 2], [1, 1, 0]], "first",
                       None, None),
    "empty label": (7, 2, 4, [[0, 0], [3, 0]], "first", None, None),
    # [1, 1, 2] needs 4 frames (1, blank, 1, 2), [2, 2, 2] needs 5
    "T just long enough": (4, 1, 4, [[1, 1, 2]], "first", None, None),
    "T too short": (3, 2, 4, [[1, 1, 2], [2, 2, 2]], "first", None, None),
}


def _inputs(case, dtype=np.float32):
    T, N, C, labels, blank, dl, ll = CASES[case]
    rng = np.random.RandomState(len(case))
    data = rng.randn(T, N, C).astype(dtype)
    label = np.asarray(labels, np.float32)
    dl = None if dl is None else np.asarray(dl, np.float32)
    ll = None if ll is None else np.asarray(ll, np.float32)
    w = rng.uniform(0.5, 1.5, N).astype(np.float32)
    return data, label, dl, ll, blank, w


def _mxtpu(data, label, dl, ll, blank, w):
    """mxtpu's losses and the gradient of sum(w * loss) to the data."""
    def f(d):
        return jnn.ctc_loss(
            d, jnp.asarray(label),
            None if dl is None else jnp.asarray(dl),
            None if ll is None else jnp.asarray(ll), blank_label=blank)

    def both(d):
        out, vjp = jax.vjp(f, d)
        return out, vjp(jnp.asarray(w).astype(out.dtype))[0]
    out, g = jax.jit(both)(jnp.asarray(data))
    return np.asarray(out, np.float64), np.asarray(g, np.float64)


def _port(data, label, dl, ll, blank, w):
    d = torch.tensor(data, requires_grad=True)
    out = tnn.ctc_loss(d, torch.tensor(label),
                       None if dl is None else torch.tensor(dl),
                       None if ll is None else torch.tensor(ll),
                       blank_label=blank)
    (out * torch.tensor(w).to(out.dtype)).sum().backward()
    return (out.detach().double().numpy(), d.grad.double().numpy())


def _check(case, dtype=np.float32, loss_rtol=LOSS_RTOL):
    args = _inputs(case, dtype)
    got, g_got = _port(*args)
    want, g_want = _mxtpu(*args)
    assert got.shape == want.shape == (args[0].shape[1],)
    assert np.isfinite(got).all() and np.isfinite(g_got).all()
    if case != "T too short":
        np.testing.assert_allclose(got, want, rtol=loss_rtol, atol=0,
                                   err_msg=case)
    else:
        assert (got > 1e29).all() and (want > 1e29).all()
    scale = max(float(np.abs(g_want).max()), 1e-30)
    np.testing.assert_allclose(g_got, g_want, atol=GRAD_TOL * scale, rtol=0,
                               err_msg=case)
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_ctc_loss_forward_and_grad(case):
    _check(case)


def test_ctc_loss_float16():
    got = _check("first", np.float16, loss_rtol=1e-3)
    assert tnn.ctc_loss(torch.zeros(3, 2, 4, dtype=torch.float16),
                        torch.ones(2, 1)).dtype == torch.float16
    assert np.isfinite(got).all()


def test_ctc_loss_through_the_op_and_symbol():
    """``nd.ctc_loss`` and its aliases reach the op; a symbol with and
    without the length inputs evaluates to the same losses."""
    data, label, dl, ll, blank, _w = _inputs("both lengths, last")
    want, _ = _mxtpu(data, label, dl, ll, blank, np.ones(2, np.float32))
    with mt.cpu():
        for name in ("ctc_loss", "CTCLoss"):
            out = getattr(mt.nd, name)(mt.nd.array(data), mt.nd.array(label),
                                       mt.nd.array(dl), mt.nd.array(ll),
                                       blank_label=blank)
            np.testing.assert_allclose(out.asnumpy(), want, rtol=LOSS_RTOL)
        out = mt.nd.contrib.ctc_loss(mt.nd.array(data), mt.nd.array(label),
                                     mt.nd.array(dl), mt.nd.array(ll),
                                     blank_label=blank)
        np.testing.assert_allclose(out.asnumpy(), want, rtol=LOSS_RTOL)
        sym = mt.sym.ctc_loss(mt.sym.var("d"), mt.sym.var("l"),
                              mt.sym.var("dl"), mt.sym.var("ll"),
                              blank_label=blank)
        assert sym.list_arguments() == ["d", "l", "dl", "ll"]
        ex = sym.bind(mt.cpu(), {"d": mt.nd.array(data),
                                 "l": mt.nd.array(label),
                                 "dl": mt.nd.array(dl),
                                 "ll": mt.nd.array(ll)})
        np.testing.assert_allclose(ex.forward()[0].asnumpy(), want,
                                   rtol=LOSS_RTOL)
        plain = mt.sym.ctc_loss(mt.sym.var("d"), mt.sym.var("l"))
        assert plain.list_arguments() == ["d", "l"]
        _, out_shapes, _ = plain.infer_shape(d=data.shape, l=label.shape)
        assert out_shapes == [(2,)]


# both layouts, both label layouts, the sample weight and the lengths,
# each in one case at least
LOSS_CASES = [("NTC", "TN", True, True), ("TNC", "NT", False, False),
              ("TNC", "TN", True, False)]


@pytest.mark.parametrize("layout,label_layout,weighted,lengths", LOSS_CASES)
def test_gluon_ctc_loss(layout, label_layout, weighted, lengths):
    """``gluon.loss.CTCLoss`` in both packages: losses and the gradient
    of their sum to the predictions; the port's eager and hybridized,
    mxtpu's hybridized."""
    T, N, C = 10, 3, 5
    rng = np.random.RandomState(3)
    pred = rng.randn(T, N, C).astype(np.float32)
    if layout == "NTC":
        pred = pred.transpose(1, 0, 2).copy()
    label = np.array([[1, 2, 0], [3, 3, 1], [4, 0, 0]], np.float32)
    if label_layout == "TN":
        label = label.T.copy()
    extra = []
    if lengths:
        extra = [np.array([10, 7, 9], np.float32),
                 np.array([2, 3, 1], np.float32)]
    sw = rng.uniform(0.5, 2, (N,)).astype(np.float32) if weighted else None

    def run(pkg, hybrid=False):
        loss = pkg.gluon.loss.CTCLoss(layout=layout, label_layout=label_layout)
        if hybrid:
            loss.hybridize()
        x = pkg.nd.array(pred)
        x.attach_grad()
        args = [x, pkg.nd.array(label)] + [pkg.nd.array(a) for a in extra]
        if not lengths:
            args += [None, None]
        if sw is not None:
            args.append(pkg.nd.array(sw))
        with pkg.autograd.record():
            out = loss(*args)
        out.backward()
        return out.asnumpy(), x.grad.asnumpy()

    want, g_want = run(mx, True)
    for hybrid in (False, True):
        with mt.cpu():
            got, g_got = run(mt, hybrid)
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        np.testing.assert_allclose(g_got, g_want, rtol=0,
                                   atol=GRAD_TOL * np.abs(g_want).max())


class _NoHostTensors(torch.overrides.TorchFunctionMode):
    """Raise on a tensor made from Python values or read back to Python:
    inside a CUDA graph capture the first is a refused copy from the
    host, the second a frozen value."""

    BANNED = {torch.tensor, torch.as_tensor, torch.Tensor.new_tensor,
              torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.numpy,
              torch.Tensor.__bool__, torch.Tensor.__float__,
              torch.Tensor.__int__}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.BANNED:
            raise AssertionError("host tensor or read: %s" % func)
        return func(*args, **(kwargs or {}))


def test_ctc_loss_can_be_captured():
    """The op's forward and backward make no tensor from the host and
    read none back, so a captured train step records it (a -1e30 made by
    ``torch.tensor`` was refused in the first capture on the card)."""
    data, label, dl, ll, blank, w = _inputs("both lengths, last")
    d = torch.tensor(data, requires_grad=True)
    inputs = [torch.tensor(a) for a in (label, dl, ll, w)]
    with _NoHostTensors():
        out = tnn.ctc_loss(d, inputs[0], inputs[1], inputs[2],
                           blank_label=blank)
        (out * inputs[3]).sum().backward()
    assert d.grad is not None and torch.isfinite(d.grad).all()
