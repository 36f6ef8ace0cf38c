"""The cluster design of the LSTM/GRU time-loop kernels
(mxtpu_torch/csrc/rnn_scan.cu) on the CPU: the launch plan
(rnn_scan.scan_plan) over a grid of shapes, and the kernel's
decomposition written out in torch (unit slices, the gate-column map
g*H + u, the row groups, the split sums and the double-buffered h
exchange between a cluster's CTAs), held against the plain loops and
against mxtpu's Pallas kernels in interpret mode.

The CUDA kernels themselves run only on the card, where chip_smoke.py
holds them against the plain loops.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxtpu.ops import pallas_rnn
from mxtpu_torch.ops import rnn_scan
from torch_threads import torch_threads_shared  # noqa: F401

# the decomposition against the plain loop, both in f32: the same
# products summed in another order over at most 200 terms a step
DECOMP_F32_TOL = dict(atol=1e-6, rtol=1e-6)
# against mxtpu's Pallas kernels: tests/test_torch_rnn_scan.py's bounds
F32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16 outputs: both sides carry f32 and round to bf16 once per step; a
# last-bit difference in f32 can flip one rounding by one bf16 ulp
# (2**-8 relative, <= 2**-8 absolute for |h| < 1); allow two
BF16_TOL = dict(atol=2 * 2.0 ** -8, rtol=2 * 2.0 ** -8)

PLAN_H = (1, 37, 200, 512, 1024)
PLAN_N = (1, 3, 32, 33, 200)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# the mode each H takes (the same at every N here): a weight slice
# resident in shared memory up to H = 448 in f32 and 640 in bf16
# (468 in f32 at one row a cluster), streamed from global memory above
MODES = {("f32", 512): "streamed", ("f32", 1024): "streamed",
         ("bf16", 1024): "streamed"}


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("N", PLAN_N)
@pytest.mark.parametrize("H", PLAN_H)
def test_plan_covers_every_unit_and_row_once(H, N, dt):
    for kind in ("lstm", "gru"):
        p = rnn_scan.scan_plan(kind, 32, N, H, DTYPES[dt], torch.float32)
        assert p.cluster in (8, 16)
        assert 1 <= p.rows <= rnn_scan.MAX_ROWS
        # every unit in exactly one CTA's slice, slices in order
        units = []
        for rank in range(p.cluster):
            u0, nu = rnn_scan.unit_slice(rank, H, p.cluster)
            units += list(range(u0, u0 + nu))
        assert units == list(range(H))
        # every row in exactly one cluster
        rows = [c * p.rows + r for c in range(p.clusters)
                for r in range(p.rows) if c * p.rows + r < N]
        assert rows == list(range(N))
        assert (p.clusters - 1) * p.rows < N <= p.clusters * p.rows
        # a block holds the largest slice (8 lanes and 4 column slots a
        # unit) and fits the card's limits
        assert p.threads % 32 == 0 and p.threads <= 1024
        assert p.threads // 8 >= -(-H // p.cluster)
        assert p.col_stride >= 4 * (p.threads // 8)
        assert p.smem <= 227 * 1024
        assert p.mode == MODES.get((dt, H), "resident")


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_plan_fills_the_card_at_the_served_shape(dt):
    """T=32, N=32, H=200: 11 clusters of 8 CTAs, 3 rows each, one CTA an
    SM (the card holds 15 such clusters at once), the weight slice
    resident; one row still takes a whole cluster."""
    p = rnn_scan.scan_plan("lstm", 32, 32, 200, DTYPES[dt], torch.float32)
    assert (p.cluster, p.rows, p.clusters, p.mode) == (8, 3, 11, "resident")
    assert p.clusters <= rnn_scan.CLUSTERS_AT_ONCE[p.cluster]
    p1 = rnn_scan.scan_plan("lstm", 32, 1, 200, DTYPES[dt], torch.float32)
    assert (p1.cluster, p1.rows, p1.clusters) == (8, 1, 1)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("H", (37, 200, 448, 640, 1024, 2048))
def test_resident_slice_loads_spread_over_banks(H, dt):
    """One pass of a warp's vector loads of the weight slice: lane s of
    unit ul reads k-quad s + 8i of column 4 ul + g. In f32 a pass is 8
    lanes of 16 bytes (one unit) and touches 32 distinct 4-byte banks; in
    bf16 it is 16 lanes of 8 bytes (two units) and touches none more
    than twice."""
    elem = DTYPES[dt].itemsize
    p = rnn_scan.scan_plan("lstm", 1, 1, H, DTYPES[dt], torch.float32)
    per_pass = 8 if elem == 4 else 16
    for i in (0, 1):
        for g in range(4):
            for first in range(0, 32, per_pass):
                banks = []
                for lane in range(first, first + per_pass):
                    s, ul = lane % 8, lane // 8
                    col = ul * 4 + g
                    word = ((8 * i + s) * p.col_stride + col) * elem
                    banks += [(word + j) % 32 for j in range(elem)]
                most = max(banks.count(b) for b in set(banks))
                assert most == (1 if elem == 4 else 2), (H, dt, most)


def test_plan_limit_is_pinned():
    """The kernel takes H up to 2048 (128 units of 8 lanes a CTA of a
    16-CTA cluster) and refuses what it cannot take."""
    p = rnn_scan.scan_plan("gru", 4, 7, 2048, torch.float32, torch.float32)
    assert (p.cluster, p.threads, p.mode) == (16, 1024, "streamed")
    for kind, T, N, H in (("lstm", 1, 1, 2049), ("gru", 1, 1, 9000),
                          ("lstm", 0, 1, 8), ("lstm", 1, 0, 8),
                          ("gru", 1, 1, 0)):
        with pytest.raises(ValueError):
            rnn_scan.scan_plan(kind, T, N, H, torch.float32, torch.float32)
    with pytest.raises(ValueError):
        rnn_scan._check_sizes("lstm_scan", 2, 2, 3000, torch.bfloat16,
                              torch.float32)


# ---------------------------------------------------------------------------
# the decomposition, written out as the kernel cuts it
# ---------------------------------------------------------------------------

def _lane_sum(parts, g):
    """Slot g's total over a unit's SPLIT lane partials, in the order of
    the kernel's transposed shuffle reduction as lane g * SPLIT/4 ends
    it: pairs s, s ^ SPLIT/2, then s ^ SPLIT/4, then the rest down to
    s ^ 1."""
    split = len(parts)

    def total(s, off):
        if off == split // 2:
            return parts[s] + parts[s ^ off]
        return total(s, 2 * off) + total(s ^ off, 2 * off)
    return total(g * split // 4, 1)


def _weight_slice(kind, weights, H, u0, nu, col_stride):
    """The CTA's resident slice, (H/4, col_stride, 4) f32: unit ul's slot
    g at column 4 ul + g holds weight column g*H + u0 + ul (the GRU: r, z
    of whrz, n of whn, slot 3 zero)."""
    hq = -(-H // 4)
    w = torch.zeros(4 * hq, col_stride)
    for ul in range(nu):
        u = u0 + ul
        if kind == "lstm":
            cols = [weights[0][:, g * H + u] for g in range(4)]
        else:
            cols = [weights[0][:, u], weights[0][:, H + u],
                    weights[1][:, u]]
        for g, col in enumerate(cols):
            w[:H, 4 * ul + g] = col.float()
    return w.view(hq, 4, col_stride).transpose(1, 2)


def cluster_scan(kind, x_proj, h0, c0, weights, bhn, plan):
    """lstm_scan/gru_scan as the cluster kernel computes them under
    ``plan``: per cluster R rows (zeros past N), per CTA a unit slice,
    per unit 8 lanes, lane s summing k-quads q = s, s + 8, ... of all four
    slots, the partials added in the kernel's order, slots gathered into
    the pointwise update,
    and each CTA's new h stored into every peer's buffer of the next
    step's parity."""
    T, N, _ = x_proj.shape
    H = h0.shape[-1]
    C, R, S = plan.cluster, plan.rows, rnn_scan.SPLIT
    hq = -(-H // 4)
    slices = [rnn_scan.unit_slice(rank, H, C) for rank in range(C)]
    wsl = [_weight_slice(kind, weights, H, u0, nu, plan.col_stride)
           for u0, nu in slices]
    xs = x_proj.float()
    ys = torch.zeros(T, N, H)
    hT = torch.zeros(N, H)
    cT = torch.zeros(N, H)
    for cl in range(plan.clusters):
        n0 = cl * R
        live = [r for r in range(R) if n0 + r < N]
        rows = [n0 + r for r in live]
        # every CTA's h buffers [parity][row][4 hq], h0 in parity 0
        hbuf = torch.zeros(C, 2, R, 4 * hq)
        hbuf[:, 0, live, :H] = h0[rows].float()
        c = torch.zeros(R, H)
        if kind == "lstm":
            c[live] = c0[rows].float()
        for t in range(T):
            cur, nxt = t % 2, 1 - t % 2
            x = torch.zeros(R, xs.shape[-1])
            x[live] = xs[t, rows]
            new = []
            for rank, (u0, nu) in enumerate(slices):
                if nu == 0:
                    new.append(None)
                    continue
                hb = hbuf[rank, cur].view(R, hq, 4)
                parts = [torch.einsum("rqk,qck->rc", hb[:, s::S],
                                      wsl[rank][s::S]) for s in range(S)]
                acc = torch.stack([_lane_sum(parts, g) for g in range(4)])
                acc = acc[:, :, :4 * nu].reshape(4, R, nu, 4)
                acc = torch.stack([acc[g, :, :, g] for g in range(4)], -1)
                u = torch.arange(u0, u0 + nu)
                if kind == "lstm":
                    pre = torch.stack([x[:, g * H + u] for g in range(4)], -1)
                    pre = pre + acc
                    i, f = torch.sigmoid(pre[..., 0]), torch.sigmoid(pre[..., 1])
                    g_, o = torch.tanh(pre[..., 2]), torch.sigmoid(pre[..., 3])
                    c[:, u] = f * c[:, u] + i * g_
                    h = o * torch.tanh(c[:, u])
                else:
                    r_ = torch.sigmoid(x[:, u] + acc[..., 0])
                    z = torch.sigmoid(x[:, H + u] + acc[..., 1])
                    hn = acc[..., 2] + bhn.float()[u]
                    n = torch.tanh(x[:, 2 * H + u] + r_ * hn)
                    h = (1 - z) * n + z * hb.reshape(R, -1)[:, u]
                new.append(h)
            for rank, (u0, nu) in enumerate(slices):
                if nu == 0:
                    continue
                ys[t, rows, u0:u0 + nu] = new[rank][live]
                if t + 1 < T:
                    for peer in range(C):
                        hbuf[peer, nxt, :, u0:u0 + nu] = new[rank]
                else:
                    hT[rows, u0:u0 + nu] = new[rank][live]
                    cT[rows, u0:u0 + nu] = c[live, u0:u0 + nu]
        # the cluster's CTAs agree on h at the last exchanged parity
        if T > 1:
            last = (T - 1) % 2
            assert all(torch.equal(hbuf[0, last], hbuf[p, last])
                       for p in range(C))
    ys = ys.to(x_proj.dtype)
    if kind == "lstm":
        return ys, hT.to(h0.dtype), cT.to(c0.dtype)
    return ys, hT.to(h0.dtype)


def _inputs(kind, T, N, H, seed):
    rng = np.random.RandomState(seed)
    G = 4 * H if kind == "lstm" else 3 * H
    x = [rng.standard_normal((T, N, G)), rng.standard_normal((N, H)) * 0.5]
    if kind == "lstm":
        x += [rng.standard_normal((N, H)) * 0.5,
              rng.standard_normal((H, 4 * H)) * 0.07]
    else:
        x += [rng.standard_normal((H, 2 * H)) * 0.07,
              rng.standard_normal((H, H)) * 0.07,
              rng.standard_normal((H,)) * 0.1]
    return [a.astype(np.float32) for a in x]


def _run_cluster(kind, a, plan):
    if kind == "lstm":
        xp, h0, c0, wh = a
        return cluster_scan(kind, xp, h0, c0, [wh], None, plan)
    xp, h0, whrz, whn, bhn = a
    return cluster_scan(kind, xp, h0, None, [whrz, whn], bhn, plan)


def _torch(arrays, dtype):
    """x_proj and the weights in ``dtype``, the state in f32 (mixed
    dtypes, as the kernel takes them) when dtype is bf16."""
    out = [torch.from_numpy(a).to(dtype) for a in arrays]
    out[1] = torch.from_numpy(arrays[1])
    return out


def _hold(got, want, dtype_tol):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and tuple(g.shape) == tuple(w.shape)
        tol = DECOMP_F32_TOL if g.dtype == torch.float32 else dtype_tol
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   **tol)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("T", (1, 5))
@pytest.mark.parametrize("N", (1, 3, 33))
@pytest.mark.parametrize("H", (200, 37))
@pytest.mark.parametrize("kind", ("lstm", "gru"))
def test_decomposition_matches_plain_loop_and_pallas(kind, H, N, T, dt):
    dtype = DTYPES[dt]
    a = _inputs(kind, T, N, H, seed=H + 7 * N + T)
    args = _torch(a, dtype)
    plan = rnn_scan.scan_plan(kind, T, N, H, dtype, torch.float32)
    got = _run_cluster(kind, args, plan)
    plain = (rnn_scan.lstm_scan_reference if kind == "lstm"
             else rnn_scan.gru_scan_reference)(*args)
    _hold(got, plain, BF16_TOL)
    # mxtpu's Pallas kernel (interpret mode on the CPU) on the same values
    jargs = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in args]
    want = (pallas_rnn.lstm_scan if kind == "lstm"
            else pallas_rnn.gru_scan)(*jargs)
    for g, w in zip(got, want):
        tol = F32_TOL if g.dtype == torch.float32 else BF16_TOL
        np.testing.assert_allclose(_np32(g), _np32(w), **tol)


@pytest.mark.parametrize("cluster,rows", [
    (8, 2),         # 3 rows over 2 clusters: the last one ragged
    (16, 4),        # 16 CTAs, some with no unit at H = 9
    (8, 3),
    (16, 1)])
@pytest.mark.parametrize("kind", ("lstm", "gru"))
def test_decomposition_holds_at_other_cuts(kind, cluster, rows):
    """Ragged row groups and CTAs with empty slices give the plain
    loop's answer."""
    T, N, H = 4, 3, 9
    a = _torch(_inputs(kind, T, N, H, seed=cluster + rows), torch.float32)
    base = rnn_scan.scan_plan(kind, T, N, H, torch.float32, torch.float32)
    units = -(-H // cluster)
    threads = -(-units // 4) * 32           # 4 units of 8 lanes a warp
    plan = base._replace(cluster=cluster, rows=rows, threads=threads,
                         col_stride=threads // 2 + 1,
                         clusters=-(-N // rows))
    got = _run_cluster(kind, a, plan)
    plain = (rnn_scan.lstm_scan_reference if kind == "lstm"
             else rnn_scan.gru_scan_reference)(*a)
    _hold(got, plain, BF16_TOL)
