"""Rematerialization in the PyTorch port (MXNet's
``MXNET_BACKWARD_DO_MIRROR`` and Gluon's ``hybridize(remat=True)``), held
as ``tests/test_remat.py`` holds ``mxtpu``'s: the variable, the
executor's gradients with and without the mirror (the eager step; the
fused step, which ignores the mirror, gives the same weights), and ``hybridize(remat=True)`` with the same loss and
gradients, against each other and against ``mxtpu``.

The port's own evidence that the recompute engages: the tensors autograd
saves for a hybridized block under ``record()`` (counted by
``torch.autograd.graph.saved_tensors_hooks``) are fewer with remat, and
the executor's mirrored forward records no graph. With Dropout and
BatchNorm in the body, the recompute applies the forward's masks and the
moving statistics are blended once: the results equal the plain run's.

Tolerances: the plain and the rematerialized run compute the same float32
ops in the same order, so they agree exactly (0); against ``mxtpu``,
1e-5 (float32 sums in another order).
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu_torch.base import backward_mirror_enabled
from torch_threads import torch_threads_shared  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


def test_env_knob(monkeypatch):
    from mxtpu.base import backward_mirror_enabled as mx_knob
    for value, want in ((None, False), ("1", True), ("0", False),
                        ("true", False)):
        if value is None:
            monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR", raising=False)
        else:
            monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", value)
        assert backward_mirror_enabled() is want is mx_knob()


def _mlp_sym(pkg, dropout=False):
    net = pkg.sym.var("data")
    for i in range(4):
        net = pkg.sym.FullyConnected(net, name="fc%d" % i, num_hidden=16)
        net = pkg.sym.Activation(net, act_type="tanh")
        if dropout and i == 1:
            net = pkg.sym.Dropout(net, p=0.3)
            net = pkg.sym.BatchNorm(net, name="bn")
    net = pkg.sym.FullyConnected(net, name="out", num_hidden=4)
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _executor_grads(pkg, monkeypatch, mirror, dropout=False):
    if mirror:
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    else:
        monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR", raising=False)
    r = np.random.RandomState(0)
    np.random.seed(5)               # the executor's generator's seed
    ex = _mlp_sym(pkg, dropout).simple_bind(
        ctx=pkg.cpu(), grad_req="write", data=(8, 12), softmax_label=(8,))
    assert ex._mirror == mirror
    for name in sorted(ex.arg_dict):
        arr = ex.arg_dict[name]
        if name == "data":
            arr[:] = r.uniform(-1, 1, arr.shape).astype(np.float32)
        elif name == "softmax_label":
            arr[:] = r.randint(0, 4, arr.shape).astype(np.float32)
        elif name.endswith("gamma"):
            arr[:] = np.ones(arr.shape, np.float32)
        else:
            arr[:] = r.uniform(-0.3, 0.3, arr.shape).astype(np.float32)
    out = ex.forward(is_train=True)[0].asnumpy()
    if pkg is mt:
        assert (ex._tape is None) == mirror   # no graph kept when mirrored
    ex.backward()
    got = {n: g.asnumpy() for n, g in ex.grad_dict.items() if g is not None}
    got["__out"] = out
    got.update({"__aux " + n: a.asnumpy() for n, a in ex.aux_dict.items()})
    return got


@pytest.mark.parametrize("dropout", [False, True])
def test_executor_mirror_same_grads(monkeypatch, dropout):
    """The executor's gradients (and outputs, moving statistics) with and
    without the mirror: equal in the port; equal to mxtpu's mirrored
    executor where no dropout draws."""
    with mt.cpu():
        plain = _executor_grads(mt, monkeypatch, False, dropout)
        mirrored = _executor_grads(mt, monkeypatch, True, dropout)
    assert plain.keys() == mirrored.keys() and len(plain) > 5
    for n in plain:
        np.testing.assert_array_equal(plain[n], mirrored[n], err_msg=n)
    if not dropout:
        want = _executor_grads(mx, monkeypatch, True)
        for n in want:
            np.testing.assert_allclose(mirrored[n], want[n], err_msg=n,
                                       **TOL)


def _fit_params(monkeypatch, mirror):
    if mirror:
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    else:
        monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR", raising=False)
    r = np.random.RandomState(1)
    x = r.uniform(-1, 1, (64, 12)).astype(np.float32)
    y = r.randint(0, 4, (64,)).astype(np.float32)
    np.random.seed(0)
    mt.random.seed(0)
    with mt.cpu():
        it = mt.io.NDArrayIter(x, y, batch_size=16, shuffle=True)
        mod = mt.mod.Module(_mlp_sym(mt, dropout=True), context=mt.cpu())
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mt.init.Xavier())
        assert mod._fused is not None
        args, auxs = mod.get_params()
    return {k: v.asnumpy() for k, v in list(args.items()) +
            list(auxs.items())}


def test_fused_step_mirror_same_weights(monkeypatch):
    """Two epochs of the fused train step (Dropout and BatchNorm in the
    net) with MXNET_BACKWARD_DO_MIRROR=1 and without, from the same seeds:
    the fused step ignores the mirror, so the same weights and moving
    statistics."""
    plain = _fit_params(monkeypatch, False)
    mirrored = _fit_params(monkeypatch, True)
    assert plain.keys() == mirrored.keys()
    for n in plain:
        np.testing.assert_array_equal(plain[n], mirrored[n], err_msg=n)


def _gluon_run(pkg, remat, dropout=False, count=False, weights=None):
    pkg.random.seed(0)
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="net_")
    with net.name_scope():
        for _ in range(3):
            net.add(nn.Dense(16, activation="tanh"))
        if dropout:
            net.add(nn.Dropout(0.3))
            net.add(nn.BatchNorm())
        net.add(nn.Dense(4))
    # mxtpu's side starts from zeros and takes the port's draw: its
    # initializers compile JAX's random number code for every shape
    net.initialize(pkg.init.Xavier() if pkg is mt else pkg.init.Zero(),
                   force_reinit=True)
    x = pkg.nd.array(np.random.RandomState(1)
                     .uniform(-1, 1, (8, 12)).astype(np.float32))
    net(x)
    if weights is not None:
        for k, p in net.collect_params().items():
            p.set_data(pkg.nd.array(weights[k]))
    weights = {k: p.data().asnumpy()
               for k, p in net.collect_params().items()}
    net.hybridize(remat=remat)
    saved = [0]

    def pack(t):
        saved[0] += 1
        return t
    hooks = torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t) \
        if count else None
    if hooks:
        hooks.__enter__()
    try:
        with pkg.autograd.record():
            out = net(x)
            loss = (out * out).mean()
    finally:
        if hooks:
            hooks.__exit__(None, None, None)
    loss.backward()
    params = net.collect_params()
    grads = [params[k].grad().asnumpy() for k in sorted(params)
             if params[k].grad_req != "null"]
    stats = [params[k].data().asnumpy() for k in sorted(params)
             if params[k].grad_req == "null"]
    return float(loss.asnumpy()), grads, stats, saved[0], weights


def test_hybridize_remat_same_results():
    """``hybridize(remat=True)``: the loss and gradients of remat=False,
    and mxtpu's; fewer tensors saved for the backward."""
    with mt.cpu():
        l0, g0, _, n0, weights = _gluon_run(mt, False, count=True)
        l1, g1, _, n1, _ = _gluon_run(mt, True, count=True, weights=weights)
    lm, gm, _, _, _ = _gluon_run(mx, True, weights=weights)
    assert l0 == l1
    for a, b in zip(g0, g1):
        np.testing.assert_array_equal(a, b)
    assert n1 < n0, (n1, n0)
    np.testing.assert_allclose(l1, lm, rtol=1e-6)
    for a, b in zip(g1, gm):
        np.testing.assert_allclose(a, b, **TOL)


def test_hybridize_remat_dropout_batchnorm():
    """Dropout and BatchNorm inside a rematerialized body: the recompute
    applies the forward's masks (the same loss and gradients as without
    remat) and the moving statistics are blended once."""
    with mt.cpu():
        l0, g0, s0, _, w = _gluon_run(mt, False, dropout=True)
        l1, g1, s1, _, _ = _gluon_run(mt, True, dropout=True, weights=w)
    assert l0 == l1
    for a, b in zip(g0 + s0, g1 + s1):
        np.testing.assert_array_equal(a, b)


def test_remat_reads_the_env_when_not_given(monkeypatch):
    """Without ``remat`` a program reads MXNET_BACKWARD_DO_MIRROR when it
    is built; ``remat=False`` wins over it; no gradient, no remat."""
    with mt.cpu():
        net = mt.gluon.nn.Dense(3, in_units=4)
        net.initialize(ctx=mt.cpu())
        x = mt.nd.ones((2, 4))
        for flag, env, want in ((None, "1", True), (False, "1", False),
                                (None, "0", False), (True, "0", True)):
            monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", env)
            net.hybridize(**({} if flag is None else {"remat": flag}))
            with mt.autograd.record():
                net(x)
            assert [p.remat for p in net.programs()] == [want]
            net(x)                  # outside record(): no gradient
            assert [p.remat for p in net.programs()] == [want, False]
