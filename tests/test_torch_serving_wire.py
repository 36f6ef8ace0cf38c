"""The serving replica over the wire on the CPU: ``tests/test_serving.py``'s
cases on the PyTorch port (engine buckets, the dynamic batcher,
admission, deadlines, drain, client failover, all on loopback threads of
this process), and the two packages answering each other over TCP:
``mxtpu``'s ``ServingClient`` against the port's ``ModelServer`` and the
port's client against ``mxtpu``'s server, with the same verdicts
(``ok``, ``overloaded``, ``expired``, ``err`` for an oversized request)
and answers within 1e-5 of the serving side's own engine.

A single-bucket menu makes a request's bits independent of the batch it
coalesced into; every fault comes from a ``fault`` schedule, and every
wait is bounded.
"""
import threading

import numpy as np
import pytest

import mxtpu
import mxtpu.serving
import mxtpu_torch as mt
from mxtpu_torch import fault
from mxtpu_torch import kvstore_async as ka
from mxtpu_torch.serving import (DeadlineExceeded, InferenceEngine,
                                 ModelServer, Overloaded, ServingClient,
                                 parse_buckets, parse_shape_spec)
from torch_threads import torch_threads_shared  # noqa: F401

IN_DIM = 6
# the same MLP, numpy weights, in both packages: float32 matmuls summed
# in another order
CROSS_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _serving_knobs(monkeypatch):
    monkeypatch.setenv("MXTPU_PS_HEARTBEAT", "0")
    for mod in (ka, mxtpu.kvstore_async):
        monkeypatch.setattr(mod, "_RETRIES", 1)
        monkeypatch.setattr(mod, "_BACKOFF", 0.01)
        monkeypatch.setattr(mod, "_BACKOFF_MAX", 0.05)
        monkeypatch.setattr(mod, "_RECONNECT_TIMEOUT", 0.2)
        monkeypatch.setattr(mod, "_DEAD_AFTER", 2)
    fault.uninstall()
    mxtpu.fault.uninstall()
    yield
    fault.uninstall()
    mxtpu.fault.uninstall()


def mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def mlp_params(seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.uniform(-0.1, 0.1, (8, IN_DIM)).astype("f")
            * scale,
            "fc1_bias": rng.uniform(-0.1, 0.1, 8).astype("f") * scale,
            "fc2_weight": rng.uniform(-0.1, 0.1, (3, 8)).astype("f") * scale,
            "fc2_bias": rng.uniform(-0.1, 0.1, 3).astype("f") * scale}


@pytest.fixture(scope="module")
def model():
    return mlp(mt), mlp_params(), {}


def _engine(model, buckets=(1, 2, 4), warm=True):
    net, arg_params, aux_params = model
    return InferenceEngine(net, arg_params, aux_params, {"data": (IN_DIM,)},
                           buckets=buckets, warm=warm, ctx=mt.cpu())


def _server(model, **kw):
    kw.setdefault("batch_deadline_ms_", 10)
    buckets = kw.pop("buckets", (1, 2, 4))
    return ModelServer(_engine(model, buckets=buckets, warm=False),
                       model_name="t", **kw).start()


# ---------------------------------------------------------------------------
# spec parsing and the engine
# ---------------------------------------------------------------------------

def test_spec_parsing():
    assert parse_buckets("8,1,4,4") == (1, 4, 8)
    with pytest.raises(ValueError):
        parse_buckets("0,2")
    assert parse_shape_spec("data=3,32,32") == {"data": (3, 32, 32)}
    assert parse_shape_spec("a=4;b=2,2") == {"a": (4,), "b": (2, 2)}
    with pytest.raises(ValueError):
        parse_shape_spec("nodims")


def test_engine_warm_compiles_every_bucket_then_zero_retraces(model):
    eng = _engine(model, buckets=(1, 2, 4), warm=True)
    assert eng.cache.compiles == 3
    x = np.random.RandomState(0).rand(3, IN_DIM).astype("f")
    for _ in range(4):
        out = eng.predict([x])
    assert eng.cache.compiles == 3
    assert out[0].shape == (3, 3)
    assert eng.stats()["pad_rows"] == 4 * 1      # 3 rows in the 4-bucket


def test_engine_validates_payloads(model):
    eng = _engine(model, buckets=(1, 2), warm=False)
    with pytest.raises(ValueError):
        eng.check_rows([np.zeros((1, IN_DIM + 1), "f")])
    with pytest.raises(ValueError):
        eng.check_rows([np.zeros((3, IN_DIM), "f")])
    with pytest.raises(ValueError):
        eng.check_rows([np.zeros((0, IN_DIM), "f")])
    assert eng.check_rows([np.zeros((2, IN_DIM), "f")]) == 2


def test_engine_from_checkpoint_roundtrip(model, tmp_path):
    net, arg_params, _aux = model
    prefix = str(tmp_path / "m")
    mt.model.save_checkpoint(prefix, 3, net, {
        k: mt.nd.array(v, ctx=mt.cpu()) for k, v in arg_params.items()}, {})
    eng = InferenceEngine.from_checkpoint(prefix, 3, {"data": (IN_DIM,)},
                                          buckets=(2,), warm=False,
                                          ctx=mt.cpu())
    direct = _engine(model, buckets=(2,), warm=False)
    x = np.random.RandomState(1).rand(2, IN_DIM).astype("f")
    np.testing.assert_array_equal(eng.predict([x])[0],
                                  direct.predict([x])[0])


def test_single_bucket_bits_are_composition_independent(model):
    eng = _engine(model, buckets=(4,), warm=True)
    rng = np.random.RandomState(2)
    xs = [rng.rand(1, IN_DIM).astype("f") for _ in range(4)]
    alone = [eng.predict([x])[0] for x in xs]
    packed = eng.predict([np.concatenate(xs)])[0]
    for i in range(4):
        np.testing.assert_array_equal(alone[i][0], packed[i])


# ---------------------------------------------------------------------------
# batching and admission on the server
# ---------------------------------------------------------------------------

def _concurrent(cli, xs, budget_ms=None):
    outs, errs = {}, {}
    lock = threading.Lock()

    def one(i):
        try:
            r = cli.predict(xs[i], budget_ms=budget_ms)[0]
            with lock:
                outs[i] = r
        except Exception as e:
            with lock:
                errs[i] = e

    ts = [threading.Thread(target=one, args=(i,)) for i in range(len(xs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    return outs, errs


def test_concurrent_requests_coalesce_into_buckets(model):
    srv = _server(model, batch_deadline_ms_=25)
    try:
        cli = ServingClient(addrs=[srv.address], budget_ms=5000)
        xs = [np.full((1, IN_DIM), float(i), "f") for i in range(8)]
        outs, errs = _concurrent(cli, xs)
        assert not errs
        assert len(outs) == 8
        b = srv.stats()["batcher"]
        assert b["batches"] < b["batched_requests"] == 8
        assert b["max_batch_rows"] <= 4
        for out in outs.values():
            assert out.shape == (1, 3)
    finally:
        srv.stop()


def test_local_transport_parity(model, monkeypatch):
    monkeypatch.setattr(ka, "_LOCAL_ON", True)
    srv = _server(model)
    try:
        cli = ServingClient(addrs=[srv.address], budget_ms=5000)
        out = cli.predict(np.ones((2, IN_DIM), "f"))[0]
        assert out.shape == (2, 3)
        assert cli.stats()["comms"]["local_reqs"] >= 1
        assert srv.stats()["counters"]["responses"] == 1
    finally:
        srv.stop()


def test_queue_full_sheds_with_retriable_verdict(model):
    srv = _server(model, queue_depth_=0)
    try:
        cli = ServingClient(addrs=[srv.address], budget_ms=2000)
        with pytest.raises(Overloaded) as ei:
            cli.predict(np.ones((1, IN_DIM), "f"))
        assert ei.value.retriable
        assert any(v == "overloaded" for _, v, _ in ei.value.verdicts)
        assert srv.stats()["counters"]["shed_overloaded"] == 1
        assert srv.stats()["batcher"]["shed_queue_full"] == 1
    finally:
        srv.stop()


def test_deadline_expiry_drops_before_dispatch(model):
    srv = _server(model, batch_deadline_ms_=50)
    try:
        cli = ServingClient(addrs=[srv.address])
        with pytest.raises(DeadlineExceeded):
            cli.predict(np.ones((1, IN_DIM), "f"), budget_ms=1.0)
        c = srv.stats()["counters"]
        assert c["expired"] == 1
        assert c["responses"] == 0
        assert srv.stats()["engine"]["predicts"] == 0
    finally:
        srv.stop()


def test_injected_admission_delay_burns_budget(model):
    srv = _server(model, batch_deadline_ms_=5)
    try:
        cli = ServingClient(addrs=[srv.address])
        with fault.inject("kind=delay,point=serve.request,delay=0.08"):
            with pytest.raises(DeadlineExceeded):
                cli.predict(np.ones((1, IN_DIM), "f"), budget_ms=30.0)
        assert srv.stats()["counters"]["expired"] == 1
    finally:
        srv.stop()


def test_drain_refuses_then_flushes(model):
    srv = _server(model, batch_deadline_ms_=100)
    try:
        cli = ServingClient(addrs=[srv.address], budget_ms=5000)
        got = {}
        t = threading.Thread(target=lambda: got.setdefault(
            "out", cli.predict(np.ones((1, IN_DIM), "f"))))
        t.start()
        deadline = 50
        while srv._batcher.pending() == 0 and deadline:
            deadline -= 1
            threading.Event().wait(0.01)
        assert srv.drain(timeout=10.0)
        t.join(timeout=10)
        assert got["out"][0].shape == (1, 3)
        with pytest.raises(Overloaded) as ei:
            cli.predict(np.ones((1, IN_DIM), "f"))
        assert any(v == "draining" for _, v, _ in ei.value.verdicts)
        assert srv.stats()["counters"]["shed_draining"] >= 1
    finally:
        srv.stop()


def test_drain_sends_the_replies_of_what_it_flushed(model, monkeypatch):
    """A drain returns once the replies of the requests it flushed are
    sent, so the stop that follows it (the replica process's SIGTERM
    path) loses none: here the reply waits in its sender (a
    ``server.send`` delay) when the drain and the stop come."""
    monkeypatch.setattr(ka, "_LOCAL_ON", False)
    srv = _server(model)
    try:
        cli = ServingClient(addrs=[srv.address], budget_ms=5000)
        got = []
        with fault.inject("kind=delay,point=server.send,op=predict,"
                          "delay=0.3"):
            t = threading.Thread(target=lambda: got.append(
                cli.predict(np.ones((1, IN_DIM), "f"))))
            t.start()
            deadline = 500
            while srv._batcher.stats()["batches"] == 0 and deadline:
                deadline -= 1
                threading.Event().wait(0.01)
            assert srv.drain(timeout=10.0)
            srv.stop()
            t.join(timeout=30)
        assert got and got[0][0].shape == (1, 3)
    finally:
        srv.stop()


def test_drain_is_not_held_by_a_reply_to_a_gone_client(model, monkeypatch):
    """A request whose client went away before its batch flushed leaves
    no reply for the drain to wait for."""
    monkeypatch.setattr(ka, "_LOCAL_ON", False)
    srv = _server(model, batch_deadline_ms_=300)
    try:
        conn = ka._ServerConn(srv.address)
        ch = conn._channel()
        ch.submit(("predict", "gone:1", (np.ones((1, IN_DIM), "f"),),
                   5000.0), timeout=10.0)
        deadline = 500
        while srv._batcher.pending() == 0 and deadline:
            deadline -= 1
            threading.Event().wait(0.01)
        conn.close()
        deadline = 500
        while srv._batcher.stats()["batches"] == 0 and deadline:
            deadline -= 1
            threading.Event().wait(0.01)
        assert srv._batcher.stats()["batches"] == 1
        assert srv.drain(timeout=2.0)
    finally:
        srv.stop()


def test_client_drain_is_the_wire_form_of_sigterm(model):
    srv = _server(model)
    try:
        cli = ServingClient(addrs=[srv.address])
        assert cli.drain(timeout=5.0) == {"draining": True}
        deadline = 100
        while not srv._batcher._stopped and deadline:
            deadline -= 1
            threading.Event().wait(0.01)
        with pytest.raises(Overloaded) as ei:
            cli.predict(np.ones((1, IN_DIM), "f"))
        assert any(v == "draining" for _, v, _ in ei.value.verdicts)
    finally:
        srv.stop()


def test_oversized_request_is_an_error_not_a_shed(model):
    srv = _server(model)
    try:
        cli = ServingClient(addrs=[srv.address])
        with pytest.raises(RuntimeError, match="bad predict payload"):
            cli.predict(np.ones((5, IN_DIM), "f"))
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# replica failover
# ---------------------------------------------------------------------------

def _pair(model, **kw):
    s1 = _server(model, buckets=(4,), **kw)
    s2 = ModelServer(_engine(model, buckets=(4,), warm=False),
                     model_name="t", batch_deadline_ms_=10,
                     replicas=[s1.address], **kw).start()
    s1._replicas.append(s2.address)
    return s1, s2


def test_hello_learns_replica_set(model):
    s1, s2 = _pair(model)
    try:
        cli = ServingClient(addrs=[s1.address])
        info = cli.hello()
        assert sorted(info["replicas"]) == sorted([s1.address, s2.address])
        assert cli.signature["data_names"] == ["data"]
        assert sorted(cli.stats()["replicas"]) == \
            sorted([s1.address, s2.address])
    finally:
        s2.stop()
        s1.stop()


def test_killed_replica_fails_over_exactly_once(model):
    s1, s2 = _pair(model)
    try:
        cli = ServingClient(addrs=[s1.address], budget_ms=5000)
        cli.hello()
        rng = np.random.RandomState(3)
        xs = [rng.rand(1, IN_DIM).astype("f") for _ in range(6)]
        oracle = _engine(model, buckets=(4,), warm=True)
        want = [oracle.predict([x])[0] for x in xs]
        with fault.inject("kind=kill,point=serve.batch,nth=1") as inj:
            outs, errs = _concurrent(cli, xs)
        assert inj.stats()[0][4] == 1, "kill never fired"
        assert not errs, errs
        assert len(outs) == 6
        for i, out in outs.items():
            np.testing.assert_array_equal(out, want[i][:1])
        assert cli.stats()["failovers"] >= 1
        alive = [s for s in (s1, s2) if not s._tcp.dying]
        assert len(alive) == 1
        assert alive[0].stats()["counters"]["responses"] >= 1
    finally:
        s2.stop()
        s1.stop()


def test_draining_replica_steers_clients_to_peer(model):
    s1, s2 = _pair(model)
    try:
        cli = ServingClient(addrs=[s1.address], budget_ms=5000)
        cli.hello()
        active = cli.stats()["active"]
        draining = s1 if active == s1.address else s2
        other = s2 if draining is s1 else s1
        draining.drain(timeout=5.0)
        out = cli.predict(np.ones((1, IN_DIM), "f"))[0]
        assert out.shape == (1, 3)
        assert other.stats()["counters"]["responses"] == 1
        assert draining.stats()["counters"]["shed_draining"] == 1
        assert cli.stats()["failovers"] >= 1
    finally:
        s2.stop()
        s1.stop()


def test_dup_request_ids_are_counted(model):
    srv = _server(model)
    try:
        cli = ServingClient(addrs=[srv.address], budget_ms=2000)
        x = np.ones((1, IN_DIM), "f")
        cli.predict(x)
        conn = cli._conn_for(srv.address)
        rid = "%s:%d" % (cli._origin, 1)
        reply = conn.request("predict", rid, (x,), 2000.0, timeout=30.0,
                             retries=0)
        assert reply[0] == "ok"
        assert srv.stats()["counters"]["dup_requests"] == 1
    finally:
        srv.stop()


def test_injected_drop_replays_on_peer(model):
    s1, s2 = _pair(model)
    try:
        cli = ServingClient(addrs=[s1.address], budget_ms=2000)
        cli.hello()
        with fault.inject("kind=drop,point=serve.request,nth=1,count=1"):
            out = cli.predict(np.ones((1, IN_DIM), "f"))[0]
        assert out.shape == (1, 3)
        total = (s1.stats()["counters"]["dropped"]
                 + s2.stats()["counters"]["dropped"])
        assert total == 1
        assert cli.stats()["replays"] >= 1
    finally:
        s2.stop()
        s1.stop()


def test_server_stats_surface_the_story(model):
    srv = _server(model)
    try:
        cli = ServingClient(addrs=[srv.address], budget_ms=2000)
        cli.predict(np.ones((2, IN_DIM), "f"))
        s = cli.server_stats()
        assert s["counters"]["responses"] == 1
        assert s["batcher"]["batches"] == 1
        assert s["batcher"]["batched_rows"] == 2
        assert s["engine"]["predicts"] == 1
        assert s["queue_depth"] >= 1 and "batch_deadline_ms" in s
    finally:
        srv.stop()


def test_replica_resumed_mid_rotation_answers(model):
    """A rolling hot swap drains the replicas in turn: a request shed
    ``draining`` by the first and then by the second finds the first
    resumed when the rotation comes back to it (its probe says so) and is
    answered there, not refused as shed by all."""
    s1, s2 = _pair(model)
    try:
        cli = ServingClient(addrs=[s1.address, s2.address], budget_ms=5000)
        s1.drain(timeout=5.0)
        s2.drain(timeout=5.0)
        with pytest.raises(Overloaded):
            cli.predict(np.ones((1, IN_DIM), "f"))
        probe = cli._probe

        def resume_then_probe(addr):
            if addr == s1.address and s1._draining:
                s1.resume()         # the swap moved on to the next replica
            return probe(addr)
        cli._probe = resume_then_probe
        out = cli.predict(np.ones((1, IN_DIM), "f"))[0]
        assert out.shape == (1, 3)
        assert s1.stats()["counters"]["responses"] == 1
        assert s2.stats()["counters"]["shed_draining"] == 2
    finally:
        s2.stop()
        s1.stop()


def test_stale_epoch_probe_cannot_demote_healthy_replica(model):
    s1, s2 = _pair(model)
    try:
        cli = ServingClient(addrs=[s1.address, s2.address], budget_ms=5000)
        assert cli._probe(s1.address) is True
        e0 = cli._addr_epoch[s1.address]
        s1.drain(timeout=5.0)
        assert cli._probe(s1.address) is False
        s1.resume()
        assert cli._probe(s1.address) is True
        assert cli._addr_epoch[s1.address] == e0 + 2
        conn = cli._conn_for(s1.address)
        conn.last_ping = {"draining": True, "epoch": e0 + 1}
        orig_ping = conn.ping
        conn.ping = lambda **kw: True
        try:
            assert cli._probe(s1.address) is True
        finally:
            conn.ping = orig_ping
        assert cli.stats()["failovers"] == 0
    finally:
        s2.stop()
        s1.stop()


# ---------------------------------------------------------------------------
# the two packages over TCP, both ways
# ---------------------------------------------------------------------------

def _mxtpu_engine(buckets, warm=True):
    return mxtpu.serving.InferenceEngine(
        mlp(mxtpu), mlp_params(), {}, {"data": (IN_DIM,)}, buckets=buckets,
        warm=warm)


def _cross_pair(direction, **kw):
    """(server, client, the server side's own engine) with the server of
    one package and the client of the other; real sockets both ways."""
    kw.setdefault("batch_deadline_ms_", 10)
    if direction == "mxtpu_client_port_server":
        eng = _engine((mlp(mt), mlp_params(), {}), buckets=(1, 2, 4),
                      warm=False)
        srv = ModelServer(eng, model_name="t", **kw).start()
        cli = mxtpu.serving.ServingClient(addrs=[srv.address],
                                          budget_ms=5000)
    else:
        eng = _mxtpu_engine((1, 2, 4), warm=False)
        srv = mxtpu.serving.ModelServer(eng, model_name="t", **kw).start()
        cli = ServingClient(addrs=[srv.address], budget_ms=5000)
    return srv, cli, eng


DIRECTIONS = ("mxtpu_client_port_server", "port_client_mxtpu_server")


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_cross_package_ok_answers(direction, monkeypatch):
    monkeypatch.setattr(ka, "_LOCAL_ON", False)
    monkeypatch.setattr(mxtpu.kvstore_async, "_LOCAL_ON", False)
    srv, cli, eng = _cross_pair(direction)
    try:
        info = cli.hello()
        assert info["model"] == "t"
        assert info["signature"]["data_names"] == ["data"]
        assert info["models"]["t"]["weights"]["version"] == 0
        rng = np.random.RandomState(5)
        for rows in (1, 3):
            x = rng.rand(rows, IN_DIM).astype("f")
            out, rinfo = cli.predict2(x)
            assert rinfo["version"] == 0 and rinfo["batch_rows"] == rows
            want = eng.predict([x])[0]
            np.testing.assert_allclose(out[0], want, **CROSS_TOL)
            other = _mxtpu_engine((1, 2, 4)) if \
                direction == "mxtpu_client_port_server" else \
                _engine((mlp(mt), mlp_params(), {}))
            np.testing.assert_allclose(out[0], other.predict([x])[0],
                                       **CROSS_TOL)
        assert cli.server_stats()["counters"]["responses"] == 2
    finally:
        cli.close()
        srv.stop()


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("verdict", ["overloaded", "expired", "err"])
def test_cross_package_verdicts(direction, verdict, monkeypatch):
    monkeypatch.setattr(ka, "_LOCAL_ON", False)
    monkeypatch.setattr(mxtpu.kvstore_async, "_LOCAL_ON", False)
    kw = {"overloaded": {"queue_depth_": 0},
          "expired": {"batch_deadline_ms_": 50}, "err": {}}[verdict]
    srv, cli, _eng = _cross_pair(direction, **kw)
    client_pkg = mxtpu.serving if direction.startswith("mxtpu") \
        else mt.serving
    try:
        if verdict == "overloaded":
            with pytest.raises(client_pkg.Overloaded) as ei:
                cli.predict(np.ones((1, IN_DIM), "f"))
            assert [v for _, v, _ in ei.value.verdicts] == ["overloaded"]
        elif verdict == "expired":
            with pytest.raises(client_pkg.DeadlineExceeded):
                cli.predict(np.ones((1, IN_DIM), "f"), budget_ms=1.0)
        else:
            with pytest.raises(RuntimeError, match="bad predict payload"):
                cli.predict(np.ones((5, IN_DIM), "f"))
        counters = srv.stats()["counters"]
        field = {"overloaded": "shed_overloaded", "expired": "expired",
                 "err": "errors"}[verdict]
        assert counters[field] == 1 and counters["responses"] == 0
    finally:
        cli.close()
        srv.stop()
