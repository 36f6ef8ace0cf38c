"""Rollout and weight streaming on the CPU: ``tests/test_rollout.py``'s
cases on the PyTorch port (versioned engine stores, the publisher ->
snapshot directory -> sync stream, canary / A-B routing, promote / abort
verdicts, bit-exact rollback, the hot swap, several models a replica,
streaming under load), and snapshot directories crossing packages:
written by ``mxtpu``'s ``WeightPublisher`` and followed by the port's
``WeightSync``, and the reverse, with equal digests. ``mxtpu``'s
parameter-server weight stream (its cases at ``test_rollout.py:189`` and
``:225``) comes with the port of the parameter server.
"""
import json
import os
import threading
import zlib

import numpy as np
import pytest

import mxtpu
import mxtpu.serving
import mxtpu_torch as mt
from mxtpu_torch import fault
from mxtpu_torch import kvstore_async as ka
from mxtpu_torch.checkpoint import weight_digest
from mxtpu_torch.serving import (InferenceEngine, ModelServer,
                                 RolloutController, ServingClient,
                                 WeightPublisher, WeightSync)
from test_torch_serving_wire import IN_DIM, mlp, mlp_params
from torch_threads import torch_threads_shared  # noqa: F401


@pytest.fixture(autouse=True)
def _serving_knobs(monkeypatch):
    monkeypatch.setenv("MXTPU_PS_HEARTBEAT", "0")
    monkeypatch.setattr(ka, "_RETRIES", 1)
    monkeypatch.setattr(ka, "_BACKOFF", 0.01)
    monkeypatch.setattr(ka, "_BACKOFF_MAX", 0.05)
    monkeypatch.setattr(ka, "_RECONNECT_TIMEOUT", 0.2)
    fault.uninstall()
    yield
    fault.uninstall()


@pytest.fixture(scope="module")
def model():
    return mlp(mt), mlp_params(), {}


def _engine(model, buckets=(4,), warm=False):
    net, arg_params, aux_params = model
    return InferenceEngine(net, arg_params, aux_params, {"data": (IN_DIM,)},
                           buckets=buckets, warm=warm, ctx=mt.cpu())


def _params_v(model, scale):
    return {n: v * scale for n, v in model[1].items()}


# ---------------------------------------------------------------------------
# the engine's versioned stores
# ---------------------------------------------------------------------------

def test_swap_is_a_program_cache_hit_never_a_retrace(model):
    eng = _engine(model, buckets=(1, 4), warm=True)
    base = eng.cache.compiles
    x = np.ones((1, IN_DIM), "f")
    before = eng.predict([x])[0]
    assert eng.swap_weights(_params_v(model, 2.0)) == 1
    after, v = eng.predict_versioned([x])
    assert v == 1
    assert eng.cache.compiles == base
    assert not np.array_equal(after[0], before)
    assert eng.stats()["swaps"] == 1


def test_swap_refuses_shape_mismatch_and_half_tables(model):
    eng = _engine(model)
    good = _params_v(model, 1.0)
    bad = dict(good)
    bad["fc1_weight"] = np.zeros((2, 2), "f")
    with pytest.raises(ValueError, match="never retrace"):
        eng.swap_weights(bad, version=5)
    half = dict(good)
    del half["fc2_bias"]
    assert eng.swap_weights(half, version=5) is None
    assert eng.version_state()["latest"] == 0
    assert eng.stats()["swaps_refused"] >= 1


def test_swap_verifies_digest_and_dedupes_stale_versions(model):
    eng = _engine(model)
    p1 = _params_v(model, 1.5)
    with pytest.raises(ValueError, match="digest"):
        eng.swap_weights(p1, version=1, digest="0" * 64)
    assert eng.swap_weights(p1, version=1, digest=weight_digest(p1)) == 1
    assert eng.swap_weights(_params_v(model, 9.0), version=1) is None
    assert eng.version_state()["version"] == 1
    assert eng.store_digest(1) == weight_digest(p1)


def test_store_retention_keeps_live_set_and_last_k(model, monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_VERSION_KEEP", "2")
    eng = _engine(model)
    for v in range(1, 6):
        eng.swap_weights(_params_v(model, 1.0 + v), version=v)
    state = eng.version_state()
    assert state["version"] == 5
    assert state["versions"] == [4, 5]
    eng.pin(4)
    for v in range(6, 9):
        eng.swap_weights(_params_v(model, 10.0 + v), version=v)
    state = eng.version_state()
    assert 4 in state["versions"] and state["version"] == 4


def test_requests_resolve_one_coherent_version_mid_swap(model):
    eng = _engine(model, warm=True)
    v1 = eng.swap_weights(_params_v(model, 2.0))
    x = np.ones((2, IN_DIM), "f")
    want_v1 = eng.predict_versioned([x], version=v1)[0]
    v2 = eng.swap_weights(_params_v(model, 3.0))
    outs, v = eng.predict_versioned([x], version=v1)
    assert v == v1 and v2 == 2
    np.testing.assert_array_equal(outs[0], want_v1[0])


def test_current_params_route_and_fingerprint(model):
    """``current_params`` gives a version's host bits, ``route_version``
    splits by a crc32 of the request id (mxtpu's rule), and the program
    fingerprint names the signature and the store's shapes."""
    eng = _engine(model)
    eng.swap_weights(_params_v(model, 2.0))
    got = eng.current_params(0)
    for k, v in model[1].items():
        np.testing.assert_array_equal(got[k], v)
    eng.set_canary(0, 0.3)
    for rid in ("a:%d" % i for i in range(50)):
        want = 0 if zlib.crc32(rid.encode()) % 10000 < 3000 else 1
        assert eng.route_version(rid) == want
    fp = eng.program_fingerprint()
    assert fp["signature"]["data_names"] == ["data"]
    assert [8, IN_DIM] in [p[0] for p in fp["params"]]


# ---------------------------------------------------------------------------
# publisher -> snapshot directory -> sync
# ---------------------------------------------------------------------------

def test_publisher_snapshot_stream_end_to_end(model, tmp_path):
    srv = ModelServer(_engine(model), model_name="m",
                      batch_deadline_ms_=5).start()
    sync = None
    try:
        cli = ServingClient(addrs=[srv.address], budget_ms=5000)
        pub = WeightPublisher(str(tmp_path / "w"))
        out = pub.publish(_params_v(model, 2.0), pin=True)
        assert out["version"] == 1 and len(out["digest"]) == 64
        pub.publish(_params_v(model, 3.0))
        sync = WeightSync(srv, weight_dir=str(tmp_path / "w"), poll=0.05)
        assert sync.catch_up() == 2
        _, info = cli.predict2(np.ones((1, IN_DIM), "f"))
        assert info["version"] == 2
        assert sync.stats()["applied"] == 1
        assert pub.stats()["pinned"] == [1]
    finally:
        if sync is not None:
            sync.stop()
        srv.stop()


def test_sync_skips_corrupt_newest_snapshot(model, tmp_path):
    srv = ModelServer(_engine(model), model_name="m").start()
    sync = None
    try:
        pub = WeightPublisher(str(tmp_path / "w"))
        pub.publish(_params_v(model, 2.0))
        pub.publish(_params_v(model, 3.0))
        with open(os.path.join(str(tmp_path / "w"), "step_2",
                               "params.npz"), "wb") as f:
            f.write(b"torn")
        sync = WeightSync(srv, weight_dir=str(tmp_path / "w"), poll=0.05)
        assert sync.catch_up() == 1
        assert sync.stats()["corrupt_skipped"] >= 1
        assert srv._engine.version_state()["version"] == 1
    finally:
        if sync is not None:
            sync.stop()
        srv.stop()


def test_sync_refuses_a_parameter_server_source(model):
    srv = ModelServer(_engine(model), model_name="m")
    try:
        with pytest.raises(ValueError, match="A11"):
            WeightSync(srv, kv_addrs=["127.0.0.1:1"])
    finally:
        srv.stop()


@pytest.mark.parametrize("writer", ["mxtpu", "port"])
def test_snapshot_directory_crosses_packages(model, tmp_path, writer):
    """A directory written by one package's WeightPublisher is followed
    by the other package's WeightSync: the same versions, the digest the
    writer recorded equal to the reader's own, the served weights those
    bits."""
    d = str(tmp_path / "w")
    # both packages' publishers and subscribers write and read the
    # fallback format (use_orbax=False, mxtpu's rollout.py:80-82)
    pub = mxtpu.serving.WeightPublisher(d) if writer == "mxtpu" \
        else WeightPublisher(d)
    outs = [pub.publish(_params_v(model, s)) for s in (2.0, 3.0)]
    assert [o["version"] for o in outs] == [1, 2]
    for o, s in zip(outs, (2.0, 3.0)):
        assert o["digest"] == weight_digest(_params_v(model, s))
    if writer == "mxtpu":
        srv = ModelServer(_engine(model), model_name="m")
        sync = WeightSync(srv, weight_dir=d)
        assert sync.catch_up() == 2
        assert srv._engine.store_digest(2) == outs[1]["digest"]
        got = srv._engine.current_params(2)
        want = _params_v(model, 3.0)
        assert srv.stats()["counters"]["swaps"] == 1
    else:
        jeng = mxtpu.serving.InferenceEngine(
            mlp(mxtpu), model[1], {}, {"data": (IN_DIM,)}, buckets=(4,),
            warm=False)
        srv = mxtpu.serving.ModelServer(jeng, model_name="m")
        sync = mxtpu.serving.WeightSync(srv, weight_dir=d)
        assert sync.catch_up() == 2
        assert jeng.store_digest(2) == outs[1]["digest"]
        got = jeng.current_params(2)
        want = _params_v(model, 3.0)
    try:
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v)
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# rollout: canary, verdicts, rollback, hot swap, several models
# ---------------------------------------------------------------------------

def _fleet(model, tmp_path, n=2):
    servers = []
    for _ in range(n):
        peers = [s.address for s in servers]
        srv = ModelServer(_engine(model), model_name="m",
                          batch_deadline_ms_=5, replicas=peers or None,
                          weight_dir=str(tmp_path / "w")).start()
        for s in servers:
            s._replicas.append(srv.address)
        servers.append(srv)
    return servers


def test_canary_split_is_deterministic_and_promotes(model, tmp_path):
    srv = _fleet(model, tmp_path, n=1)[0]
    ctl = RolloutController([srv.address], model="m")
    try:
        cli = ServingClient(addrs=[srv.address], budget_ms=5000)
        pub = WeightPublisher(str(tmp_path / "w"))
        pub.publish(_params_v(model, 2.0))
        sync = WeightSync(srv, weight_dir=str(tmp_path / "w"))
        sync.catch_up()
        ctl.canary(0, 0.5)
        rng = np.random.RandomState(0)
        seen = set()
        for _ in range(40):
            _outs, info = cli.predict2(rng.rand(1, IN_DIM).astype("f"))
            seen.add(info["version"])
            want = 0 if zlib.crc32(info["rid"].encode()) % 10000 < 5000 \
                else 1
            assert info["version"] == want
        assert seen == {0, 1}
        state = srv.stats()["models"]["m"]
        assert set(state["by_version"]) == {0, 1}
        verdict = ctl.verdict(0, stable_version=1)
        assert verdict["verdict"] == "promote"
        assert verdict["evidence"]["canary"]["responses"] >= 5
        ctl.promote(0)
        _, info = cli.predict2(np.ones((1, IN_DIM), "f"))
        assert info["version"] == 0
        ctl.abort()
        sync.stop()
    finally:
        ctl.close()
        srv.stop()


def test_verdict_waits_then_aborts_on_errors(model, tmp_path):
    srv = _fleet(model, tmp_path, n=1)[0]
    ctl = RolloutController([srv.address], model="m")
    try:
        srv.swap_weights(_params_v(model, 2.0), version=1)
        assert ctl.verdict(1)["verdict"] == "wait"
        entry = srv._entry_for("m")
        for _ in range(10):
            entry.note(1, "errors")
            entry.note(0, "responses", lat_ms=1.0)
        for _ in range(6):
            entry.note(1, "responses", lat_ms=1.0)
        out = ctl.verdict(1, stable_version=0)
        assert out["verdict"] == "abort"
        assert out["evidence"]["canary"]["err_ratio"] > 0.5
    finally:
        ctl.close()
        srv.stop()


def test_rollback_is_bit_exact_from_snapshot(model, tmp_path):
    srv = _fleet(model, tmp_path, n=1)[0]
    ctl = RolloutController([srv.address], model="m")
    sync = None
    try:
        cli = ServingClient(addrs=[srv.address], budget_ms=5000)
        pub = WeightPublisher(str(tmp_path / "w"))
        pub.publish(_params_v(model, 2.0), pin=True)      # v1
        sync = WeightSync(srv, weight_dir=str(tmp_path / "w"), poll=0.05)
        sync.catch_up()
        x = np.ones((2, IN_DIM), "f")
        want, info = cli.predict2(x)
        assert info["version"] == 1
        for scale in (3.0, 4.0, 5.0, 6.0):                # v2..v5
            pub.publish(_params_v(model, scale))
            sync.catch_up()
        state = srv._engine.version_state()
        assert state["version"] == 5 and 1 not in state["versions"]
        base_compiles = srv._engine.cache.compiles
        out = ctl.rollback(1)[srv.address]
        assert out["weights"]["pinned"] == 1
        got, info = cli.predict2(x)
        assert info["version"] == 1
        np.testing.assert_array_equal(got[0], want[0])
        assert srv._engine.cache.compiles == base_compiles
        pub.publish(_params_v(model, 7.0))
        sync.catch_up()
        _, info = cli.predict2(x)
        assert info["version"] == 1
        ctl.unpin()
        pub.publish(_params_v(model, 8.0))
        sync.catch_up()
        _, info = cli.predict2(x)
        assert info["version"] == 7
    finally:
        if sync is not None:
            sync.stop()
        ctl.close()
        srv.stop()


def test_rollback_refuses_digest_mismatch(model, tmp_path):
    srv = _fleet(model, tmp_path, n=1)[0]
    ctl = RolloutController([srv.address], model="m")
    try:
        pub = WeightPublisher(str(tmp_path / "w"))
        pub.publish(_params_v(model, 2.0), pin=True)
        for scale in (3.0, 4.0, 5.0, 6.0):
            pub.publish(_params_v(model, scale))
            srv.swap_weights(_params_v(model, scale))
        # v1's bytes rewritten with consistent CRC tags: only the digest
        # stands between the rollback and wrong bits
        step = os.path.join(str(tmp_path / "w"), "step_1")
        wrong = _params_v(model, 99.0)
        with open(os.path.join(step, "params.npz"), "wb") as f:
            np.savez(f, **wrong)
        with open(os.path.join(step, "integrity.json")) as f:
            tags = json.load(f)
        tags["params"] = {k: zlib.crc32(np.ascontiguousarray(v).tobytes())
                          for k, v in wrong.items()}
        with open(os.path.join(step, "integrity.json"), "w") as f:
            json.dump(tags, f)
        with pytest.raises(RuntimeError, match="digest"):
            ctl.rollback(1)
    finally:
        ctl.close()
        srv.stop()


def test_hot_swap_is_zero_downtime_under_load(model, tmp_path):
    s1, s2 = _fleet(model, tmp_path, n=2)
    ctl = RolloutController([s1.address, s2.address], model="m")
    try:
        cli = ServingClient(addrs=[s1.address], budget_ms=8000)
        cli.hello()
        compiles0 = (s1._engine.cache.compiles, s2._engine.cache.compiles)
        stop = threading.Event()
        outs, errs = [], []
        lock = threading.Lock()

        def pound(seed):
            rng = np.random.RandomState(seed)
            c = ServingClient(addrs=[s1.address, s2.address],
                              budget_ms=8000)
            while not stop.is_set():
                try:
                    _, info = c.predict2(rng.rand(1, IN_DIM).astype("f"))
                    with lock:
                        outs.append(info["version"])
                except Exception as e:
                    with lock:
                        errs.append(e)
            c.close()

        ts = [threading.Thread(target=pound, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        ctl.hot_swap(_params_v(model, 2.0), 1)
        stop.set()
        for t in ts:
            t.join(timeout=60)
        assert not errs, errs[:3]
        assert len(outs) > 0
        for s in (s1, s2):
            assert s._engine.version_state()["version"] == 1
            assert not s._draining
        _, info = cli.predict2(np.ones((1, IN_DIM), "f"))
        assert info["version"] == 1
        assert (s1._engine.cache.compiles,
                s2._engine.cache.compiles) == compiles0
    finally:
        ctl.close()
        s2.stop()
        s1.stop()


def test_multi_model_menus_route_by_id(model, tmp_path):
    net, arg_params, aux_params = model
    srv = ModelServer(_engine(model), model_name="m").start()
    try:
        eng2 = InferenceEngine(net, {n: -v for n, v in arg_params.items()},
                               aux_params, {"data": (IN_DIM,)},
                               buckets=(4,), warm=False, ctx=mt.cpu())
        srv.add_model("m2", eng2)
        cli = ServingClient(addrs=[srv.address], budget_ms=5000)
        info = cli.hello()
        assert sorted(info["models"]) == ["m", "m2"]
        assert cli.models["m2"]["weights"]["version"] == 0
        x = np.ones((1, IN_DIM), "f")
        out_default = cli.predict(x)[0]
        out_m2 = cli.predict(x, model="m2")[0]
        assert not np.array_equal(out_default, out_m2)
        srv.swap_weights(_params_v(model, 2.0), model="m2")
        _, info2 = cli.predict2(x, model="m2")
        assert info2["version"] == 1
        _, info1 = cli.predict2(x)
        assert info1["version"] == 0
        with pytest.raises(RuntimeError, match="unknown model"):
            cli.predict(x, model="nope")
        assert set(srv.stats()["models"]) == {"m", "m2"}
    finally:
        srv.stop()


def test_streaming_under_load_exactly_once_zero_retraces(model, tmp_path):
    """Concurrent clients send requests while versions swap: every
    request is answered once, by one version, with no program built."""
    srv = _fleet(model, tmp_path, n=1)[0]
    try:
        srv._engine.warm()
        base = srv._engine.cache.compiles
        stop = threading.Event()
        answered, errs = [], []
        lock = threading.Lock()

        def pound(seed):
            rng = np.random.RandomState(seed)
            c = ServingClient(addrs=[srv.address], budget_ms=8000)
            n = 0
            while not stop.is_set() and n < 200:
                try:
                    _, info = c.predict2(rng.rand(1, IN_DIM).astype("f"))
                    with lock:
                        answered.append(info["version"])
                except Exception as e:
                    with lock:
                        errs.append(e)
                n += 1
            c.close()

        ts = [threading.Thread(target=pound, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for v in range(1, 8):
            srv.swap_weights(_params_v(model, 1.0 + 0.5 * v), version=v)
        stop.set()
        for t in ts:
            t.join(timeout=60)
        assert not errs, errs[:3]
        assert len(answered) > 0
        assert set(answered) <= set(range(0, 8))
        assert srv._engine.cache.compiles == base
        assert srv.stats()["counters"]["swaps"] == 7
    finally:
        srv.stop()


def test_swap_fault_points_lose_one_record(model, tmp_path):
    """``serve.swap`` drop loses that version record (the sync delivers
    it at its next round); ``publish.snapshot`` drop writes nothing."""
    srv = ModelServer(_engine(model), model_name="m")
    try:
        pub = WeightPublisher(str(tmp_path / "w"))
        with fault.inject("kind=drop,point=publish.snapshot,nth=1"):
            assert pub.publish(_params_v(model, 2.0)) is None
        assert pub.versions() == [] and pub.stats()["dropped"] == 1
        pub.publish(_params_v(model, 2.0))
        sync = WeightSync(srv, weight_dir=str(tmp_path / "w"))
        with fault.inject("kind=drop,point=serve.swap,nth=1"):
            assert sync.poll_once() is None
            assert sync.stats()["dropped"] == 1
            assert sync.poll_once() == 1
        assert srv.stats()["counters"]["swaps_dropped"] == 1
    finally:
        srv.stop()
