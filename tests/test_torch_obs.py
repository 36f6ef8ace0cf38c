"""Observability and fault schedules of the PyTorch port on the CPU: the
registry, trace and fault-spec cases of ``tests/test_observability.py``
and ``tests/test_fault_tolerance.py`` on ``mxtpu_torch.obs`` /
``mxtpu_torch.fault``, with the histogram buckets, quantiles and
snapshots held to ``mxtpu``'s for the same observations, and a traced
predict over real framing (client, admission and batch spans in one
trace, merged from the per-process dump)."""
import json
import os

import numpy as np
import pytest

import mxtpu.fault
import mxtpu.obs
import mxtpu_torch as mt
from mxtpu_torch import fault, obs
from mxtpu_torch import kvstore_async as ka
from mxtpu_torch import profiler as prof
from mxtpu_torch.obs.metrics import DEFAULT_BUCKETS, Registry
from torch_threads import torch_threads_shared  # noqa: F401


@pytest.fixture(autouse=True)
def _no_sampling(monkeypatch):
    monkeypatch.delenv("MXTPU_TRACE_SAMPLE", raising=False)
    monkeypatch.delenv("MXTPU_TRACE_DIR", raising=False)
    fault.uninstall()
    yield
    fault.uninstall()


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_counter_gauge_histogram():
    r = Registry()
    c = r.counter("t.reqs", "x", ("inst",)).labels("a")
    c.inc()
    c.inc(4)
    assert c.value == 5
    g = r.gauge("t.depth").default()
    g.set(7)
    g.dec(2)
    g.set_max(3)
    g.set_max(11)
    assert g.value == 11
    h = r.histogram("t.lat_ms").default()
    for v in (0.2, 1.0, 9.0, 90.0):
        h.observe(v)
    assert h.count == 4 and h.sum == pytest.approx(100.2)
    assert 0.2 <= h.percentile(0.5) <= 9.0
    assert h.percentile(0.99) >= h.percentile(0.5)
    snap = r.snapshot()
    assert snap["metrics"]["t.reqs"]["series"]["a"] == 5
    hs = snap["metrics"]["t.lat_ms"]["series"][""]
    assert hs["count"] == 4 and hs["p99"] >= hs["p50"]
    assert snap["series"] == 3


@pytest.mark.parametrize("buckets", [None, (1.0, 2.0, 4.0)])
def test_histogram_and_snapshot_equal_mxtpu(buckets):
    """The same observations give mxtpu's bucket counts, sum, p50 / p99
    and snapshot families, with the default log-spaced buckets and with
    explicit ones."""
    assert DEFAULT_BUCKETS == mxtpu.obs.metrics.DEFAULT_BUCKETS
    values = np.random.RandomState(0).lognormal(0.5, 2.0, 500)
    values = np.concatenate([values, [0.0, 0.05, 10000.0, 1e6]])
    snaps = []
    for reg in (Registry(), mxtpu.obs.metrics.Registry()):
        h = reg.histogram("t.ms", "x", ("m",), buckets=buckets)
        reg.counter("t.n", "y").default().inc(len(values))
        s = h.labels("lm")
        for v in values:
            s.observe(float(v))
        for q in (0.1, 0.5, 0.9, 0.99):
            assert s.percentile(q) is not None
        snaps.append(reg.snapshot())
    for key in ("series", "overflowed_series", "max_series"):
        assert snaps[0][key] == snaps[1][key]
    assert snaps[0]["metrics"] == snaps[1]["metrics"]
    assert snaps[0]["views"] == snaps[1]["views"] == {}


def test_registry_idempotent_and_kind_clash():
    r = Registry()
    a = r.counter("t.x", "one")
    b = r.counter("t.x", "two")
    assert a is b
    with pytest.raises(ValueError):
        r.gauge("t.x")


def test_registry_cardinality_bound(monkeypatch):
    monkeypatch.setenv("MXTPU_METRICS_MAX_SERIES", "3")
    r = Registry()
    m = r.counter("t.many", labels=("k",))
    kept = [m.labels(str(i)) for i in range(3)]
    spilled = m.labels("overflow-a")
    assert spilled.detached
    spilled.inc(9)
    assert spilled.value == 9
    snap = r.snapshot()
    fam = snap["metrics"]["t.many"]
    assert len(fam["series"]) == 3 and fam["overflowed"] == 1
    assert snap["overflowed_series"] == 1
    kept[0].drop()
    fresh = m.labels("later")
    assert not fresh.detached
    assert m.labels("1") is kept[1]


def test_registry_views_and_snapshot_isolation():
    r = Registry()
    k1 = r.view("t.view", lambda: {"a": 1})
    k2 = r.view("t.view", lambda: {"a": 2})
    assert k1 == "t.view" and k2 != k1

    def boom():
        raise RuntimeError("dying component")
    r.view("t.bad", boom)
    snap = r.snapshot()
    assert snap["views"][k1] == {"a": 1}
    assert snap["views"][k2] == {"a": 2}
    assert "error" in snap["views"]["t.bad"]
    r.unview(k2)
    assert k2 not in r.snapshot()["views"]
    r.unview(None)


# ---------------------------------------------------------------------------
# sampling and spans
# ---------------------------------------------------------------------------

def test_sampler_deterministic(monkeypatch):
    s = obs.Sampler(rate=0.25)
    got = [s.sample() for _ in range(8)]
    assert got == [True, False, False, False, True, False, False, False]
    assert all(obs.Sampler(rate=1.0).sample() for _ in range(5))
    z = obs.Sampler(rate=0.0)
    assert not any(z.sample() for _ in range(5))
    monkeypatch.setenv("MXTPU_TRACE_SAMPLE", "1")
    env_s = obs.Sampler()
    assert env_s.sample()
    monkeypatch.setenv("MXTPU_TRACE_SAMPLE", "0")
    assert not env_s.sample()


def test_spans_record_nesting_and_flow_events():
    prof.reset()
    tok = obs.start_trace()
    with obs.span("t.outer", op="o"):
        with obs.span("t.inner"):
            pass
    obs.end_trace(tok)
    assert obs.active_ctx() is None
    evs = [e for e in prof.snapshot_events() if e.get("cat") == "trace"]
    spans = {e["name"]: e for e in evs if e["ph"] == "X"}
    outer, inner = spans["t.outer"], spans["t.inner"]
    assert outer["args"]["trace"] == inner["args"]["trace"]
    assert inner["args"]["parent"] == outer["args"]["span"]
    assert outer["args"]["op"] == "o"
    flows = [e for e in evs if e["ph"] in ("s", "f")]
    assert len(flows) == 4
    assert {f["id"] for f in flows} == {outer["args"]["trace"]}


def test_span_without_context_records_nothing():
    prof.reset()
    with obs.span("t.orphan"):
        pass
    assert [e for e in prof.snapshot_events()
            if e.get("cat") == "trace"] == []


def test_trace_rides_wire_and_merges(tmp_path, monkeypatch):
    """A traced predict over real framing: the client's span, the
    replica's admission and batch spans and the transport's rpc span
    land in one trace; the per-process dump merges into one timeline
    with the flow events."""
    from test_torch_serving_wire import IN_DIM, mlp, mlp_params
    monkeypatch.setattr(ka, "_LOCAL_ON", False)
    monkeypatch.setenv("MXTPU_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("MXTPU_TRACE_SAMPLE", "1")
    prof.reset()
    eng = mt.serving.InferenceEngine(mlp(mt), mlp_params(), {},
                                     {"data": (IN_DIM,)}, buckets=(1,),
                                     ctx=mt.cpu())
    srv = mt.serving.ModelServer(eng, model_name="t",
                                 batch_deadline_ms_=5).start()
    try:
        cli = mt.serving.ServingClient(addrs=[srv.address],
                                       budget_ms=5000)
        cli.predict(np.ones((1, IN_DIM), "f"))
        spans = [e for e in prof.snapshot_events()
                 if e.get("cat") == "trace" and e["ph"] == "X"]
        names = {e["name"] for e in spans}
        assert {"serve.client.request", "kv.client.rpc", "serve.admit",
                "serve.batch.dispatch"} <= names
        assert len({e["args"]["trace"] for e in spans}) == 1
        path = obs.dump_process_trace()
        assert path and os.path.basename(path).startswith("trace-")
        merged = obs.merge_traces(str(tmp_path),
                                  out=str(tmp_path / "merged.json"))
        with open(tmp_path / "merged.json") as f:
            assert json.load(f)["traceEvents"] == merged
        assert any(e.get("ph") == "M" for e in merged)
        assert any(e.get("ph") == "s" for e in merged)
    finally:
        srv.stop()


def test_trace_events_bounded(monkeypatch):
    import mxtpu_torch.obs.trace as trace_mod
    monkeypatch.setattr(trace_mod, "_events_max_cache", 0)
    before = trace_mod._span_drops.value
    tok = obs.start_trace()
    with obs.span("t.capped"):
        pass
    obs.end_trace(tok)
    assert trace_mod._span_drops.value == before + 1


def test_metrics_op_is_the_registry_snapshot():
    from test_torch_serving_wire import IN_DIM, mlp, mlp_params
    eng = mt.serving.InferenceEngine(mlp(mt), mlp_params(), {},
                                     {"data": (IN_DIM,)}, buckets=(1,),
                                     ctx=mt.cpu())
    srv = mt.serving.ModelServer(eng, model_name="t").start()
    try:
        cli = mt.serving.ServingClient(addrs=[srv.address])
        cli.predict(np.ones((1, IN_DIM), "f"))
        conn = cli._conn_for(srv.address)
        snap = conn.request("metrics")[1]
        assert snap["series"] >= 1 and "serving.server" in "".join(
            snap["views"])
        fam = snap["metrics"]["serve.request_ms"]
        assert fam["kind"] == "histogram" and fam["series"]["t"]["count"]
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# fault schedules
# ---------------------------------------------------------------------------

def test_fault_spec_parsing_and_validation():
    for pkg in (fault, mxtpu.fault):
        rules = pkg.parse_spec(
            "kind=sever,point=server.send,op=push,nth=3,count=2;"
            "kind=delay,point=any,delay=0.25,count=inf")
        assert len(rules) == 2
        assert (rules[0].kind, rules[0].point, rules[0].op,
                rules[0].nth, rules[0].count) == \
            ("sever", "server.send", "push", 3, 2)
        assert rules[1].delay == 0.25 and rules[1].count == float("inf")
        with pytest.raises(ValueError, match="unknown fault kind"):
            pkg.parse_spec("kind=explode")
        with pytest.raises(ValueError, match="unknown fault point"):
            pkg.parse_spec("kind=sever,point=everywhere")
        with pytest.raises(ValueError, match="kill only applies to server"):
            pkg.parse_spec("kind=kill,point=worker.send")
        with pytest.raises(ValueError, match="no kind="):
            pkg.parse_spec("point=worker.send")


@pytest.mark.parametrize("spec", [
    "kind=sever,point=worker.send,op=push,nth=2,count=2",
    "kind=drop,point=serve.request,op=predict|generate,nth=2",
    "kind=truncate,point=server.send,key=big,count=inf",
    "kind=stall,point=serve.batch,delay=0,nth=3,count=2"])
def test_injector_schedule_equals_mxtpu(spec):
    """The same spec over the same events fires at the same events, with
    the same outcome, in both packages."""
    events = [("worker.send", "push", "k0"), ("worker.send", "pull", "k1"),
              ("serve.request", "predict", "r1"),
              ("serve.request", "generate", "r2"),
              ("server.send", "predict", "big1"),
              ("serve.batch", "batch", "rows=4")] * 3
    outcomes = []
    for pkg in (fault, mxtpu.fault):
        inj = pkg.FaultInjector(spec)
        got = []
        for point, op, key in events:
            try:
                got.append(inj.fire(point, op=op, key=key))
            except pkg.FaultSever as e:
                got.append(str(e).split(" at ")[0])
        outcomes.append((got, inj.stats()))
    assert outcomes[0] == outcomes[1]


def test_env_spec_bootstrap(monkeypatch):
    monkeypatch.setenv("MXTPU_FAULT_SPEC",
                       "kind=delay,point=worker.recv,delay=0.01")
    monkeypatch.setattr(fault, "_env_loaded", False)
    monkeypatch.setattr(fault, "_injector", None)
    inj = fault.active()
    assert inj is not None and inj.rules[0].kind == "delay"


def test_kill_rule_kills_the_server_it_is_given():
    killed = []

    class Server:
        def kill(self):
            killed.append(True)

    with fault.inject("kind=kill,point=serve.batch,nth=2") as inj:
        assert fault.fire("serve.batch", op="batch", server=Server()) \
            is None
        with pytest.raises(fault.FaultSever, match="server kill"):
            fault.fire("serve.batch", op="batch", server=Server())
    assert killed == [True] and inj.stats()[0][3:] == (2, 1)
