"""Generation over the wire on the CPU: the wire cases of
``tests/test_serving_generate.py`` on the PyTorch port (streamed token
frames in order, the plain-request fallback, the generate signature at
hello, kill mid-generation replayed exactly once, a dropped token frame,
expiry between decode steps, a live swap that tears nothing), and
``generate2`` across packages: ``mxtpu``'s client against the port's
server and the port's client against ``mxtpu``'s, each giving the other
package's greedy tokens.

The model is ``test_torch_generate.py``'s one-layer ``cached_attention``
LM. The kill mid-generation is a ``fault`` rule at ``server.send`` (the
third token frame kills the replica that sends it), not a callback.
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
                                 ModelServer, ServingClient)
from test_torch_generate import S, _lm_params, _lm_symbol, _oracle
from torch_threads import torch_threads_shared  # noqa: F401


@pytest.fixture(autouse=True)
def _serving_knobs(monkeypatch):
    monkeypatch.setenv("MXTPU_PS_HEARTBEAT", "0")
    monkeypatch.setenv("MXTPU_SERVE_GENERATE_SLOTS", "4")
    monkeypatch.setenv("MXTPU_SERVE_GENERATE_PREFILL_BUCKETS", "4,8,16")
    for mod in (ka, mxtpu.kvstore_async):
        monkeypatch.setattr(mod, "_RETRIES", 1)
        monkeypatch.setattr(mod, "_BACKOFF", 0.01)
        monkeypatch.setattr(mod, "_BACKOFF_MAX", 0.05)
        monkeypatch.setattr(mod, "_RECONNECT_TIMEOUT", 0.2)
        monkeypatch.setattr(mod, "_DEAD_AFTER", 2)
    fault.uninstall()
    yield
    fault.uninstall()


def _engine(seed=7, cache_len=S):
    return InferenceEngine(_lm_symbol(mt, cache_len), _lm_params(seed), {},
                           data_shapes={"data": (1,)}, buckets=(1,),
                           ctx=mt.cpu())


def test_wire_streaming_partials_in_order(monkeypatch):
    eng = _engine()
    ref = _oracle(eng, [1, 2, 3], 6)
    srv = ModelServer(eng, port=0, model_name="lm").start()
    try:
        monkeypatch.setattr(ka, "_LOCAL_ON", False)
        cli = ServingClient(addrs=[srv.address])
        seen = []
        toks, info = cli.generate2(
            [1, 2, 3], max_new=6, model="lm",
            on_token=lambda i, t, v: seen.append((i, t)))
        assert toks == ref
        assert seen == list(enumerate(ref)), seen
        results = {}

        def run(j):
            results[j] = cli.generate2([1 + (j % 5), 2, 3], max_new=5,
                                       model="lm")[0]
        ths = [threading.Thread(target=run, args=(j,)) for j in range(8)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        assert len(results) == 8
        assert all(len(v) == 5 for v in results.values()), results
    finally:
        srv.stop()


def test_plain_request_fallback_blocks_for_the_full_answer():
    srv = ModelServer(_engine(), port=0, model_name="lm").start()
    conn = None
    try:
        conn = ka._ServerConn(srv.address)
        rep = conn.request("generate", "manual:1",
                           np.asarray([1, 2, 3], np.int32),
                           {"max_new": 4, "model": "lm"})
        assert rep[0] == "ok" and rep[1]["n"] == 4, rep
        assert len(list(rep[1]["tokens"])) == 4
    finally:
        if conn is not None:
            conn.close()
        srv.stop()


def test_hello_advertises_generate_signature():
    srv = ModelServer(_engine(), port=0, model_name="lm").start()
    try:
        cli = ServingClient(addrs=[srv.address])
        cli.hello()
        sig = cli.models["lm"]["signature"]
        assert "generate" in sig
        assert sig["generate"]["cache_len"] == S
    finally:
        srv.stop()


def test_kill_mid_generation_replays_exactly_once(monkeypatch):
    """A ``server.send`` rule kills the replica sending the third token
    frame: the client replays on the peer with the pinned version, the
    indices already delivered dropped, so the stream it shows is each
    index once, in order, on one version."""
    srv0 = ModelServer(_engine(), port=0, model_name="lm").start()
    srv1 = ModelServer(_engine(), port=0, model_name="lm").start()
    try:
        ref, _ = ServingClient(addrs=[srv1.address]).generate2(
            [3, 1, 4], max_new=10, model="lm")
        monkeypatch.setattr(ka, "_LOCAL_ON", False)
        cli = ServingClient(addrs=[srv0.address, srv1.address])
        seen = []
        with fault.inject("kind=kill,point=server.send,op=generate,"
                          "nth=3") as inj:
            toks, info = cli.generate2(
                [3, 1, 4], max_new=10, model="lm",
                on_token=lambda i, t, v: seen.append((i, t, v)))
        assert inj.stats()[0][4] == 1, "the kill never fired"
        assert srv0._tcp.dying and not srv1._tcp.dying
        assert toks == ref, (toks, ref)
        assert [i for i, _, _ in seen] == list(range(10)), seen
        assert [t for _, t, _ in seen] == ref
        assert all(v == info["version"] for _, _, v in seen)
        assert cli.stats()["failovers"] >= 1
        assert srv1.stats()["counters"]["responses"] == 2
    finally:
        srv1.stop()
        srv0.stop()


def test_dropped_token_frame_never_double_emits():
    eng = _engine()
    ref = _oracle(eng, [3, 1, 4], 10)
    srv = ModelServer(eng, port=0, model_name="lm").start()
    fault.install("kind=drop,point=server.send,op=generate,nth=3,count=1")
    try:
        cli = ServingClient(addrs=[srv.address])
        seen = []
        toks, _ = cli.generate2([3, 1, 4], max_new=10, model="lm",
                                on_token=lambda i, t, v: seen.append(i))
        assert toks == ref
        assert seen == list(range(10)), seen
    finally:
        fault.uninstall()
        srv.stop()


def test_mid_generation_expiry_returns_expired_verdict():
    srv = ModelServer(_engine(), port=0, model_name="lm").start()
    fault.install("kind=delay,point=serve.step,delay=0.25,nth=2,count=50")
    try:
        cli = ServingClient(addrs=[srv.address])
        with pytest.raises(DeadlineExceeded, match="expired"):
            cli.generate2([3, 1, 4], max_new=200, budget_ms=400,
                          model="lm")
        st = srv.stats()["models"]["lm"]["scheduler"]
        assert st["expired"] >= 1
    finally:
        fault.uninstall()
        srv.stop()


def test_live_swap_never_tears_an_inflight_sequence():
    """A swap lands while a sequence decodes: every token frame of it is
    v0 and its tokens are the no-swap run's, the next admission answers
    from v1, no program is built, and a pinned replay of a version no
    longer resident is refused."""
    eng = _engine(seed=7, cache_len=32)
    srv = ModelServer(eng, port=0, model_name="lm").start()
    conn = None
    try:
        cli = ServingClient(addrs=[srv.address])
        ref0, i0 = cli.generate2([3, 1, 4], max_new=12, model="lm")
        assert i0["version"] == 0
        compiles = eng.stats()["compiles"]
        fault.install(
            "kind=delay,point=serve.step,delay=0.05,nth=1,count=1000")
        vers, done = [], []
        started = threading.Event()

        def on_tok(i, t, v):
            vers.append(v)
            if i == 2:
                started.set()

        def run():
            done.append(cli.generate2([3, 1, 4], max_new=12, model="lm",
                                      on_token=on_tok))
        th = threading.Thread(target=run)
        th.start()
        assert started.wait(30), "the sequence made no progress"
        assert srv.swap_weights(_lm_params(8), {}, version=1) == 1
        th.join(timeout=60)
        fault.uninstall()
        toks, info = done[0]
        assert toks == ref0, "in-flight sequence torn by swap"
        assert set(vers) == {0} and info["version"] == 0
        toks1, info1 = cli.generate2([3, 1, 4], max_new=12, model="lm")
        assert info1["version"] == 1
        assert toks1 != ref0
        assert eng.stats()["compiles"] == compiles, "a swap built programs"
        conn = ka._ServerConn(srv.address)
        with pytest.raises(RuntimeError, match="no longer resident"):
            conn.request("generate", "pin:1",
                         np.asarray([3, 1, 4], np.int32),
                         {"max_new": 4, "model": "lm", "version": 99})
    finally:
        fault.uninstall()
        if conn is not None:
            conn.close()
        srv.stop()


# ---------------------------------------------------------------------------
# generate2 across packages, over TCP
# ---------------------------------------------------------------------------

PROMPTS = ([3, 1, 4], [9, 2, 6, 5, 3], [16, 0])


@pytest.mark.parametrize("direction", ["mxtpu_client_port_server",
                                       "port_client_mxtpu_server"])
def test_generate2_tokens_equal_across_packages(direction, monkeypatch):
    monkeypatch.setattr(ka, "_LOCAL_ON", False)
    monkeypatch.setattr(mxtpu.kvstore_async, "_LOCAL_ON", False)
    port_eng = _engine()
    jax_eng = mxtpu.serving.InferenceEngine(
        _lm_symbol(mxtpu), _lm_params(), {}, data_shapes={"data": (1,)},
        buckets=(1,))
    if direction == "mxtpu_client_port_server":
        srv = ModelServer(port_eng, port=0, model_name="lm").start()
        cli = mxtpu.serving.ServingClient(addrs=[srv.address])
        want = [_oracle(_engine(), p, 7) for p in PROMPTS]
    else:
        srv = mxtpu.serving.ModelServer(jax_eng, port=0,
                                        model_name="lm").start()
        cli = ServingClient(addrs=[srv.address])
        want = [_oracle(port_eng, p, 7) for p in PROMPTS]
    try:
        for p, w in zip(PROMPTS, want):
            seen = []
            toks, info = cli.generate2(
                p, max_new=7, model="lm",
                on_token=lambda i, t, v: seen.append((i, t, v)))
            assert toks == w
            assert seen == [(i, t, 0) for i, t in enumerate(w)]
            assert info["version"] == 0 and info["reason"] == "len"
    finally:
        cli.close()
        srv.stop()
