"""Generation in the PyTorch port on the CPU: the engine's prefill, decode
and adopt programs and the continuous-batching ``GenerateScheduler``,
held to the contracts ``tests/test_serving_generate.py`` states for
``mxtpu`` (here without the server and client, which come with a later
slice) and to ``mxtpu``'s engine itself: the same greedy tokens for the
same parameters, and GEN checkpoints written by either package served by
the other.

The model is ``test_serving_generate.py``'s: one ``cached_attention``
layer over an embedding, V=17, D=8, S=16, 2 heads, weights N(0, 0.25)
from a seed. Greedy tokens are compared exactly: the two packages'
logits differ by float32 rounding alone, far below the gaps between
their largest values at these sizes.
"""
import threading
import time

import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu_torch import fault
from mxtpu_torch.serving import GenerateScheduler, InferenceEngine
from torch_threads import torch_threads_shared  # noqa: F401

V, D, S = 17, 8, 16


@pytest.fixture(autouse=True)
def _serving_knobs(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_GENERATE_SLOTS", "4")
    monkeypatch.setenv("MXTPU_SERVE_GENERATE_PREFILL_BUCKETS", "4,8,16")
    fault.uninstall()
    yield
    fault.uninstall()


def _lm_symbol(pkg, cache_len=S, alibi=False, copy_next=False):
    data = pkg.sym.Variable("data")
    pos = pkg.sym.Variable("pos", shape=(0,), dtype="int32")
    kc = pkg.sym.Variable("kc", shape=(0, cache_len, D))
    vc = pkg.sym.Variable("vc", shape=(0, cache_len, D))
    emb = pkg.sym.Embedding(data=data, input_dim=V, output_dim=D,
                            name="emb")
    q = pkg.sym.FullyConnected(data=emb, num_hidden=D, flatten=False,
                               name="q")
    k = pkg.sym.FullyConnected(data=emb, num_hidden=D, flatten=False,
                               name="k")
    v = pkg.sym.FullyConnected(data=emb, num_hidden=D, flatten=False,
                               name="v")
    att = pkg.sym.cached_attention(q, k, v, kc, vc, pos, num_heads=2,
                                   alibi=alibi, name="att")
    out = pkg.sym.FullyConnected(data=att[0], num_hidden=V,
                                 flatten=False, name="proj")
    kn, vn = att[1], att[2]
    if copy_next:               # a state that is not the op's own output
        kn, vn = kn * 1.0, vn * 1.0
    return pkg.sym.Group([out, pkg.sym.identity(kn, name="kc_next"),
                          pkg.sym.identity(vn, name="vc_next")])


def _lm_params(seed=7):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32) * 0.5  # noqa: E731
    return {"emb_weight": f(V, D),
            "q_weight": f(D, D), "q_bias": np.zeros(D, np.float32),
            "k_weight": f(D, D), "k_bias": np.zeros(D, np.float32),
            "v_weight": f(D, D), "v_bias": np.zeros(D, np.float32),
            "proj_weight": f(V, D), "proj_bias": np.zeros(V, np.float32)}


def _engine(seed=7, alibi=False, cache_len=S, copy_next=False):
    return InferenceEngine(_lm_symbol(mt, cache_len, alibi, copy_next),
                           _lm_params(seed), {}, data_shapes={"data": (1,)},
                           buckets=(1,), ctx=mt.cpu())


def _oracle(eng, prompt, n):
    """Greedy continuation by full recompute: the growing prompt
    prefilled again each step, no cache reused."""
    params, aux, _v = eng._resolve_store(None)
    cur, out = list(prompt), []
    for _ in range(n):
        first, _rows = eng.gen_prefill(np.asarray(cur, np.int32), params,
                                       aux)
        out.append(int(first[0]))
        cur.append(out[-1])
    return out


def _generate(sched, prompt, max_new, **kw):
    req = sched.submit("r", prompt, max_new, **kw)
    assert not isinstance(req, tuple), req
    verdict, info = req.wait(60)
    assert verdict == "ok", (verdict, info)
    return info["tokens"].tolist(), info


@pytest.fixture
def sched_of():
    made = []

    def make(eng, **kw):
        made.append(GenerateScheduler(eng, 64, **kw))
        return made[-1]
    yield make
    for s in made:
        s.stop()


@pytest.mark.parametrize("alibi", [False, True])
def test_prefill_chunk_equals_decode_chain(alibi):
    """Attending T tokens in one prefill call equals feeding them one at
    a time through the cache, with and without ALiBi."""
    rng = np.random.RandomState(0)
    B, T, H = 2, 6, 2
    q, k, v = (torch.tensor(rng.randn(B, T, D).astype(np.float32))
               for _ in range(3))
    zeros = torch.zeros(B, S, D)
    full, kn, _vn = mt.ops.nn.cached_attention(
        q, k, v, zeros, zeros, torch.zeros(B), num_heads=H, alibi=alibi)
    assert torch.allclose(kn[:, :T], k, atol=1e-6)
    kc = vc = zeros
    for t in range(T):
        step, kc, vc = mt.ops.nn.cached_attention(
            q[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], kc, vc,
            torch.full((B,), float(t)), num_heads=H, alibi=alibi)
        assert torch.allclose(step[:, 0], full[:, t], atol=1e-5), t


def test_engine_detects_generate_contract():
    eng = _engine()
    assert eng.is_generative
    spec = eng.generate_spec()
    assert spec["token_input"] == "data"
    assert sorted(spec["states"]) == ["kc", "vc"]
    assert spec["cache_len"] == S
    assert spec["prefill_buckets"] == [4, 8, 16]
    assert spec["slots"] == 4
    assert eng._gen["in_place"]
    # predict 1 + prefill 3 + decode + adopt
    assert eng.cache.compiles == 6
    plain = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=3,
                                  name="fc")
    eng2 = InferenceEngine(plain, {"fc_weight": np.zeros((3, 4), "f"),
                                   "fc_bias": np.zeros(3, "f")}, {},
                           {"data": (4,)}, buckets=(1,), warm=False,
                           ctx=mt.cpu())
    assert not eng2.is_generative
    assert eng2.generate_spec() is None


@pytest.mark.parametrize("alibi", [False, True])
def test_decode_matches_full_recompute_zero_retrace(alibi, sched_of):
    """The served greedy continuation (cached, slot-packed, in place)
    equals the full-recompute oracle, and a second sequence through the
    warmed menu builds nothing new."""
    eng = _engine(alibi=alibi)
    ref = _oracle(eng, [3, 1, 4], 10)
    sched = sched_of(eng)
    toks, info = _generate(sched, [3, 1, 4], 10)
    assert toks == ref
    assert info["reason"] == "len" and info["version"] == 0
    before = eng.cache.compiles
    toks2, _ = _generate(sched, [3, 1, 4], 10)
    assert toks2 == ref
    assert eng.cache.compiles == before, "steady-state decode rebuilt"


def test_decode_writes_the_lane_state_in_place():
    """A decode step writes one row a slot into the state's own caches:
    the same storage before and after, every other row untouched."""
    eng = _engine()
    params, aux, _v = eng._resolve_store(None)
    state = eng.gen_state_init(4)
    first, rows = eng.gen_prefill(np.asarray([3, 1, 4], np.int32), params,
                                  aux)
    eng.gen_adopt(state, first, 3, rows, 2)
    ptrs = [c.data_ptr() for c in state.states]
    before = [c.clone() for c in state.states]
    nxt, state2 = eng.gen_step(state, params, aux)
    assert state2 is state
    assert [c.data_ptr() for c in state.states] == ptrs
    assert state.pos.tolist() == [1, 1, 4, 1]
    for c, b in zip(state.states, before):
        changed = (c != b).any(-1)                 # (K, S)
        assert changed[2].nonzero().flatten().tolist() == [3]
        assert changed.sum(-1).le(1).all()


def test_state_copy_path_equals_in_place(sched_of):
    """A symbol whose next states are not the op's own outputs takes the
    copying path (evaluate every output, copy the states over) and
    answers as the in-place path does."""
    eng = _engine(copy_next=True)
    assert not eng._gen["in_place"]
    ref = _oracle(_engine(), [5, 2, 7], 8)
    assert _generate(sched_of(eng), [5, 2, 7], 8)[0] == ref


def test_eos_stops_early(sched_of):
    eng = _engine()
    ref = _oracle(eng, [3, 1, 4], 10)
    j = next(i for i in range(1, 10) if ref[i] not in ref[:i])
    toks, info = _generate(sched_of(eng), [3, 1, 4], 10, eos_id=ref[j])
    assert toks == ref[:j + 1]
    assert info["reason"] == "eos"


def test_generate_against_oneshot_model_is_an_error(sched_of):
    plain = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=3,
                                  name="fc")
    eng = InferenceEngine(plain, {"fc_weight": np.zeros((3, 4), "f"),
                                  "fc_bias": np.zeros(3, "f")}, {},
                          {"data": (4,)}, buckets=(1,), warm=False,
                          ctx=mt.cpu())
    verdict = sched_of(eng).submit("r", [1, 2], 4)
    assert verdict[0] == "err" and "not generative" in verdict[1]
    with pytest.raises(ValueError, match="not generative"):
        eng.gen_prefill([1, 2], (), ())


def test_continuous_batching_joins_and_leaves(sched_of):
    """7 sequences contend for 4 decode slots: every one finishes with the
    tokens it gets alone, and the queue's high-water mark shows that some
    waited."""
    eng = _engine()
    prompts = {j: [1 + (j % 5), 2, 3 + (j % 3)] for j in range(7)}
    refs = {j: _oracle(eng, p, 6) for j, p in prompts.items()}
    sched = sched_of(eng)
    reqs = {j: sched.submit("r%d" % j, p, 6) for j, p in prompts.items()}
    got = {j: r.wait(60)[1]["tokens"].tolist() for j, r in reqs.items()}
    assert got == refs
    st = sched.stats()
    assert st["sequences"] == 7 and st["finished"] == 7
    assert st["queue_hwm"] >= 1, "7 sequences on 4 slots never queued?"


def test_live_swap_never_tears_an_inflight_sequence(sched_of):
    """A swap lands while a sequence decodes: the sequence keeps answering
    from its admission version (every token v0, the tokens of the run
    without a swap) while the next admission answers from v1. A pinned
    replay of a version no longer resident is refused."""
    eng = _engine(seed=7, cache_len=32)
    sched = sched_of(eng)
    ref0, i0 = _generate(sched, [3, 1, 4], 12)
    assert i0["version"] == 0
    fault.install("kind=delay,point=serve.step,delay=0.02,nth=1,count=1000")
    vers, done = [], []

    def run():
        done.append(_generate(sched, [3, 1, 4], 12,
                              on_token=lambda i, t, v: vers.append(v)))
    th = threading.Thread(target=run)
    th.start()
    deadline = time.monotonic() + 30
    while len(vers) < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert len(vers) >= 3, "the sequence made no progress"
    assert eng.swap_weights(_lm_params(8)) == 1
    th.join(timeout=60)
    assert not th.is_alive()
    fault.uninstall()
    toks, info = done[0]
    assert toks == ref0, "in-flight sequence torn by the swap"
    assert set(vers) == {0} and info["version"] == 0
    toks1, info1 = _generate(sched, [3, 1, 4], 12)
    assert info1["version"] == 1
    assert toks1 != ref0
    assert toks1 == _oracle(eng, [3, 1, 4], 12)
    verdict = sched.submit("pin", [3, 1, 4], 4, version=99, pinned=True)
    assert verdict[0] == "err" and "no longer resident" in verdict[1]


def test_deadline_and_dropped_step(sched_of):
    """A budget spent between decode steps frees the slot with the
    ``expired`` verdict; an injected drop at serve.step fails the lane's
    sequences with an error, and the next sequence is served."""
    eng = _engine(cache_len=32)
    sched = sched_of(eng)
    fault.install("kind=delay,point=serve.step,delay=0.05,nth=1,count=100")
    req = sched.submit("slow", [3, 1, 4], 20,
                       deadline=time.monotonic() + 0.12)
    verdict, info = req.wait(60)
    assert verdict == "expired" and 0 < info["generated"] < 20
    fault.install("kind=drop,point=serve.step,nth=1,count=1")
    verdict, info = sched.submit("drop", [3, 1, 4], 5).wait(60)
    assert verdict == "err" and "dropped" in info
    fault.uninstall()
    assert _generate(sched, [3, 1, 4], 5)[0] == _oracle(eng, [3, 1, 4], 5)
    assert sched.stats()["expired"] == 1


def _mxtpu_greedy(eng, prompts, n):
    """Greedy tokens of mxtpu's engine through its own scheduler."""
    from mxtpu.serving.batcher import GenerateScheduler as JaxScheduler
    sched = JaxScheduler(eng, 64)
    try:
        reqs = [sched.submit("j%d" % i, p, n, None)
                for i, p in enumerate(prompts)]
        return [r.wait(60)[1]["tokens"].tolist() for r in reqs]
    finally:
        sched.stop()


PROMPTS = ([3, 1, 4], [9, 2, 6, 5, 3], [16, 0])


@pytest.mark.parametrize("alibi", [False, True])
def test_greedy_tokens_equal_mxtpu(alibi, sched_of):
    """The port's engine and scheduler give mxtpu's engine's greedy
    tokens for the same parameters, the sequences sharing the slots."""
    from mxtpu.serving import InferenceEngine as JaxEngine
    jeng = JaxEngine(_lm_symbol(mx, alibi=alibi), _lm_params(), {},
                     data_shapes={"data": (1,)}, buckets=(1,))
    want = _mxtpu_greedy(jeng, PROMPTS, 9)
    sched = sched_of(_engine(alibi=alibi))
    reqs = [sched.submit("p%d" % i, p, 9) for i, p in enumerate(PROMPTS)]
    assert [r.wait(60)[1]["tokens"].tolist() for r in reqs] == want


def test_gen_checkpoint_crosses_both_ways(tmp_path, sched_of):
    """A GEN checkpoint (the ``*_next`` outputs, the caches declared (0,
    S, D), pos int32) written by mxtpu serves in the port, and one
    written by the port serves in mxtpu, to the same tokens."""
    from mxtpu.serving import InferenceEngine as JaxEngine
    params = _lm_params()
    mx.model.save_checkpoint(
        str(tmp_path / "jax"), 0, _lm_symbol(mx, alibi=True),
        {k: mx.nd.array(v) for k, v in params.items()}, {})
    mt.model.save_checkpoint(
        str(tmp_path / "port"), 0, _lm_symbol(mt, alibi=True),
        {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}, {})
    port = InferenceEngine.from_checkpoint(str(tmp_path / "jax"), 0,
                                           {"data": (1,)}, buckets=(1,),
                                           ctx=mt.cpu())
    attrs = port._symbol.attr_dict()
    assert tuple(attrs["kc"]["__shape__"]) == (0, S, D)
    assert attrs["pos"]["__dtype__"] == torch.int32
    assert port.generate_spec()["states"] == ["kc", "vc"]
    jeng = JaxEngine.from_checkpoint(str(tmp_path / "port"), 0,
                                     {"data": (1,)}, buckets=(1,))
    assert jeng.is_generative
    assert tuple(jeng._symbol.attr_dict()["vc"]["__shape__"]) == (0, S, D)
    want = _mxtpu_greedy(jeng, PROMPTS[:2], 8)
    sched = sched_of(port)
    got = [_generate(sched, p, 8)[0] for p in PROMPTS[:2]]
    assert got == want
