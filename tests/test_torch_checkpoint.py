"""The port's CheckpointManager (mxtpu_torch/checkpoint.py) against mxtpu's
(mxtpu/checkpoint.py) on the CPU.

Every case of tests/test_checkpoint.py on the port (the fallback writer:
the port has no orbax, and ``use_orbax=True`` raises), the kill -9 in the
publish window in a child that imports neither JAX nor mxtpu, and steps
crossing both ways: a step mxtpu wrote (``use_orbax=False``) restores in
the port with bitwise-equal arrays, the same ``weight_digest`` and its
Gluon trainer's states; a step the port wrote restores in mxtpu; a torn
or CRC-broken step either package wrote is caught by the other. A pickled
optimizer from mxtpu loads in a child process that ends with neither JAX
nor mxtpu imported.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.checkpoint import CheckpointManager as MxCheckpointManager
from mxtpu_torch.checkpoint import (CheckpointCorrupt, CheckpointManager,
                                    PickleCrossingError, weight_digest)
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def own_names():
    """Each case names its blocks and symbols in scopes of its own and
    leaves both packages' name counters as it found them: later files
    build the same nets in both packages and compare the names."""
    import mxtpu.gluon.block as mx_block
    import mxtpu_torch.gluon.block as mt_block
    saved = [(d, dict(d)) for d in (mx_block._NAME_COUNTERS,
                                    mt_block._NAME_COUNTERS)]
    with mx.name.NameManager(), mt.name.NameManager():
        yield
    for counters, old in saved:
        counters.clear()
        counters.update(old)


@pytest.fixture(autouse=True)
def on_cpu():
    with mt.cpu():
        yield


def _net_and_trainer(pkg=mt, seed=0, optimizer="adam"):
    """A Dense(3) layer, its Trainer, one step taken; as a fresh process
    names it (the name counter reset)."""
    import importlib
    importlib.import_module(pkg.__name__ + ".gluon.block")._NAME_COUNTERS \
        .clear()
    pkg.random.seed(seed)
    net = pkg.gluon.nn.Dense(3, in_units=4)
    kw = {"ctx": pkg.cpu()} if pkg is mt else {}
    net.initialize(pkg.init.Xavier(), **kw)
    trainer = pkg.gluon.Trainer(
        net.collect_params(), optimizer,
        {"learning_rate": 0.1, **({"momentum": 0.9}
                                  if optimizer == "sgd" else {})})
    x = pkg.nd.array(np.random.RandomState(seed).rand(2, 4)
                     .astype(np.float32), **kw)
    with pkg.autograd.record():
        loss = (net(x) ** 2).sum()
    loss.backward()
    trainer.step(2)
    return net, trainer, x


def _values(net):
    return {k: v.data().asnumpy() for k, v in net.collect_params().items()}


def _states(trainer):
    """The updater's states as {slot: [numpy]}."""
    out = {}
    for k, st in trainer._updaters[0].states.items():
        leaves = st if isinstance(st, (tuple, list)) else (st,)
        out[k] = [np.asarray(leaf.asnumpy()) for leaf in leaves]
    return out


# -- tests/test_checkpoint.py's cases on the port -----------------------------

@pytest.mark.parametrize("use_orbax", [False])
def test_save_restore_roundtrip(tmp_path, use_orbax):
    net, trainer, x = _net_and_trainer()
    before = net(x).asnumpy()
    ckpt = CheckpointManager(str(tmp_path / "f"), use_orbax=use_orbax)
    ckpt.save(7, net.collect_params(), trainer=trainer,
              metadata={"epoch": 7, "note": "hi"})
    ckpt.wait_until_finished()
    assert ckpt.latest_step() == 7
    net2, trainer2, _ = _net_and_trainer(seed=5)
    tree = ckpt.restore(None, net2.collect_params(), trainer=trainer2)
    np.testing.assert_array_equal(net2(x).asnumpy(), before)
    assert tree["metadata"]["epoch"] == 7
    for k, v in _states(trainer).items():
        for a, b in zip(v, _states(trainer2)[k]):
            np.testing.assert_array_equal(a, b)
    ckpt.close()


def test_orbax_refused(tmp_path):
    """mxtpu picks orbax when it imports; the port has no orbax backend."""
    with pytest.raises(ValueError, match="orbax"):
        CheckpointManager(str(tmp_path / "o"), use_orbax=True)


@pytest.mark.parametrize("use_orbax", [False, None])
def test_retention_and_latest(tmp_path, use_orbax):
    net, trainer, _ = _net_and_trainer()
    ckpt = CheckpointManager(str(tmp_path / "r"), max_to_keep=2,
                             async_save=False, use_orbax=use_orbax)
    for step in (1, 2, 3, 4):
        ckpt.save(step, net.collect_params())
    ckpt.wait_until_finished()
    assert ckpt.all_steps() == [3, 4]
    ckpt.close()


def test_restore_empty_returns_none(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "e"))
    assert ckpt.restore() is None
    assert ckpt.latest_step() is None


def test_crash_safe_fallback(tmp_path):
    net, trainer, _ = _net_and_trainer()
    ckpt = CheckpointManager(str(tmp_path / "c"), async_save=False)
    ckpt.save(1, net.collect_params())
    os.makedirs(str(tmp_path / "c" / "step_9.tmp"))
    assert ckpt.all_steps() == [1]
    ckpt.save(2, net.collect_params())
    assert ckpt.latest_step() == 2


def test_restore_missing_explicit_step(tmp_path):
    net, trainer, _ = _net_and_trainer()
    ckpt = CheckpointManager(str(tmp_path / "m"), async_save=False)
    ckpt.save(1, net.collect_params())
    assert ckpt.restore(3) is None


@pytest.mark.parametrize("crash_point", ["during_write", "before_publish"])
def test_crash_mid_save_never_corrupts_latest(tmp_path, monkeypatch,
                                              crash_point):
    """The writer thread dies mid-save: the previous step stays the intact
    latest, the failure is raised at wait_until_finished, and the next
    save publishes over the debris."""
    import mxtpu_torch.checkpoint as ckpt_mod
    net, trainer, x = _net_and_trainer()
    before = net(x).asnumpy()
    ckpt = CheckpointManager(str(tmp_path / "k"))
    ckpt.save(1, net.collect_params())
    ckpt.wait_until_finished()
    if crash_point == "during_write":
        real = ckpt_mod._np.savez

        def dying(*a, **kw):
            real(*a, **kw)
            raise SystemExit("writer thread killed mid-save")
        monkeypatch.setattr(ckpt_mod._np, "savez", dying)
    else:
        def dying_replace(src, dst):
            raise SystemExit("writer thread killed before publish")
        monkeypatch.setattr(ckpt_mod.os, "replace", dying_replace)
    ckpt.save(2, net.collect_params())
    with pytest.raises(RuntimeError, match="latest on-disk step is stale"):
        ckpt.wait_until_finished()
    monkeypatch.undo()
    assert ckpt.latest_step() == 1 and ckpt.all_steps() == [1]
    net2, _, _ = _net_and_trainer(seed=9)
    ckpt.restore(None, net2.collect_params())
    np.testing.assert_array_equal(net2(x).asnumpy(), before)
    ckpt.save(2, net.collect_params())
    ckpt.wait_until_finished()
    assert ckpt.latest_step() == 2


def test_publish_fsyncs_blobs_and_dirs_before_rename(tmp_path,
                                                     monkeypatch):
    """Every blob and the manifest fsynced, then the tmp directory, before
    the atomic rename; the parent directory after it."""
    import mxtpu_torch.checkpoint as ckpt_mod
    events = []
    real_file = CheckpointManager._fsync_file
    real_dir = CheckpointManager._fsync_dir
    real_replace = ckpt_mod.os.replace
    monkeypatch.setattr(
        CheckpointManager, "_fsync_file",
        staticmethod(lambda f: (events.append(("file", f.name)),
                                real_file(f))[1]))
    monkeypatch.setattr(
        CheckpointManager, "_fsync_dir",
        staticmethod(lambda p: (events.append(("dir", p)),
                                real_dir(p))[1]))
    monkeypatch.setattr(
        ckpt_mod.os, "replace",
        lambda src, dst: (events.append(("replace", src)),
                          real_replace(src, dst))[1])
    ckpt = CheckpointManager(str(tmp_path / "f"), async_save=False)
    ckpt.save(1, {"w": np.arange(8, dtype="f")}, metadata={"step": 1},
              extras={"blob": np.ones(3, "f")})
    kinds = [k for k, _ in events]
    assert kinds.index("replace") > kinds.index("dir")
    assert kinds[-1] == "dir"
    file_syncs = {e[1].rsplit("/", 1)[-1] for e in events
                  if e[0] == "file" and kinds.index("replace")
                  > events.index(e)}
    assert {"params.npz", "metadata.npz", "extras.npz",
            "integrity.json"} <= file_syncs, file_syncs
    assert ckpt.all_steps() == [1]


@pytest.mark.parametrize("kill_point", ["between_fsync_and_rename",
                                        "mid_blob_write"])
def test_kill9_in_publish_window_never_corrupts(tmp_path, kill_point):
    """A real SIGKILL between the last fsync and the rename, or mid-blob,
    in a child that imports the port alone (it must end without JAX or
    mxtpu loaded): step 1 stays the intact latest, every published step
    passes its integrity check, and the next save recovers."""
    cdir = str(tmp_path / "k9")
    child = r"""
import os, sys, numpy as np
sys.path.insert(0, %(root)r)
import mxtpu_torch.checkpoint as cm
ckpt = cm.CheckpointManager(%(cdir)r, async_save=False)
ckpt.save(1, {"w": np.arange(8, dtype="f")}, metadata={"s": 1})
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "mxtpu"))
print("STEP1", leaked, flush=True)
import signal
if %(kill_point)r == "between_fsync_and_rename":
    cm.os.replace = lambda s, d: os.kill(os.getpid(), signal.SIGKILL)
else:
    real = cm._np.savez
    def dying(f, **arrs):
        real(f, **arrs)
        os.kill(os.getpid(), signal.SIGKILL)
    cm._np.savez = dying
ckpt.save(2, {"w": np.ones(8, "f") * 2}, metadata={"s": 2})
print("UNREACHABLE", flush=True)
""" % {"root": ROOT, "cdir": cdir, "kill_point": kill_point}
    proc = subprocess.run([sys.executable, "-c", child],
                          env=dict(os.environ), capture_output=True,
                          text=True, timeout=120)
    assert "STEP1 []" in proc.stdout, proc.stdout + proc.stderr
    assert "UNREACHABLE" not in proc.stdout
    assert proc.returncode == -9
    ckpt = CheckpointManager(cdir, async_save=False)
    assert ckpt.all_steps() == [1]
    tree = ckpt.restore(None)
    np.testing.assert_array_equal(tree["params"]["w"],
                                  np.arange(8, dtype="f"))
    for s in ckpt.all_steps():
        ckpt._fallback_restore(s)
    ckpt.save(2, {"w": np.ones(8, "f") * 2})
    assert ckpt.latest_step() == 2


def test_async_write_failure_surfaces(tmp_path):
    net, trainer, _ = _net_and_trainer()
    ckpt = CheckpointManager(str(tmp_path / "good"))
    blocker = tmp_path / "blocker"
    blocker.write_text("x")
    ckpt.directory = str(blocker)
    ckpt.save(1, net.collect_params())
    with pytest.raises(RuntimeError):
        ckpt.wait_until_finished()


def test_truncated_newest_falls_back_to_previous(tmp_path):
    net, trainer, x = _net_and_trainer()
    before = net(x).asnumpy()
    ckpt = CheckpointManager(str(tmp_path / "t"), async_save=False)
    ckpt.save(1, net.collect_params())
    trainer.step(2)
    ckpt.save(2, net.collect_params())
    p2 = os.path.join(str(tmp_path / "t"), "step_2", "params.npz")
    with open(p2, "r+b") as f:
        f.truncate(os.path.getsize(p2) // 2)
    net2, _, _ = _net_and_trainer(seed=9)
    assert ckpt.restore(None, net2.collect_params()) is not None
    np.testing.assert_array_equal(net2(x).asnumpy(), before)


def test_crc_mismatch_detected_and_skipped(tmp_path):
    net, trainer, x = _net_and_trainer()
    before = net(x).asnumpy()
    ckpt = CheckpointManager(str(tmp_path / "c"), async_save=False)
    ckpt.save(1, net.collect_params())
    trainer.step(2)
    ckpt.save(2, net.collect_params())
    tag_path = os.path.join(str(tmp_path / "c"), "step_2", "integrity.json")
    with open(tag_path) as f:
        tags = json.load(f)
    name = sorted(tags["params"])[0]
    tags["params"][name] ^= 0xDEAD
    with open(tag_path, "w") as f:
        json.dump(tags, f)
    net2, _, _ = _net_and_trainer(seed=9)
    ckpt.restore(None, net2.collect_params())
    np.testing.assert_array_equal(net2(x).asnumpy(), before)
    p1 = os.path.join(str(tmp_path / "c"), "step_1", "params.npz")
    with open(p1, "r+b") as f:
        f.truncate(10)
    with pytest.raises(CheckpointCorrupt, match="no intact checkpoint"):
        ckpt.restore(None)


def test_integrity_tags_cover_all_sections(tmp_path):
    net, trainer, _ = _net_and_trainer()
    ckpt = CheckpointManager(str(tmp_path / "s"), async_save=False)
    ckpt.save(1, net.collect_params(), trainer=trainer,
              metadata={"epoch": 1}, extras={"blob": np.arange(4)})
    tag_path = os.path.join(str(tmp_path / "s"), "step_1", "integrity.json")
    with open(tag_path) as f:
        tags = json.load(f)
    assert set(tags) == {"params", "trainer_states", "metadata", "extras",
                         "digest"}
    assert tags["digest"] == ckpt.digest(1) and len(tags["digest"]) == 64
    os.unlink(tag_path)
    assert ckpt.restore(1) is not None


def test_pinned_versions_survive_retention(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "w"), max_to_keep=2,
                             async_save=False)
    params = {"w": np.arange(6, dtype=np.float32)}
    ckpt.save(1, params)
    ckpt.pin(1)
    for step in (2, 3, 4, 5, 6):
        ckpt.save(step, {"w": params["w"] * step})
    assert ckpt.all_steps() == [1, 5, 6]
    assert ckpt.pins() == {1}
    np.testing.assert_array_equal(ckpt.restore_exact(1)["params"]["w"],
                                  params["w"])
    ckpt.unpin(1)
    ckpt.save(7, {"w": params["w"] * 7})
    assert ckpt.all_steps() == [6, 7]


def test_digest_records_and_verifies_identity(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "d"), async_save=False)
    params = {"a": np.arange(4, dtype=np.float32),
              "b": np.ones((2, 2), np.float32)}
    ckpt.save(1, params)
    d1 = ckpt.digest(1)
    assert d1 == weight_digest(params)
    ckpt.save(2, params)
    assert ckpt.digest(2) == d1
    ckpt.save(3, {"a": params["a"] + 1, "b": params["b"]})
    assert ckpt.digest(3) != d1
    assert ckpt.digest(99) is None


def test_corrupt_newest_version_falls_back_to_previous(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "c"), max_to_keep=5,
                             async_save=False)
    ckpt.save(1, {"w": np.arange(3, dtype=np.float32)})
    ckpt.save(2, {"w": np.arange(3, dtype=np.float32) * 2})
    with open(os.path.join(str(tmp_path / "c"), "step_2", "params.npz"),
              "wb") as f:
        f.write(b"torn")
    with pytest.raises(CheckpointCorrupt):
        ckpt.restore_exact(2)
    np.testing.assert_array_equal(ckpt.restore(2)["params"]["w"],
                                  np.arange(3, dtype=np.float32))
    ckpt.save(3, {"w": np.arange(3, dtype=np.float32) * 3})
    np.testing.assert_array_equal(ckpt.restore_exact(3)["params"]["w"],
                                  np.arange(3, dtype=np.float32) * 3)


def test_restore_exact_missing_step_returns_none(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "m"), async_save=False)
    assert ckpt.restore_exact(4) is None
    ckpt.save(4, {"w": np.zeros(2, np.float32)})
    assert ckpt.restore_exact(4) is not None


def test_layout_groups_one_blob_each(tmp_path):
    """``layout=``: one params-<group>.npz a group; restore merges them."""
    class Halves:
        def layout(self, names):
            names = sorted(names)
            return {"a": names[:1], "b": names[1:]}
    params = {"x": np.arange(3, dtype="f"), "y": np.ones(2, "f")}
    ckpt = CheckpointManager(str(tmp_path / "l"), async_save=False)
    ckpt.save(1, params, layout=Halves())
    assert sorted(os.listdir(str(tmp_path / "l" / "step_1"))) == [
        "integrity.json", "params-a.npz", "params-b.npz"]
    got = ckpt.restore_exact(1)["params"]
    for k in params:
        np.testing.assert_array_equal(got[k], params[k])
    assert ckpt.digest(1) == weight_digest(params)


# -- across the packages -------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_mxtpu_step_restores_in_port(tmp_path, optimizer):
    """mxtpu's writer (use_orbax=False) -> the port: bitwise-equal arrays,
    the same digest, the Gluon trainer's states and optimizer; the next
    step from there is the next step mxtpu takes."""
    net, trainer, x = _net_and_trainer(mx, optimizer=optimizer)
    ck = MxCheckpointManager(str(tmp_path / "m"), async_save=False,
                             use_orbax=False)
    ck.save(3, net.collect_params(), trainer=trainer,
            metadata={"epoch": 3})
    want = _values(net)
    port_net, port_trainer, _ = _net_and_trainer(mt, seed=4,
                                                 optimizer=optimizer)
    port = CheckpointManager(str(tmp_path / "m"))
    tree = port.restore(3, port_net.collect_params(), trainer=port_trainer)
    got = _values(port_net)
    assert tree["metadata"] == {"epoch": 3}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert port.digest(3) == ck.digest(3) == weight_digest(got)
    opt = port_trainer._updaters[0].optimizer
    assert type(opt).__module__ == "mxtpu_torch.optimizer"
    assert type(opt).__name__ == type(trainer._updaters[0].optimizer) \
        .__name__
    assert opt.num_update == trainer._updaters[0].optimizer.num_update
    ref_states = {k: [np.asarray(s) for s in
                      (v if isinstance(v, (tuple, list)) else (v,))]
                  for k, v in trainer._updaters[0].states.items()}
    ref_states = {k: [s.asnumpy() if hasattr(s, "asnumpy") else s
                      for s in v] for k, v in ref_states.items()}
    for k, v in _states(port_trainer).items():
        for a, b in zip(v, ref_states[k]):
            np.testing.assert_array_equal(a, b)
    # one more step each: the same update (float32, the same order)
    for pkg, n, tr in ((mx, net, trainer), (mt, port_net, port_trainer)):
        with pkg.autograd.record():
            loss = (n(pkg.nd.array(x.asnumpy())) ** 2).sum()
        loss.backward()
        tr.step(2)
    after_mx, after_port = _values(net), _values(port_net)
    for k in after_mx:
        np.testing.assert_allclose(after_port[k], after_mx[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_port_step_restores_in_mxtpu(tmp_path):
    """The port's writer -> mxtpu: bitwise-equal arrays, the same digest
    and metadata. (The trainer's pickle names the port's classes: mxtpu
    reads it only with the port importable; see ROADMAP's documented
    differences.)"""
    net, trainer, _ = _net_and_trainer(mt)
    port = CheckpointManager(str(tmp_path / "p"), async_save=False)
    port.save(2, net.collect_params(), metadata={"epoch": 2},
              extras={"blob": np.arange(3)})
    ref = MxCheckpointManager(str(tmp_path / "p"), async_save=False,
                              use_orbax=False)
    tree = ref.restore(2)
    want = _values(net)
    for k in want:
        np.testing.assert_array_equal(tree["params"][k], want[k])
    np.testing.assert_array_equal(tree["extras"]["blob"], np.arange(3))
    assert tree["metadata"] == {"epoch": 2}
    assert ref.digest(2) == port.digest(2)
    import mxtpu.checkpoint as mx_ckpt
    assert mx_ckpt.weight_digest(tree["params"]) == port.digest(2)


@pytest.mark.parametrize("damage", ["truncate", "crc"])
@pytest.mark.parametrize("writer", ["mxtpu", "port"])
def test_torn_step_caught_across(tmp_path, writer, damage):
    """A torn or CRC-broken newest step written by either package is
    caught by the other: restore falls back to the step before,
    restore_exact raises CheckpointCorrupt."""
    from mxtpu.checkpoint import CheckpointCorrupt as MxCorrupt
    d = str(tmp_path / "x")
    make = (lambda: MxCheckpointManager(d, async_save=False,
                                        use_orbax=False)) \
        if writer == "mxtpu" else \
        (lambda: CheckpointManager(d, async_save=False))
    w = make()
    w.save(1, {"w": np.arange(4, dtype="f")})
    w.save(2, {"w": np.arange(4, dtype="f") * 2})
    step2 = os.path.join(d, "step_2")
    if damage == "truncate":
        p = os.path.join(step2, "params.npz")
        with open(p, "r+b") as f:
            f.truncate(os.path.getsize(p) // 2)
    else:
        with open(os.path.join(step2, "integrity.json")) as f:
            tags = json.load(f)
        tags["params"]["w"] ^= 0x1
        with open(os.path.join(step2, "integrity.json"), "w") as f:
            json.dump(tags, f)
    reader, corrupt = ((CheckpointManager(d, async_save=False),
                        CheckpointCorrupt) if writer == "mxtpu" else
                       (MxCheckpointManager(d, async_save=False,
                                            use_orbax=False), MxCorrupt))
    np.testing.assert_array_equal(reader.restore(2)["params"]["w"],
                                  np.arange(4, dtype="f"))
    with pytest.raises(corrupt):
        reader.restore_exact(2)


def test_mxtpu_pickled_optimizer_loads_without_jax(tmp_path):
    """A Gluon trainer's states that mxtpu pickled (its Adam, its
    Parameters and their JAX arrays in param_dict) load in a child that
    imports the port alone; the child ends with neither JAX nor mxtpu in
    sys.modules."""
    net, trainer, _ = _net_and_trainer(mx)
    raw = trainer._updaters[0].get_states(dump_optimizer=True)
    path = tmp_path / "states.bin"
    path.write_bytes(raw)
    child = r"""
import sys
sys.path.insert(0, %(root)r)
import mxtpu_torch as mt
net = mt.gluon.nn.Dense(3, in_units=4)
net.initialize(ctx=mt.cpu())
trainer = mt.gluon.Trainer(net.collect_params(), "sgd")
trainer._updaters[0].set_states(open(%(path)r, "rb").read())
opt = trainer._updaters[0].optimizer
print(type(opt).__module__, type(opt).__name__, opt.num_update,
      sorted(trainer._updaters[0].states),
      type(opt.param_dict[0]).__module__,
      opt.param_dict[0].data().shape)
print("LEAKED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "mxtpu")))
""" % {"root": ROOT, "path": str(path)}
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True,
                          text=True, timeout=120, env=dict(os.environ))
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0].split()[:3] == ["mxtpu_torch.optimizer", "Adam", "1"]
    assert "mxtpu_torch.gluon.parameter" in lines[0]
    assert lines[-1] == "LEAKED []"


def test_pickle_that_cannot_cross_is_named(tmp_path):
    """A class the port lacks raises PickleCrossingError naming it, and
    nothing of mxtpu or JAX is imported to try."""
    import pickle
    from mxtpu_torch._unpickle import loads
    raw = pickle.dumps(mx.nd.sparse.row_sparse_array(
        (np.ones((1, 2), "f"), np.array([0])), shape=(2, 2)))
    with pytest.raises(PickleCrossingError, match="RowSparseNDArray"):
        loads(raw)
