"""The replica process on the CPU: ``python -m mxtpu_torch.serving`` started
with ``subprocess`` as a fresh interpreter (``MXTPU_SERVE_CTX=cpu``),
beside an in-process ``ModelServer`` over the same checkpoint. A client
of both fails over exactly once when the child is killed with SIGKILL
mid-requests; a respawned child catches up to the published weight
version before it admits (its ``hello`` shows it); SIGTERM drains the
child to exit 0; a setting of a later slice makes it exit 2 naming it.
Every wait is bounded."""
import os
import queue
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

import mxtpu_torch as mt
from mxtpu_torch import kvstore_async as ka
from mxtpu_torch.serving import (InferenceEngine, ModelServer,
                                 ServingClient, WeightPublisher)
from test_torch_serving_wire import IN_DIM, mlp, mlp_params
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    monkeypatch.setattr(ka, "_LOCAL_ON", False)
    monkeypatch.setattr(ka, "_RETRIES", 1)
    monkeypatch.setattr(ka, "_BACKOFF", 0.01)
    monkeypatch.setattr(ka, "_BACKOFF_MAX", 0.05)
    monkeypatch.setattr(ka, "_RECONNECT_TIMEOUT", 0.2)
    monkeypatch.setattr(ka, "_DEAD_AFTER", 2)


class Replica:
    """One ``python -m mxtpu_torch.serving`` child; its output lines are
    read by a thread into a queue."""

    def __init__(self, env):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "mxtpu_torch.serving"], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT, **env),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines = queue.Queue()
        self.log = []
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def wait_for(self, text, timeout=60):
        while True:
            line = self.lines.get(timeout=timeout)
            if line is None:
                raise AssertionError("replica exited: %s" % self.log)
            self.log.append(line)
            if text in line:
                return line

    def address(self):
        return self.wait_for("listening on").split("listening on ")[1] \
            .split()[0]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)


@pytest.fixture
def checkpoint(tmp_path):
    prefix = str(tmp_path / "mlp")
    mt.model.save_checkpoint(prefix, 0, mlp(mt), {
        k: mt.nd.array(v, ctx=mt.cpu()) for k, v in mlp_params().items()},
        {})
    return prefix


def _env(prefix, **kw):
    env = {"MXTPU_SERVE_MODEL": prefix, "MXTPU_SERVE_DATA_SHAPES":
           "data=%d" % IN_DIM, "MXTPU_SERVE_BUCKETS": "4",
           "MXTPU_SERVE_CTX": "cpu", "MXTPU_SERVE_BATCH_DEADLINE_MS": "5",
           "MXTPU_SERVE_WEIGHT_POLL": "0.1"}
    env.update(kw)
    return env


def test_kill_respawn_catch_up_and_drain(checkpoint, tmp_path):
    weights = str(tmp_path / "w")
    pub = WeightPublisher(weights)
    local = ModelServer(InferenceEngine.from_checkpoint(
        checkpoint, 0, {"data": (IN_DIM,)}, buckets=(4,), ctx=mt.cpu()),
        model_name="mlp", batch_deadline_ms_=5, weight_dir=weights).start()
    child = respawn = None
    try:
        child = Replica(_env(checkpoint, MXTPU_SERVE_WEIGHT_DIR=weights))
        addr = child.address()
        cli = ServingClient(addrs=[addr, local.address], budget_ms=5000)
        assert cli.hello()["models"]["mlp"]["weights"]["version"] == 0
        rng = np.random.RandomState(0)
        xs = [rng.rand(1, IN_DIM).astype("f") for _ in range(12)]
        want = [local._engine.predict([x])[0] for x in xs]
        got = [cli.predict(x)[0] for x in xs[:4]]
        # kill -9 mid-requests: the rest are answered once each, by the
        # in-process replica, bitwise as before
        os.kill(child.proc.pid, signal.SIGKILL)
        got += [cli.predict(x)[0] for x in xs[4:]]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        st = cli.stats()
        assert st["failovers"] >= 1 and st["responses"] == 12
        assert local.stats()["counters"]["responses"] == 8
        # a published version: the respawned child admits on it
        pub.publish({k: v * 2 for k, v in mlp_params().items()})
        respawn = Replica(_env(checkpoint, MXTPU_SERVE_WEIGHT_DIR=weights))
        assert "version 1" in respawn.wait_for("caught up")
        raddr = respawn.address()
        rcli = ServingClient(addrs=[raddr], budget_ms=5000)
        assert rcli.hello()["models"]["mlp"]["weights"]["version"] == 1
        out, info = rcli.predict2(xs[0])
        assert info["version"] == 1
        respawn.proc.send_signal(signal.SIGTERM)
        assert respawn.proc.wait(timeout=30) == 0
        assert "drained=True" in respawn.wait_for("stopped")
        with pytest.raises(ConnectionError):
            ServingClient(addrs=[raddr], connect_timeout=0.5).hello()
    finally:
        for r in (child, respawn):
            if r is not None:
                r.close()
        local.stop()


@pytest.mark.parametrize("later", ["MXTPU_SERVE_WEIGHT_KV",
                                   "MXTPU_SERVE_PREWARM_DIR"])
def test_settings_of_later_slices_are_refused(checkpoint, later):
    r = Replica(_env(checkpoint, **{later: "x"}))
    try:
        assert "is set, but" in r.wait_for(later)
        assert r.proc.wait(timeout=60) == 2
    finally:
        r.close()
