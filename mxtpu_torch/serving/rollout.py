"""Rollout and weight streaming of the PyTorch port: ``mxtpu``'s
``mxtpu/serving/rollout.py`` over the snapshot directory.

* :class:`WeightPublisher` — the trainer's side. ``publish(params)``
  writes one versioned, digest-tagged snapshot through
  :class:`~mxtpu_torch.checkpoint.CheckpointManager` (atomic rename, CRC
  tags, keep-last-K retention that never collects a pinned version). The
  ``publish.snapshot`` fault point fires before anything is written, so a
  failed publish loses the version cleanly: subscribers only ever see
  complete snapshots. The directory is ``mxtpu``'s format: either
  package's publisher feeds either package's subscriber.
* :class:`WeightSync` — the replica's side. One thread a replica polls
  the publisher's directory (``MXTPU_SERVE_WEIGHT_POLL``) and lands new
  versions through ``ModelServer.swap_weights`` (the ``serve.swap``
  point): the newest intact step wins, a corrupt newest falls back to the
  previous retained one, and a watermark refuses replays.
  ``catch_up()`` applies the current version synchronously: what a
  respawned replica runs before it admits, so it never serves stale
  weights. ``mxtpu``'s parameter-server source (the ``weights``
  long-poll) comes with the port of the parameter server.
* :class:`RolloutController` — the operator's side, over the replicas'
  admin wire ops: canary and A/B splits (a deterministic hash of the
  request id, resolved at admission), promote / abort verdicts from the
  per-version response, error and latency counters, the hot swap (drain,
  swap, resume, one replica at a time; or live, with no drain), and
  bit-exact rollback to a pinned version (restored from its snapshot,
  verified against the digest recorded at publish).
"""
from __future__ import annotations

import logging
import os
import threading
import time

import numpy as _np

from .. import fault as _fault
from .. import kvstore_async as _ka
from ..checkpoint import CheckpointCorrupt, CheckpointManager, \
    weight_digest

__all__ = ["WeightPublisher", "WeightSync", "RolloutController",
           "weight_poll_interval", "weight_keep"]

_log = logging.getLogger(__name__)


def weight_poll_interval():
    """MXTPU_SERVE_WEIGHT_POLL: seconds between a replica's weight-sync
    ticks (snapshot-dir scans; default 0.5)."""
    return float(os.environ.get("MXTPU_SERVE_WEIGHT_POLL", "0.5"))


def weight_keep():
    """MXTPU_SERVE_WEIGHT_KEEP: versioned weight snapshots the
    publisher retains on disk beyond the pinned ones (default 5)."""
    return int(os.environ.get("MXTPU_SERVE_WEIGHT_KEEP", "5"))


class WeightPublisher:
    """Versioned weight publishing into a snapshot directory."""

    def __init__(self, directory, keep=None):
        self._ckpt = CheckpointManager(
            directory, max_to_keep=weight_keep() if keep is None
            else int(keep), async_save=False, use_orbax=False)
        latest = self._ckpt.latest_step()
        self._version = 0 if latest is None else int(latest)
        self._lock = threading.Lock()
        self._c = {"published": 0, "dropped": 0}

    @property
    def directory(self):
        return self._ckpt.directory

    @property
    def version(self):
        with self._lock:
            return self._version

    def publish(self, params, version=None, pin=False, meta=None):
        """Publish ``params`` (dict name -> numpy/NDArray) as the next
        weight version: digest-tag, atomic snapshot, optional pin.
        Returns ``{"version", "digest"}`` — or None when the
        ``publish.snapshot`` fault point dropped the publish (nothing
        was written; subscribers keep the last complete version)."""
        with self._lock:
            v = self._version + 1 if version is None else int(version)
            if v <= self._version and self._version:
                raise ValueError(
                    "publish version %d is not past the watermark %d"
                    % (v, self._version))
        # the failed-publish drill point: a drop or sever here loses the
        # version before any byte reaches the disk
        act = _fault.fire("publish.snapshot", op="publish",
                          key="v%d" % v)
        if act == "drop":
            with self._lock:
                self._c["dropped"] += 1
            return None
        host = {}
        for name, val in params.items():
            if hasattr(val, "asnumpy"):
                val = val.asnumpy()
            host[str(name)] = _np.ascontiguousarray(val)
        digest = weight_digest(host)
        self._ckpt.save(v, host, metadata=dict(meta or {},
                                               digest=digest))
        if pin:
            self._ckpt.pin(v)
        with self._lock:
            self._version = max(self._version, v)
            self._c["published"] += 1
        return {"version": v, "digest": digest}

    def pin(self, version):
        self._ckpt.pin(version)

    def unpin(self, version):
        self._ckpt.unpin(version)

    def digest(self, version):
        return self._ckpt.digest(version)

    def versions(self):
        return self._ckpt.all_steps()

    def stats(self):
        with self._lock:
            return dict(self._c, version=self._version,
                        retained=len(self._ckpt.all_steps()),
                        pinned=sorted(self._ckpt.pins()))


class WeightSync:
    """A replica's weight subscriber: follow a snapshot directory, swap
    its versions into a :class:`~mxtpu_torch.serving.server.ModelServer`
    menu."""

    def __init__(self, server, model=None, weight_dir=None,
                 kv_addrs=None, poll=None):
        if kv_addrs:
            raise ValueError(
                "WeightSync(kv_addrs=...): the parameter server's weight "
                "stream comes with the port of the distributed kvstore "
                "(ROADMAP A11); follow a snapshot directory (weight_dir=)")
        if weight_dir is None:
            raise ValueError("WeightSync needs weight_dir= (snapshot "
                             "polling)")
        self._server = server
        self._model = model
        self._poll = weight_poll_interval() if poll is None \
            else float(poll)
        self._ckpt = CheckpointManager(weight_dir, max_to_keep=0,
                                       async_save=False, use_orbax=False)
        # the subscription watermark: versions at or below it are refused
        # (replay dedupe), and catching up is asking with it again
        self._have = self._current_engine_version()
        self._lock = threading.Lock()
        self._c = {"applied": 0, "skipped_stale": 0, "dropped": 0,
                   "corrupt_skipped": 0, "errors": 0}
        self._stop = threading.Event()
        self._thread = None

    def _current_engine_version(self):
        entry = self._server._entry_for(self._model)
        return int(entry.engine.version_state()["latest"])

    # -- one sync round ----------------------------------------------------
    def poll_once(self, wait_s=0.0):
        """One round: apply the newest intact snapshot past the
        watermark. Returns the newly applied version or None."""
        for step in reversed(self._ckpt.all_steps()):
            if step <= self._have:
                return None
            try:
                tree = self._ckpt.restore_exact(step)
            except CheckpointCorrupt:
                # a torn newest (disk rot: a publish is an atomic
                # rename): fall back to the previous retained one
                with self._lock:
                    self._c["corrupt_skipped"] += 1
                continue
            meta = (tree or {}).get("metadata") or {}
            digest = meta.get("digest") if isinstance(meta, dict) \
                else None
            return self._apply(step, tree["params"], digest=digest)
        return None

    def _apply(self, version, params, digest=None):
        try:
            v = self._server.swap_weights(params, version=version,
                                          digest=digest,
                                          model=self._model)
        except ValueError as e:
            with self._lock:
                self._c["errors"] += 1
            _log.warning("weight version %d refused by the engine: %s",
                         version, e)
            return None
        if v is not None:
            with self._lock:
                self._c["applied"] += 1
                self._have = max(self._have, int(version))
            return v
        # None: the engine already had it (advance the watermark), or the
        # serve.swap fault dropped the record (keep the watermark, so the
        # next round delivers it again)
        if self._current_engine_version() >= int(version):
            with self._lock:
                self._c["skipped_stale"] += 1
                self._have = max(self._have, int(version))
        else:
            with self._lock:
                self._c["dropped"] += 1
        return None

    # -- lifecycle ---------------------------------------------------------
    def catch_up(self, deadline_s=60.0):
        """Apply the directory's current version synchronously: run it
        before admitting, so a rejoining replica never answers from stale
        weights. Bounded; returns the watermark."""
        deadline = time.monotonic() + float(deadline_s)
        while time.monotonic() < deadline:
            try:
                if self.poll_once() is None:
                    break
            except (RuntimeError, OSError) as e:
                with self._lock:
                    self._c["errors"] += 1
                _log.warning("weight catch-up round failed: %s", e)
                break
        with self._lock:
            return self._have

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="mxtpu-torch-weight-sync")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except (RuntimeError, OSError) as e:
                # count it, keep serving the last complete version; the
                # watermark makes the next round an exact catch-up
                with self._lock:
                    self._c["errors"] += 1
                _log.debug("weight sync round failed: %s", e)
            self._stop.wait(self._poll)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def stats(self):
        with self._lock:
            out = dict(self._c)
            out["version"] = self._have
        out["source"] = "snapshots"
        return out


class RolloutController:
    """The operator's surface: drive canary, promote, abort and rollback
    across a serving replica set (the scriptable form of ``python -m
    mxtpu_torch.serving --admin``)."""

    def __init__(self, addrs, model=None, token=None):
        if isinstance(addrs, str):
            addrs = [a.strip() for a in addrs.split(",") if a.strip()]
        if not addrs:
            raise ValueError("RolloutController needs replica addrs")
        self._addrs = list(addrs)
        self._model = model
        self._token = token if token is not None \
            else os.environ.get("MXTPU_PS_TOKEN") or None
        self._conns = {}

    def _conn(self, addr):
        conn = self._conns.get(addr)
        if conn is None:
            conn = _ka._ServerConn(addr, token=self._token, n_socks=1,
                                   connect_timeout=30.0)
            self._conns[addr] = conn
        return conn

    def _fleet(self, *msg, timeout=60.0):
        return {addr: self._conn(addr).request(*msg, timeout=timeout)[1]
                for addr in self._addrs}

    # -- primitives --------------------------------------------------------
    def status(self):
        return self._fleet("rollout", self._model, "status", None)

    def canary(self, version, fraction):
        """Split ``fraction`` of traffic onto ``version`` fleet-wide
        (deterministic per request id — both a canary and, at 0.5, an
        A/B experiment)."""
        return self._fleet("rollout", self._model, "canary",
                           {"version": int(version),
                            "fraction": float(fraction)})

    def promote(self, version=None):
        return self._fleet("rollout", self._model, "promote",
                           {"version": version})

    def abort(self):
        return self._fleet("rollout", self._model, "abort", None)

    def pin(self, version):
        return self._fleet("rollout", self._model, "pin",
                           {"version": int(version)})

    def unpin(self):
        return self._fleet("rollout", self._model, "unpin", None)

    def rollback(self, version):
        """Bit-exact rollback fleet-wide: every replica restores the
        pinned version (resident store or versioned snapshot), verifies
        the recorded digest, and pins."""
        return self._fleet("rollout", self._model, "rollback",
                           {"version": int(version)})

    def push_weights(self, params, version, aux=None, digest=None):
        """Direct streaming: land ``version`` on every replica (the
        publisher-to-replica path)."""
        host = {}
        for name, val in params.items():
            if hasattr(val, "asnumpy"):
                val = val.asnumpy()
            host[str(name)] = _np.ascontiguousarray(val)
        if digest is None:
            digest = weight_digest(host)
        return self._fleet("weights_push", self._model, int(version),
                           host, aux, digest)

    def server_stats(self):
        return self._fleet("stats")

    # -- composite flows ---------------------------------------------------
    def hot_swap(self, params, version, aux=None, digest=None,
                 drain_timeout=15.0, live=False):
        """Zero-downtime hot-swap via the existing drain verdict: one
        replica at a time — drain (its clients steer to the peers),
        swap the new version in, resume admissions. The fleet never
        stops answering.

        ``live=True`` skips the drain and resume: every request's weight
        version resolves once at admission (predict batches never mix
        versions, and a generation lane holds its version's weights in
        its own buffers), so a ``weights_push`` under traffic never
        tears an answer in flight: new admissions route to the new
        version, old lanes drain. The mode for long generations, where a
        drain would wait for every sequence in flight."""
        out = {}
        for addr in self._addrs:
            conn = self._conn(addr)
            if not live:
                conn.request("drain", drain_timeout, timeout=30.0)
                deadline = time.monotonic() + drain_timeout
                while time.monotonic() < deadline:
                    pending = conn.request("ping", timeout=10.0)[1]
                    if not pending.get("pending"):
                        break
                    time.sleep(0.02)
            host = {n: (v.asnumpy() if hasattr(v, "asnumpy")
                        else _np.ascontiguousarray(v))
                    for n, v in params.items()}
            reply = conn.request(
                "weights_push", self._model, int(version), host, aux,
                digest if digest is not None else weight_digest(host),
                timeout=120.0)
            if not live:
                conn.request("resume", timeout=30.0)
            out[addr] = reply[1]
        return out

    def verdict(self, canary_version, stable_version=None,
                min_responses=5, err_slack=0.01, latency_slack=2.0):
        """Promote/abort verdict from the fleet's per-version evidence:
        the canary must have answered ``min_responses`` (else
        ``wait``), with an error ratio within ``err_slack`` of stable's
        and mean latency within ``latency_slack``× stable's."""
        agg = {}
        for addr, stats in self.server_stats().items():
            name = self._model or stats.get("model")
            by_v = stats.get("models", {}).get(name, {}) \
                .get("by_version", {})
            for v, rec in by_v.items():
                dst = agg.setdefault(int(v), {"responses": 0,
                                              "errors": 0,
                                              "lat_ms_sum": 0.0})
                dst["responses"] += rec.get("responses", 0)
                dst["errors"] += rec.get("errors", 0)
                dst["lat_ms_sum"] += rec.get("lat_ms_sum", 0.0)

        def _rates(v):
            rec = agg.get(int(v), {"responses": 0, "errors": 0,
                                   "lat_ms_sum": 0.0})
            n = rec["responses"]
            total = n + rec["errors"]
            return (n, rec["errors"] / total if total else 0.0,
                    rec["lat_ms_sum"] / n if n else 0.0)

        if stable_version is None:
            status = self.status()
            stable_version = next(iter(status.values()))["weights"][
                "version"]
        c_n, c_err, c_lat = _rates(canary_version)
        s_n, s_err, s_lat = _rates(stable_version)
        evidence = {"canary": {"version": int(canary_version),
                               "responses": c_n, "err_ratio": c_err,
                               "lat_ms_mean": c_lat},
                    "stable": {"version": int(stable_version),
                               "responses": s_n, "err_ratio": s_err,
                               "lat_ms_mean": s_lat}}
        if c_n < min_responses:
            return {"verdict": "wait", "evidence": evidence}
        healthy = c_err <= s_err + err_slack and (
            s_lat <= 0.0 or c_lat <= latency_slack * s_lat)
        return {"verdict": "promote" if healthy else "abort",
                "evidence": evidence}

    def close(self):
        for conn in self._conns.values():
            conn.close()
        self._conns = {}
