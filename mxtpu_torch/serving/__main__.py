"""A serving replica process: ``python -m mxtpu_torch.serving``.

The port of ``python -m mxtpu.serving``: one :class:`ModelServer` over
one checkpoint, on the serving wire. Environment contract (``mxtpu``'s):

* ``MXTPU_SERVE_MODEL``       checkpoint prefix (``prefix-symbol.json`` +
                              ``prefix-%04d.params``, written by either
                              package), required
* ``MXTPU_SERVE_EPOCH``       checkpoint epoch (default 0)
* ``MXTPU_SERVE_DATA_SHAPES`` per-sample input shapes,
                              ``name=dims[;name=dims]``, required
* ``MXTPU_SERVE_PORT``        port to bind (default 0: the OS picks)
* ``MXTPU_SERVE_ADDRS``       comma list of all replica addresses
                              (advertised to clients at hello)
* ``MXTPU_SERVE_BUCKETS``     batch buckets (default ``1,2,4,8,16,32``)
* ``MXTPU_SERVE_WEIGHT_DIR``  versioned weight-snapshot directory to
                              follow (a ``WeightPublisher``'s of either
                              package; also the rollback restore source)
* ``MXTPU_SERVE_WEIGHT_POLL`` weight-sync tick seconds (default 0.5)
* ``MXTPU_SERVE_DRAIN_TIMEOUT`` seconds SIGTERM's drain may take (30)
* the batching and admission knobs :mod:`mxtpu_torch.serving.server`
  reads (``MXTPU_SERVE_QUEUE_DEPTH``, ``MXTPU_SERVE_BATCH_DEADLINE_MS``,
  ``MXTPU_SERVE_DEADLINE_MS``), and ``MXTPU_PS_TOKEN``.

The port adds ``MXTPU_SERVE_CTX``: ``gpu`` (the default: ``gpu(0)``),
``gpu:N`` or ``cpu``. ``mxtpu``'s ``MXTPU_SERVE_WEIGHT_KV`` (the
parameter server's weight stream) and ``MXTPU_SERVE_PREWARM_DIR`` (an
exported program menu) come with later slices; set, they make the
process exit with an error that says so.

With a weight directory the replica catches up to its current version
before it admits (a respawned replica never serves stale weights), then
follows it. It prints ``listening on HOST:PORT`` once it admits.

SIGTERM (or SIGINT) drains: admissions stop (new requests get the
retriable ``draining`` verdict, steering clients to the other replicas),
admitted work is flushed, and the process exits 0. The main thread waits
on an event with a timeout, never inside a device call, so the signal
is handled at once.

Admin one-shots against running replicas::

    python -m mxtpu_torch.serving --admin rollout --addrs host:p,host:p \\
        --action canary|promote|abort|rollback|pin|unpin|status|verdict \\
        [--version V] [--fraction F] [--model NAME]
"""
from __future__ import annotations

import os
import signal
import sys
import threading
import time

# settings of later slices: named, so that a replica never silently
# ignores a weight source or a program menu it was told to use
_LATER = {
    "MXTPU_SERVE_WEIGHT_KV": "the parameter server's weight stream comes "
                             "with the port of the distributed kvstore "
                             "(ROADMAP A11)",
    "MXTPU_SERVE_PREWARM_DIR": "exported program menus (export_programs / "
                               "prewarm_from) come with the second half "
                               "of ROADMAP A12",
}


def _ctx(spec):
    from ..context import cpu, gpu
    spec = spec.strip().lower()
    if spec == "cpu":
        return cpu()
    if spec == "gpu":
        return gpu(0)
    if spec.startswith("gpu:"):
        return gpu(int(spec[4:]))
    raise ValueError("MXTPU_SERVE_CTX must be gpu, gpu:N or cpu, not %r"
                     % spec)


def main():
    prefix = os.environ.get("MXTPU_SERVE_MODEL")
    shapes = os.environ.get("MXTPU_SERVE_DATA_SHAPES")
    if not prefix or not shapes:
        print("mxtpu_torch.serving: MXTPU_SERVE_MODEL and "
              "MXTPU_SERVE_DATA_SHAPES are required", file=sys.stderr)
        return 2
    later = [(k, why) for k, why in _LATER.items() if os.environ.get(k)]
    if later:
        for k, why in later:
            print("mxtpu_torch.serving: %s is set, but %s"
                  % (k, why), file=sys.stderr)
        return 2
    t_boot = time.monotonic()
    from . import (InferenceEngine, ModelServer, WeightSync, parse_buckets,
                   parse_shape_spec)
    epoch = int(os.environ.get("MXTPU_SERVE_EPOCH", "0"))
    engine = InferenceEngine.from_checkpoint(
        prefix, epoch, parse_shape_spec(shapes),
        buckets=parse_buckets(os.environ.get("MXTPU_SERVE_BUCKETS",
                                             "1,2,4,8,16,32")),
        ctx=_ctx(os.environ.get("MXTPU_SERVE_CTX", "gpu")), warm=False)
    srv = ModelServer(engine, port=int(os.environ.get("MXTPU_SERVE_PORT",
                                                      "0")),
                      model_name=os.path.basename(prefix))
    weight_dir = os.environ.get("MXTPU_SERVE_WEIGHT_DIR") or None
    sync = None
    if weight_dir:
        sync = WeightSync(srv, weight_dir=weight_dir)
        # the rejoin contract: the current weights before the first admit
        print("mxtpu_torch serving replica caught up to weight version %d"
              % sync.catch_up(), flush=True)
    term = threading.Event()

    def _on_term(signum, frame):
        term.set()                 # the drain runs on the main thread

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    srv.start()                    # warms every program, then listens
    if sync is not None:
        sync.start()
    print("mxtpu_torch serving replica time-to-serving %.3fs (compiles=%d, "
          "weight version %d) on %s"
          % (time.monotonic() - t_boot, engine.cache.compiles,
             engine.version_state()["version"], engine.device), flush=True)
    print("mxtpu_torch serving replica listening on %s (model=%s "
          "buckets=%s)" % (srv.address, os.path.basename(prefix),
                           ",".join(str(b) for b in engine.buckets)),
          flush=True)
    while not term.is_set():
        term.wait(timeout=0.5)
    print("mxtpu_torch serving replica %s draining" % srv.address,
          flush=True)
    if sync is not None:
        sync.stop()
    drained = srv.drain(timeout=float(
        os.environ.get("MXTPU_SERVE_DRAIN_TIMEOUT", "30")))
    counters = srv.stats()["counters"]
    srv.stop()
    print("mxtpu_torch serving replica %s stopped (drained=%s, "
          "responses=%d, shed_draining=%d)"
          % (srv.address, drained, counters["responses"],
             counters["shed_draining"]), flush=True)
    return 0


def _admin_main(argv):
    """Operator one-shots against running replicas: the wire form of
    :class:`~mxtpu_torch.serving.rollout.RolloutController` (the shared
    secret from ``MXTPU_PS_TOKEN``)."""
    import argparse
    import json
    from .rollout import RolloutController
    ap = argparse.ArgumentParser(prog="mxtpu_torch.serving")
    ap.add_argument("--admin", choices=("rollout",), required=True)
    ap.add_argument("--addrs", required=True,
                    help="comma list of serving replica addresses")
    ap.add_argument("--action", required=True,
                    choices=("canary", "promote", "abort", "rollback",
                             "pin", "unpin", "status", "verdict"))
    ap.add_argument("--model", default=None)
    ap.add_argument("--version", type=int, default=None)
    ap.add_argument("--fraction", type=float, default=0.1)
    a = ap.parse_args(argv)
    ctl = RolloutController(a.addrs, model=a.model)
    try:
        if a.action == "canary":
            out = ctl.canary(a.version, a.fraction)
        elif a.action == "promote":
            out = ctl.promote(a.version)
        elif a.action == "abort":
            out = ctl.abort()
        elif a.action == "rollback":
            out = ctl.rollback(a.version)
        elif a.action == "pin":
            out = ctl.pin(a.version)
        elif a.action == "unpin":
            out = ctl.unpin()
        elif a.action == "verdict":
            out = ctl.verdict(a.version)
        else:
            out = ctl.status()
        print(json.dumps(out, default=str))
    finally:
        ctl.close()
    return 0


if __name__ == "__main__":
    if "--admin" in sys.argv:
        sys.exit(_admin_main(sys.argv[1:]))
    sys.exit(main())
