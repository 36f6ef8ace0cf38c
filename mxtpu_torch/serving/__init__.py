"""Model serving of the PyTorch port, on ``mxtpu.serving``'s wire.

* :mod:`.engine` — :class:`InferenceEngine`: a checkpoint of either
  package, a predict program a batch bucket, versioned weight stores
  (swap, canary, promote, pin, rollback) and the generation programs
  (prefill, adopt, decode; CUDA graphs on the card over a lane's own
  weight buffers).
* :mod:`.batcher` — :class:`DynamicBatcher` (bounded queue, coalescing
  into buckets, deadlines, drain) and :class:`GenerateScheduler`
  (continuous batching of generation).
* :mod:`.server` — :class:`ModelServer`, one replica: admission, the
  ``hello`` / ``predict`` / ``generate`` (streamed token frames) /
  ``ping`` / ``stats`` / ``metrics`` / ``drain`` / ``resume`` /
  ``weights_push`` / ``rollout`` / ``stop`` ops over
  :mod:`mxtpu_torch.kvstore_async`'s transport.
* :mod:`.client` — :class:`ServingClient`: failover across replicas,
  exactly one answer a request id, streamed tokens delivered once.
* :mod:`.rollout` — :class:`WeightPublisher`, :class:`WeightSync` over a
  snapshot directory, :class:`RolloutController`.
* ``python -m mxtpu_torch.serving`` — a replica process
  (:mod:`.__main__`).

Either package's client talks to either package's server. Fault drills
ride :mod:`mxtpu_torch.fault`'s serving points (``serve.request``,
``serve.batch``, ``serve.step``, ``serve.swap``, ``publish.snapshot``) and
the transport's. Streaming emit logs, the fleet, telemetry and program
export come with the second half of ROADMAP A12.
"""
from .batcher import (DynamicBatcher, GenerateScheduler, GenRequest,
                      Request, RETRIABLE_VERDICTS, gen_lanes_max)
from .client import DeadlineExceeded, Overloaded, ServingClient
from .engine import (GenState, InferenceEngine, gen_max_new,
                     gen_prefill_buckets, gen_slots, parse_buckets,
                     parse_shape_spec, version_keep)
from .rollout import RolloutController, WeightPublisher, WeightSync
from .server import ModelServer

__all__ = ["InferenceEngine", "DynamicBatcher", "GenerateScheduler",
           "ModelServer", "ServingClient", "Overloaded",
           "DeadlineExceeded", "RolloutController", "WeightPublisher",
           "WeightSync", "RETRIABLE_VERDICTS", "parse_buckets",
           "parse_shape_spec", "GenState", "GenRequest", "Request",
           "gen_slots", "gen_max_new", "gen_prefill_buckets",
           "gen_lanes_max", "version_keep"]
