"""Model serving of the PyTorch port: the predict menu and the generation
programs of :class:`~mxtpu_torch.serving.engine.InferenceEngine`, and the
continuous-batching :class:`~mxtpu_torch.serving.batcher.GenerateScheduler`.
The dynamic batcher, server, client and rollout of ``mxtpu.serving`` wait
for a later slice."""
from .batcher import GenerateScheduler, GenRequest, gen_lanes_max
from .engine import (GenState, InferenceEngine, gen_max_new,
                     gen_prefill_buckets, gen_slots, parse_buckets)

__all__ = ["InferenceEngine", "GenState", "GenerateScheduler", "GenRequest",
           "parse_buckets", "gen_slots", "gen_max_new", "gen_prefill_buckets",
           "gen_lanes_max"]
