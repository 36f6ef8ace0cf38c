"""Model serving of the PyTorch port: the predict menu of
:class:`~mxtpu_torch.serving.engine.InferenceEngine`. The batcher,
server, client and generation menu of ``mxtpu.serving`` wait for a later
slice."""
from .engine import InferenceEngine, parse_buckets

__all__ = ["InferenceEngine", "parse_buckets"]
