"""Continuous-batching serving engine and sampler."""

from quant_tpu_torch.engine.engine import Engine, QueueFullError, Request
from quant_tpu_torch.engine.sampler import SamplingConfig

__all__ = ["Engine", "QueueFullError", "Request", "SamplingConfig"]
