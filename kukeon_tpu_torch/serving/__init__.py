"""Serving of the port: torch counterparts of ``kukeon_tpu/serving``."""

from kukeon_tpu_torch.serving.embedding import EMBED_BUCKETS, EmbeddingEngine
from kukeon_tpu_torch.serving.engine import (
    PREFILL_BUCKETS,
    DeadlineExceeded,
    RejectedError,
    Request,
    ServingEngine,
    bucket_length,
)
from kukeon_tpu_torch.serving.sampling import SamplingParams

__all__ = [
    "EMBED_BUCKETS", "PREFILL_BUCKETS", "DeadlineExceeded", "EmbeddingEngine",
    "RejectedError", "Request", "SamplingParams", "ServingEngine", "bucket_length",
]
