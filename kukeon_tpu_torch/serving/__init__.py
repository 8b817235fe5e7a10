"""Serving of the port: torch counterparts of ``kukeon_tpu/serving``."""

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
    "PREFILL_BUCKETS", "DeadlineExceeded", "RejectedError", "Request",
    "SamplingParams", "ServingEngine", "bucket_length",
]
