"""Serving engine: request state, page allocator, scheduler, runner."""

from llmd_tpu_torch.engine.engine import LLMEngine
from llmd_tpu_torch.engine.request import (
    FinishReason,
    Request,
    RequestOutput,
    RequestStatus,
    SamplingParams,
)

__all__ = [
    "FinishReason",
    "LLMEngine",
    "Request",
    "RequestOutput",
    "RequestStatus",
    "SamplingParams",
]
