"""Serving engine: request state, page allocator, scheduler, runner."""

from llmd_tpu_torch.engine.engine import LLMEngine
from llmd_tpu_torch.engine.request import (
    FinishReason,
    PriorityClass,
    Request,
    RequestOutput,
    RequestStatus,
    SamplingParams,
)

__all__ = [
    "FinishReason",
    "LLMEngine",
    "PriorityClass",
    "Request",
    "RequestOutput",
    "RequestStatus",
    "SamplingParams",
]
