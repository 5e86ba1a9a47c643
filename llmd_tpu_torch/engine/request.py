"""Request and sequence state for the continuous-batching engine.

A request arrives with a prompt and sampling parameters, is queued,
scheduled incrementally (chunked prefill), then decoded one token per
engine step until a stop condition.
"""

from __future__ import annotations

import dataclasses
import enum
import time


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 16
    temperature: float = 1.0
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0
    stop_token_ids: tuple[int, ...] = ()
    ignore_eos: bool = False
    seed: int | None = None
    logprobs: bool = False

    @property
    def greedy(self) -> bool:
        return self.temperature <= 1e-5


class FinishReason(str, enum.Enum):
    STOP = "stop"          # hit EOS / stop token
    LENGTH = "length"      # hit max_tokens or max_model_len
    ABORT = "abort"        # client disconnect / cancelled


class RequestStatus(enum.Enum):
    WAITING = enum.auto()
    RUNNING = enum.auto()
    PREEMPTED = enum.auto()
    FINISHED = enum.auto()


@dataclasses.dataclass
class Request:
    """One inflight sequence.

    ``num_computed_tokens`` tracks how much of the prompt has been prefilled
    (chunked prefill advances it in steps); once it reaches
    ``len(prompt_token_ids)`` the sequence enters decode.
    """

    request_id: str
    prompt_token_ids: list[int]
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    arrival_time: float = dataclasses.field(default_factory=time.monotonic)
    priority: int = 0

    # --- mutable state ---
    status: RequestStatus = RequestStatus.WAITING
    output_token_ids: list[int] = dataclasses.field(default_factory=list)
    num_computed_tokens: int = 0
    # Physical page ids allocated to this sequence, in order.
    block_ids: list[int] = dataclasses.field(default_factory=list)
    # Under the sliding-window ring: the sequence's ring of pages in the
    # ring pool, and its memoized ring-view table row (``ModelRunner.
    # _swa_table``), dropped with the ring.
    swa_block_ids: list[int] = dataclasses.field(default_factory=list)
    swa_table_row: object = None
    # Number of prompt tokens satisfied from the prefix cache.
    num_cached_tokens: int = 0
    # Outputs generated before a recompute-preemption folded them into the
    # prompt; counts toward max_tokens and reported output length.
    num_prior_output_tokens: int = 0
    finish_reason: FinishReason | None = None
    first_token_time: float | None = None
    # Per-step sampled logprob of each output token (if requested).
    output_logprobs: list[float] = dataclasses.field(default_factory=list)

    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt_token_ids)

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_token_ids) + len(self.output_token_ids)

    @property
    def total_output_tokens(self) -> int:
        return self.num_prior_output_tokens + len(self.output_token_ids)

    @property
    def all_token_ids(self) -> list[int]:
        return self.prompt_token_ids + self.output_token_ids

    @property
    def in_decode(self) -> bool:
        return self.num_computed_tokens >= self.num_prompt_tokens

    @property
    def is_finished(self) -> bool:
        return self.status is RequestStatus.FINISHED

    def finish(self, reason: FinishReason) -> None:
        self.status = RequestStatus.FINISHED
        self.finish_reason = reason


@dataclasses.dataclass
class RequestOutput:
    """Incremental output for one request after an engine step."""

    request_id: str
    new_token_ids: list[int]
    finished: bool
    finish_reason: FinishReason | None
    num_prompt_tokens: int
    num_output_tokens: int
    num_cached_tokens: int = 0
