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


class PriorityClass(enum.IntEnum):
    """Serving bands on the one continuous batch. ``priority`` stays a free
    integer (higher schedules first, FCFS within a value); a request at or
    below ``BATCH`` rides the batch tier's backfill band
    (``SchedulerConfig.batch_backfill``). The server maps the
    ``x-llmd-priority: batch`` header here; the value is the JAX
    package's, which its router's batch filter keys on too."""

    INTERACTIVE = 0
    BATCH = -100


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
    # P/D transfer params (``do_remote_decode`` on a producer; the
    # producer's answer on a consumer), read by the KV connector.
    kv_transfer_params: dict | None = None

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
    # Tokens dispatched to the device that no readback has committed yet
    # (async stepping, ``SchedulerConfig.async_scheduling``): the next
    # step is scheduled against the dispatched positions while the
    # in-flight step runs. Always 0 in the synchronous engine, and
    # between a step's commit and the next dispatch.
    num_pending_tokens: int = 0
    # Number of prompt tokens satisfied from the prefix cache.
    num_cached_tokens: int = 0
    # Outputs generated before a recompute-preemption folded them into the
    # prompt; counts toward max_tokens and reported output length.
    num_prior_output_tokens: int = 0
    finish_reason: FinishReason | None = None
    first_token_time: float | None = None
    # Per-step sampled logprob of each output token (if requested).
    output_logprobs: list[float] = dataclasses.field(default_factory=list)
    # Speculative decoding: the proposer's incremental gram index
    # (``NgramProposer.new_state``), the run of fully rejected drafts
    # (the scheduler's backoff), and the row's drafted and accepted
    # token counts.
    spec_gram_state: dict | None = None
    spec_consec_rejected: int = 0
    spec_drafted_tokens: int = 0
    spec_accepted_tokens: int = 0
    # What a kv_producer engine's export returned at finish (the
    # connector's finish hook), echoed on the request's last output.
    export_params: dict | None = None

    @property
    def is_batch(self) -> bool:
        """Whether the request rides the batch tier's backfill band."""
        return self.priority <= PriorityClass.BATCH

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

    def token_slice(self, start: int, n: int) -> list[int]:
        """``all_token_ids[start:start + n]`` without building the whole
        list: a step's dispatch reads one token of each decode row."""
        p = len(self.prompt_token_ids)
        if start >= p:
            return self.output_token_ids[start - p : start - p + n]
        if start + n <= p:
            return self.prompt_token_ids[start : start + n]
        return self.prompt_token_ids[start:] + self.output_token_ids[: start + n - p]

    @property
    def in_decode(self) -> bool:
        return self.num_computed_tokens >= self.num_prompt_tokens

    @property
    def num_dispatched_tokens(self) -> int:
        """The position once the in-flight step lands: what the scheduler
        plans against (``num_computed_tokens`` when nothing is in flight)."""
        return self.num_computed_tokens + self.num_pending_tokens

    @property
    def in_decode_dispatched(self) -> bool:
        """``in_decode`` once the in-flight step lands: a prompt chunk in
        flight that completes the prompt makes the sequence a decode row
        of the next staged step."""
        return self.num_dispatched_tokens >= self.num_prompt_tokens

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
    kv_transfer_params: dict | None = None
