"""LLMEngine: scheduler + page allocator + model runner, stepped in sync.

Keeps the JAX engine's public API (``add_request``, ``step``,
``generate``, ``abort_request``, ``has_work``) and its synchronous step
(``llmd_tpu/engine/engine.py:_step_sync``). A step that is eligible runs as
one unified program (the flat step over the packed token stream, or the
bucketed ``[B, Q]`` program without ``ragged_qlens``); otherwise its
prefill chunks go out as Q-bucket groups and its decode rows as one fused
window of K iterations (the split engine, and every engine whose
scheduler picked ``K > 1``). Either way the step ends in one host
readback, and a decode row's output carries up to K tokens.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import uuid

import torch

from llmd_tpu_torch.config import EngineConfig
from llmd_tpu_torch.engine.kv_cache import PageAllocator
from llmd_tpu_torch.engine.request import Request, RequestOutput, SamplingParams
from llmd_tpu_torch.engine.runner import (
    ModelRunner,
    PendingDecode,
    StepResult,
    resolve_device,
)
from llmd_tpu_torch.engine.scheduler import (
    EngineScheduler,
    ScheduledBatch,
    ScheduledSeq,
)


@dataclasses.dataclass
class EngineStats:
    """Counters of the engine's work, updated every step."""

    engine_steps_total: int = 0
    # Device programs enqueued: one per unified step, per prefill Q-bucket
    # group and per decode window.
    step_dispatches_total: int = 0
    # Programs that carried decode rows.
    decode_dispatches_total: int = 0
    # Steps that ran as one unified program.
    unified_steps_total: int = 0


class LLMEngine:
    def __init__(
        self,
        config: EngineConfig,
        params: dict | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.config = config
        self.device = resolve_device(device)
        self.allocator = PageAllocator(
            num_pages=config.cache.num_blocks,
            page_size=config.cache.page_size,
            enable_prefix_caching=config.cache.enable_prefix_caching,
        )
        self.scheduler = EngineScheduler(
            config.scheduler, config.cache, self.allocator,
            config.model.max_model_len,
        )
        self.runner = ModelRunner(config, params=params, device=self.device)
        self.stats = EngineStats()
        self._counter = itertools.count()

    def add_request(
        self,
        prompt_token_ids: list[int],
        sampling: SamplingParams | None = None,
        request_id: str | None = None,
        priority: int = 0,
    ) -> str:
        if not prompt_token_ids:
            raise ValueError("empty prompt")
        vocab = self.config.model.vocab_size
        if not all(0 <= t < vocab for t in prompt_token_ids):
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        if len(prompt_token_ids) >= self.config.model.max_model_len:
            raise ValueError(
                f"prompt length {len(prompt_token_ids)} >= max_model_len "
                f"{self.config.model.max_model_len}"
            )
        rid = request_id or f"req-{next(self._counter)}-{uuid.uuid4().hex[:8]}"
        self.scheduler.add_request(
            Request(
                request_id=rid,
                prompt_token_ids=list(prompt_token_ids),
                sampling=sampling or SamplingParams(),
                priority=priority,
            )
        )
        return rid

    def abort_request(self, request_id: str) -> bool:
        return self.scheduler.abort_request(request_id) is not None

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def warmup(self) -> int:
        """Build the kernels and prepare the decode steps' programs (CUDA
        graphs on the card) before serving; returns how many
        (``ModelRunner.warmup``)."""
        return self.runner.warmup()

    def step(self) -> list[RequestOutput]:
        batch: ScheduledBatch = self.scheduler.schedule()
        if batch.is_empty:
            return []
        now = time.monotonic()
        pend_p = pend_d = pend_u = None
        if self._unified_eligible(batch):
            pend_u = self.runner.dispatch_unified(batch.prefills, batch.decodes)
            self.stats.unified_steps_total += 1
            self.stats.step_dispatches_total += 1
            if batch.decodes:
                self.stats.decode_dispatches_total += 1
        else:
            if batch.prefills:
                pend_p = self.runner.dispatch_prefill(batch.prefills)
                self.stats.step_dispatches_total += len(pend_p.entries)
            if batch.decodes:
                pend_d = self._dispatch_decodes(batch.decodes)
        # One readback for the whole step, whatever it dispatched.
        pres, dres = self.runner.wait_step(pend_p, pend_d, pend_u)
        sampled, logprobs = self._collect(batch, pres, dres)
        accepted = self.scheduler.update_after_step(batch, sampled)
        outputs = self._assemble_outputs(batch, accepted, logprobs, now)
        self.stats.engine_steps_total += 1
        return outputs

    def _unified_eligible(self, batch: ScheduledBatch) -> bool:
        """Does this batch ride the unified single-dispatch program?
        Window-1 steps only: a fused decode window keeps its own dispatch.
        The flat step takes every such step. The bucketed unified program
        takes only steps for which the split engine would launch more than
        one program: mixed prefill + decode steps, and prefill-only steps
        that span several Q buckets."""
        if any(s.num_tokens != 1 for s in batch.decodes):
            return False
        if self.runner.flat:
            return True
        if not self.config.scheduler.unified_step or not batch.prefills:
            return False
        if batch.decodes:
            return True
        return self.runner.prefill_group_count(batch.prefills) > 1

    def _dispatch_decodes(self, decodes: list[ScheduledSeq]) -> PendingDecode:
        """The step's decode rows as one fused window; K is uniform across
        the batch (the scheduler's choice)."""
        staged = self.runner.stage_decode(decodes, k_steps=decodes[0].num_tokens)
        pend = self.runner.dispatch_staged_decode(staged)
        self.stats.decode_dispatches_total += 1
        self.stats.step_dispatches_total += 1
        return pend

    @staticmethod
    def _collect(
        batch: ScheduledBatch, pres: StepResult | None, dres: StepResult | None
    ) -> tuple[dict[str, list[int]], dict[str, list[float]]]:
        """Per request id: the window of sampled tokens and their logprobs."""
        sampled: dict[str, list[int]] = {}
        logprobs: dict[str, list[float]] = {}
        for res, seqs in ((pres, batch.prefills), (dres, batch.decodes)):
            for i, seq in enumerate(seqs):
                sampled[seq.request.request_id] = res.tokens[i].tolist()
                logprobs[seq.request.request_id] = res.logprobs[i].tolist()
        return sampled, logprobs

    def _assemble_outputs(
        self,
        batch: ScheduledBatch,
        accepted: dict[str, list[int]],
        logprobs: dict[str, list[float]],
        now: float,
    ) -> list[RequestOutput]:
        outputs: list[RequestOutput] = []
        for seq in batch.seqs:
            req = seq.request
            new_tokens = accepted.get(req.request_id)
            if not new_tokens:
                continue
            if req.first_token_time is None:
                req.first_token_time = now
            if req.sampling.logprobs:
                req.output_logprobs.extend(
                    logprobs[req.request_id][: len(new_tokens)]
                )
            outputs.append(
                RequestOutput(
                    request_id=req.request_id,
                    new_token_ids=new_tokens,
                    finished=req.is_finished,
                    finish_reason=req.finish_reason,
                    num_prompt_tokens=req.num_prompt_tokens - req.num_prior_output_tokens,
                    num_output_tokens=req.total_output_tokens,
                    num_cached_tokens=req.num_cached_tokens,
                )
            )
        return outputs

    def generate(
        self,
        prompts: list[list[int]],
        sampling: SamplingParams | list[SamplingParams] | None = None,
        max_steps: int = 100_000,
    ) -> dict[str, list[int]]:
        """Offline batch API: run all prompts to completion."""
        if sampling is None or isinstance(sampling, SamplingParams):
            sampling = [sampling or SamplingParams()] * len(prompts)
        if len(sampling) != len(prompts):
            raise ValueError(
                f"{len(prompts)} prompts but {len(sampling)} sampling params"
            )
        order = [self.add_request(p, s) for p, s in zip(prompts, sampling)]
        done: dict[str, list[int]] = {rid: [] for rid in order}
        for _ in range(max_steps):
            if not self.has_work():
                break
            for out in self.step():
                done[out.request_id].extend(out.new_token_ids)
        return {rid: done[rid] for rid in order}
