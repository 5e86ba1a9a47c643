"""Continuous-batching scheduler with chunked prefill and prefix caching.

The port of ``llmd_tpu/engine/scheduler.py:EngineScheduler.schedule`` for
the synchronous step: every engine step selects a token budget's worth of
work — one token per running decode sequence, then prompt chunks for
sequences mid-prefill, then admissions from the waiting queue (chunked
prefill, so long prompts never starve decodes). Preemption is
recompute-style: when KV pages run out, the youngest running sequence is
evicted, its pages freed, and it restarts from the waiting queue with its
generated tokens folded into the prompt.

With ``decode_window > 1`` a step that cannot make admission progress (no
admissible waiting request, no prompt chunk in flight) schedules every
decode row for a fused window of K tokens: pages for all K are claimed
before dispatch, and ``update_after_step`` appends the window's tokens one
by one, ending the row at the first stop condition.

Under the sliding-window ring (``CacheConfig.swa_ring``) an admitted
sequence also holds a ring of ``swa_ring_pages`` pages in the ring pool
(``_ensure_ring``), a prefill chunk is capped at ``swa_chunk_tokens``
(the span the ring is sized for), and a bare prefix-cache hit is never
taken: the engine takes hybrid hits at arrival instead
(``LLMEngine._try_hybrid_ring_hit``).
"""

from __future__ import annotations

import bisect
import dataclasses

from llmd_tpu_torch.config import CacheConfig, SchedulerConfig
from llmd_tpu_torch.engine.kv_cache import (
    NoFreePagesError,
    PageAllocator,
    _ROOT_HASH,
    hash_page,
)
from llmd_tpu_torch.engine.request import FinishReason, Request, RequestStatus


@dataclasses.dataclass
class ScheduledSeq:
    request: Request
    num_tokens: int  # tokens to compute for this seq in this step

    @property
    def start_pos(self) -> int:
        return self.request.num_computed_tokens


@dataclasses.dataclass
class ScheduledBatch:
    prefills: list[ScheduledSeq]
    decodes: list[ScheduledSeq]

    @property
    def seqs(self) -> list[ScheduledSeq]:
        return self.prefills + self.decodes

    @property
    def is_empty(self) -> bool:
        return not self.prefills and not self.decodes


def _queue_key(r: Request):
    return (-r.priority, r.arrival_time)


class EngineScheduler:
    def __init__(
        self,
        scheduler_config: SchedulerConfig,
        cache_config: CacheConfig,
        allocator: PageAllocator,
        max_model_len: int,
        swa_allocator: PageAllocator | None = None,
        swa_ring_pages: int = 0,
        swa_chunk_tokens: int = 0,
    ) -> None:
        self.config = scheduler_config
        self.cache_config = cache_config
        self.allocator = allocator
        self.max_model_len = max_model_len
        # The ring pool and a ring's length (0: no ring), and the chunk cap
        # the ring is sized for (``SwaRingSpec``).
        self.swa_allocator = swa_allocator
        self.swa_ring_pages = swa_ring_pages
        self.swa_chunk_tokens = swa_chunk_tokens
        # Ring engines with retained sections: called once a request's
        # prompt completes (its ring still holds the prompt's last window:
        # the section capture), and when a ring allocation fails (frees
        # one retained section; returns whether it freed one).
        self.prefill_complete_hook = None
        self.ring_pressure_hook = None
        # Ordered by (-priority, arrival_time): higher priority first, FCFS
        # within a priority class.
        self.waiting: list[Request] = []
        self.running: list[Request] = []
        self.num_preemptions = 0
        # request_id -> (committed page hash chain tail, committed pages)
        self._chain: dict[str, tuple[bytes, int]] = {}

    # ------------------------------------------------------------------ #
    # queue management

    def add_request(self, request: Request) -> None:
        request.status = RequestStatus.WAITING
        bisect.insort(self.waiting, request, key=_queue_key)

    def abort_request(self, request_id: str) -> Request | None:
        for queue in (self.running, self.waiting):
            for req in queue:
                if req.request_id == request_id:
                    queue.remove(req)
                    self._release(req)
                    req.finish(FinishReason.ABORT)
                    return req
        return None

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------------ #
    # scheduling

    def schedule(self) -> ScheduledBatch:
        """Select the next batch. A step that schedules nothing while work
        remains changes nothing, so the engine would spin: every running
        sequence waits for pages that waiting requests hold (prefix hits
        taken by a failed admission, hybrid hits) or other running
        prefills hold. Then the waiting requests' pages and rings are
        released (they prefill later), and if that is not enough, the
        youngest running sequences are preempted one at a time."""
        batch = self._schedule()
        if batch.is_empty and self.has_work():
            held = [r for r in self.waiting if r.block_ids or r.swa_block_ids]
            for r in held:
                self._drop_hold(r)
            if held:
                batch = self._schedule()
            for _ in range(len(self.running) - 1):
                if not batch.is_empty or not self._preempt_for(None):
                    break
                batch = self._schedule()
        return batch

    def _schedule(self) -> ScheduledBatch:
        budget = self.config.max_num_batched_tokens
        decodes: list[ScheduledSeq] = []
        prefills: list[ScheduledSeq] = []
        scheduled: set[str] = set()

        decoding = [r for r in self.running if r.in_decode]
        mid_prefill = [r for r in self.running if not r.in_decode]

        # Fused K-step decode windows apply whenever this step cannot make
        # admission progress anyway (nothing admissible waiting, no prompt
        # chunks in flight), in particular in the saturated regime, where
        # spreading the dispatch over K tokens pays most. Otherwise K = 1
        # keeps admission latency at one step. K is uniform across the
        # batch and capped so no sequence runs past max_model_len.
        can_admit = bool(self.waiting) and len(self.running) < self.config.max_num_seqs
        k = 1
        if self.config.decode_window > 1 and decoding and not mid_prefill and not can_admit:
            room = min(self.max_model_len - r.num_computed_tokens for r in decoding)
            k = max(1, min(self.config.decode_window, room))

        # 1. Decodes claim pages FIRST: a running decode must never be
        #    starved by prefill admission taking the last free pages.
        for req in decoding:
            if req.status is not RequestStatus.RUNNING:
                continue  # reset by a preemption earlier in this loop
            if budget <= 0:
                break
            if not self._ensure_pages(req, k):
                # Never evict a sequence already placed in this step's
                # batch: the runner still writes its pages.
                if not self._preempt_for(req, exclude=scheduled):
                    continue
                if not self._ensure_pages(req, k):
                    continue
            decodes.append(ScheduledSeq(req, k))
            scheduled.add(req.request_id)
            budget -= 1

        # 2. Continue chunked prefills of already-running sequences.
        for req in mid_prefill:
            if req.status is not RequestStatus.RUNNING or budget <= 0:
                continue
            chunk = self._chunk(req, budget)
            if chunk <= 0 or not self._ensure_pages(req, chunk):
                continue
            prefills.append(ScheduledSeq(req, chunk))
            scheduled.add(req.request_id)
            budget -= chunk

        # 3. Admit waiting sequences (priority order, FCFS within class).
        while self.waiting and budget > 0:
            req = self.waiting[0]
            if len(self.running) >= self.config.max_num_seqs:
                break
            if req.num_computed_tokens == 0:
                self._apply_prefix_cache(req)
            chunk = self._chunk(req, budget)
            if chunk <= 0:
                break
            if not self._ensure_ring(req):
                # Out of ring pages; retry next step. (The JAX scheduler
                # also takes a waiting preload's ring here; the port has no
                # preloads, and the rings of waiting hybrid hits go back
                # when a step would schedule nothing: ``schedule``.)
                break
            if not self._ensure_pages(req, chunk):
                # A waiting request keeps no ring it has computed nothing
                # into: held, it could stall an earlier arrival's
                # admission. A ring seeded by a hybrid hit stays.
                if req.swa_block_ids and req.num_computed_tokens == 0:
                    self._free_ring(req)
                break  # out of pages; retry next step
            self.waiting.pop(0)
            req.status = RequestStatus.RUNNING
            self.running.append(req)
            prefills.append(ScheduledSeq(req, chunk))
            scheduled.add(req.request_id)
            budget -= chunk

        return ScheduledBatch(prefills=prefills, decodes=decodes)

    def _chunk(self, req: Request, budget: int) -> int:
        """The prompt tokens ``req`` computes this step: what is left, at
        most the budget and, under the ring, ``swa_chunk_tokens``."""
        chunk = min(req.num_prompt_tokens - req.num_computed_tokens, budget)
        if self.swa_chunk_tokens:
            chunk = min(chunk, self.swa_chunk_tokens)
        return chunk

    def _apply_prefix_cache(self, req: Request) -> None:
        """Reuse cached full pages covering the prompt prefix."""
        if req.block_ids or self.swa_ring_pages:
            # Under the ring a bare hit would skip sliding-layer KV that no
            # ring holds, and the request would decode garbage: ring
            # engines take hybrid hits at arrival only.
            return
        # Never satisfy the *entire* prompt from cache: the last token must
        # be computed so the step emits logits for sampling.
        page = self.allocator.page_size
        cached = self.allocator.lookup_and_touch_prefix(
            req.prompt_token_ids, max_pages=(req.num_prompt_tokens - 1) // page
        )
        if not cached:
            return
        req.block_ids.extend(cached)
        n = len(cached)
        req.num_cached_tokens = n * page
        req.num_computed_tokens = req.num_cached_tokens
        parent = _ROOT_HASH
        for i in range(n):
            parent = hash_page(parent, req.prompt_token_ids[i * page : (i + 1) * page])
        self._chain[req.request_id] = (parent, n)

    def _ensure_ring(self, req: Request) -> bool:
        """Allocate the request's ring at admission (once). A failed
        allocation first frees retained sections (``ring_pressure_hook``):
        live sequences outrank retention."""
        if self.swa_allocator is None or req.swa_block_ids:
            return True
        while True:
            try:
                req.swa_block_ids = self.swa_allocator.allocate(self.swa_ring_pages)
                return True
            except NoFreePagesError:
                if self.ring_pressure_hook is None or not self.ring_pressure_hook():
                    return False

    def _drop_hold(self, req: Request) -> None:
        """A waiting request gives back what a prefix hit gave it (pages, a
        seeded ring) and will prefill from its first token."""
        self._release(req)
        req.num_computed_tokens = 0
        req.num_cached_tokens = 0

    def _free_ring(self, req: Request) -> None:
        self.swa_allocator.free(req.swa_block_ids)
        req.swa_block_ids = []
        req.swa_table_row = None

    def _ensure_pages(self, req: Request, new_tokens: int) -> bool:
        need_slots = req.num_computed_tokens + new_tokens
        missing = -(-need_slots // self.allocator.page_size) - len(req.block_ids)
        if missing <= 0:
            return True
        try:
            req.block_ids.extend(self.allocator.allocate(missing))
            return True
        except NoFreePagesError:
            return False

    def _preempt_for(self, req: Request | None, exclude: set[str] = frozenset()) -> bool:
        """Evict the youngest running sequence other than ``req`` (lowest
        priority first) to recompute later."""
        victims = [
            r for r in self.running
            if r is not req and r.request_id not in exclude
        ]
        if not victims:
            return False
        victim = max(victims, key=lambda r: (-r.priority, r.arrival_time))
        self._release(victim)
        self.running.remove(victim)
        # Fold generated tokens into the prompt and restart from scratch.
        victim.num_prior_output_tokens += len(victim.output_token_ids)
        victim.prompt_token_ids = victim.all_token_ids
        victim.output_token_ids = []
        self.num_preemptions += 1
        victim.num_computed_tokens = 0
        victim.num_cached_tokens = 0
        victim.status = RequestStatus.PREEMPTED
        # insort keeps the victim FCFS-ordered by its original arrival time
        # within its priority class, so it resumes ahead of newer arrivals.
        bisect.insort(self.waiting, victim, key=_queue_key)
        return True

    def _release(self, req: Request) -> None:
        if req.block_ids:
            self.allocator.free(req.block_ids)
            req.block_ids = []
        if req.swa_block_ids:
            self._free_ring(req)
        self._chain.pop(req.request_id, None)

    def seed_commit_chain(self, req: Request, parent: bytes, committed: int) -> None:
        """Mark ``req``'s first ``committed`` pages as already in the prefix
        index, ``parent`` the chain's tail (a hybrid hit's): they are not
        hashed and committed again."""
        self._chain[req.request_id] = (parent, committed)

    # ------------------------------------------------------------------ #
    # post-step bookkeeping

    def update_after_step(
        self, batch: ScheduledBatch, sampled: dict[str, list[int]]
    ) -> dict[str, list[int]]:
        """Advance state after the device step. ``sampled`` maps request id
        -> the window of sampled tokens (length 1 for prefill and one-step
        rows, K for a fused decode window). Tokens past a stop condition
        are discarded: their KV sits in pages that are freed with the
        request and never committed to the prefix cache. Returns the
        tokens accepted per request."""
        accepted: dict[str, list[int]] = {}
        for seq in batch.prefills:
            req = seq.request
            req.num_computed_tokens += seq.num_tokens
            if req.in_decode:  # this chunk completed the prompt -> 1st token
                if self.prefill_complete_hook is not None:
                    # The ring still holds the prompt's last window now.
                    self.prefill_complete_hook(req)
                token = sampled[req.request_id][0]
                req.output_token_ids.append(token)
                accepted[req.request_id] = [token]
                reason = self._check_stop(req, token)
                if reason is not None:
                    self._finish(req, reason)
                    continue
            self._commit_full_pages(req)
        for seq in batch.decodes:
            req = seq.request
            acc: list[int] = []
            reason = None
            for token in sampled[req.request_id]:
                req.num_computed_tokens += 1
                req.output_token_ids.append(token)
                acc.append(token)
                reason = self._check_stop(req, token)
                if reason is not None:
                    break
            accepted[req.request_id] = acc
            if reason is not None:
                self._finish(req, reason)
            else:
                self._commit_full_pages(req)
        return accepted

    def _finish(self, req: Request, reason: FinishReason) -> None:
        # Commit computed full pages before release: the KV is valid, so
        # future identical prompts can reuse it.
        self._commit_full_pages(req)
        self._release(req)
        self.running.remove(req)
        req.finish(reason)

    def _check_stop(self, req: Request, token: int) -> FinishReason | None:
        s = req.sampling
        if not s.ignore_eos and token in s.stop_token_ids:
            return FinishReason.STOP
        if req.total_output_tokens >= s.max_tokens:
            return FinishReason.LENGTH
        if req.num_tokens >= self.max_model_len:
            return FinishReason.LENGTH
        return None

    def _commit_full_pages(self, req: Request) -> None:
        """Register newly-completed full pages in the prefix index."""
        if not self.allocator.enable_prefix_caching:
            return
        page = self.allocator.page_size
        parent, committed = self._chain.get(req.request_id, (_ROOT_HASH, 0))
        # Only KV already computed counts; the just-sampled token's KV is
        # written when it is fed as input next step.
        full = req.num_computed_tokens // page
        tokens = req.all_token_ids
        while committed < full:
            h = hash_page(parent, tokens[committed * page : (committed + 1) * page])
            self.allocator.commit_page(req.block_ids[committed], h)
            parent = h
            committed += 1
        self._chain[req.request_id] = (parent, committed)
