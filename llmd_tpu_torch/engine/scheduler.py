"""Continuous-batching scheduler with chunked prefill and prefix caching.

The port of ``llmd_tpu/engine/scheduler.py:EngineScheduler.schedule``:
every engine step selects a token budget's worth of
work — one token per running decode sequence, then prompt chunks for
sequences mid-prefill, then admissions from the waiting queue (chunked
prefill, so long prompts never starve decodes; with
``enable_chunked_prefill`` off a prompt is admitted only whole). Preemption is
recompute-style: when KV pages run out, the youngest running sequence is
evicted, its pages freed, and it restarts from the waiting queue with its
generated tokens folded into the prompt.

With ``decode_window > 1`` a step that cannot make admission progress (no
admissible waiting request, no prompt chunk in flight) schedules every
decode row for a fused window of K tokens: pages for all K are claimed
before dispatch, and ``update_after_step`` appends the window's tokens one
by one, ending the row at the first stop condition.

All position math plans against ``Request.num_dispatched_tokens`` (the
committed tokens plus those in flight), so one code path serves both
engines. The synchronous engine marks a step dispatched (``note_dispatch``)
and commits it (``update_after_step``) back to back, so nothing is ever
pending there. Under async stepping the next step is scheduled while the
dispatched one runs: each in-flight row is assumed to land its tokens, and
the in-flight sequences (``protected``) are never preempted, since the
device still writes their pages.

Under the sliding-window ring (``CacheConfig.swa_ring``) an admitted
sequence also holds a ring of ``swa_ring_pages`` pages in the ring pool
(``_ensure_ring``), a prefill chunk is capped at ``swa_chunk_tokens``
(the span the ring is sized for), and a bare prefix-cache hit is never
taken: the engine takes hybrid hits at arrival instead
(``LLMEngine._try_hybrid_ring_hit``).

Under speculative decoding (``SchedulerConfig.speculative_ngram``; JAX
``scheduler.py:266-363, 792-946``) a decode row is planned at its
max-acceptance width: ``1 + k`` tokens for a one-shot verify row, ``window
x (1 + k)`` in a fused verify window, whose size is the largest of
``spec_window_set`` that fits the budget. Budget, pages and the pending
count follow that width; the engine proposes the draft at dispatch from
committed tokens. ``update_after_step`` resolves the accepted prefix
(``accept_draft_tokens``, or the device's meta for a window), counts it,
and frees the pages past the accepted span before any page is committed
(``_truncate_spec_pages``), so rejected drafts never reach the prefix
index. Rows whose drafts were fully rejected back off
(``_spec_eligible``).

The batch tier (``SchedulerConfig.batch_backfill``; JAX
``scheduler.py:236-260, 397-560``): rows at or below
``PriorityClass.BATCH`` are split out of the interactive phases, which
never see them, and backfill the budget and pages those phases leave:
running batch decodes at one token a step (draft-less under speculative
decoding, never in a window; a step that carries batch rows pins K to 1),
then their prefill chunks, then new batch admissions while no interactive
request waits at the queue head, the main pool's used share is at or below
``batch_kv_watermark`` and ``batch_max_seqs`` has room. An interactive
admission blocked on a slot or on pages takes them from running batch rows
first (recompute preemption, youngest first); page pressure inside the band
preempts batch rows only. So interactive rows are scheduled as in an
engine without the batch rows: in f32 their streams are the same token for
token; in bf16 on the card a step's size moves the attention kernel's
spans, and a stream may part at a tie.
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
from llmd_tpu_torch.engine.sampler import accept_draft_tokens


@dataclasses.dataclass
class ScheduledSeq:
    request: Request
    num_tokens: int  # tokens to compute for this seq in this step
    # Speculative decoding: None for a row of an engine without it; the
    # draft (maybe empty) of a decode row, proposed at dispatch. The row
    # is planned at its max-acceptance width (``num_tokens``).
    draft_tokens: list[int] | None = None
    # Fused verify windows: the most draft tokens the row may propose
    # (None: ``num_tokens - 1``, the one-shot width; 0: a backed-off row
    # that rides the window one token an iteration).
    spec_draft_cap: int | None = None
    # Fused verify windows: the device's (emitted, drafted, accepted,
    # iterations active) of the row, set from the readback before
    # ``update_after_step``; the host does not apply the rule again.
    device_accept: tuple | None = None

    @property
    def start_pos(self) -> int:
        return self.request.num_computed_tokens


@dataclasses.dataclass
class ScheduledBatch:
    prefills: list[ScheduledSeq]
    decodes: list[ScheduledSeq]
    # The fused verify window of the decode rows (1: one-shot verify or
    # plain decode).
    spec_window: int = 1

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
        # Called with a finishing request while its pages are live (the P/D
        # producer's export).
        self.finish_hook = None
        self.prefill_complete_hook = None
        self.ring_pressure_hook = None
        # The decode pager (``engine/pager.py``): called with a preemption
        # victim before its pages are released; returns the tokens it kept
        # in the host tier (the victim resumes from there), or 0 for a
        # plain recompute preemption.
        self.park_hook = None
        # Ordered by (-priority, arrival_time): higher priority first, FCFS
        # within a priority class.
        self.waiting: list[Request] = []
        self.running: list[Request] = []
        self.num_preemptions = 0
        # request_id -> (committed page hash chain tail, committed pages)
        self._chain: dict[str, tuple[bytes, int]] = {}
        # Async stepping: the request ids of the in-flight step. Their pages
        # are still being written on the device, so no preemption picks
        # them. Empty in the synchronous engine between steps.
        self.protected: set[str] = set()
        # Speculative decoding: the draft width k (0: off), the window
        # sizes, the widest planned row (the async truncation's bound), the
        # counters and the accepted-length histogram (index j: row-steps
        # that accepted j draft tokens), and the backoff clock.
        self.spec_k = scheduler_config.spec_ngram_k if scheduler_config.speculative_ngram else 0
        self.spec_windows = scheduler_config.spec_window_set
        self.spec_plan_max = (1 + self.spec_k) * scheduler_config.spec_window if self.spec_k else 0
        self.spec_proposed_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_window_iters = 0
        self.spec_window_early_exit = 0
        self.spec_accept_len_hist = [0] * (self.spec_k + 1)
        self.spec_step = 0
        # The batch tier's counters: batch tokens computed, batch rows
        # preempted, and the batch tokens the last ``schedule`` planned
        # (the backfill-utilization gauge's numerator).
        self.batch_tokens = 0
        self.num_batch_preemptions = 0
        self.last_batch_backfill_tokens = 0

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

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------------ #
    # scheduling

    def schedule(self) -> ScheduledBatch:
        """Select the next batch. A step that schedules nothing while work
        remains changes nothing, so the engine would spin: every running
        sequence waits for pages that waiting requests hold (prefix hits
        taken by a failed admission, hybrid hits, a parked request's
        restored window) or other running prefills hold. Then the waiting
        requests' pages and rings are released (they prefill later; a
        parked one recomputes), and if that is not enough, the youngest
        running sequences are preempted one at a time (parked, where the
        pager is on: ``_preempt_for``). Not while
        a step is in flight: its commit changes what the next step can
        take, and the engine schedules again once nothing is in flight."""
        batch = self._schedule()
        if batch.is_empty and self.has_work() and not self.protected:
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

        decoding = [r for r in self.running if r.in_decode_dispatched]
        mid_prefill = [r for r in self.running if not r.in_decode_dispatched]
        # The batch band's rows leave the interactive phases, which never
        # see them, and backfill what those phases leave (phase 4).
        batch_decoding: list[Request] = []
        batch_prefill: list[Request] = []
        if self._batch_band:
            batch_decoding = [r for r in decoding if r.is_batch]
            batch_prefill = [r for r in mid_prefill if r.is_batch]
            if batch_decoding:
                decoding = [r for r in decoding if not r.is_batch]
            if batch_prefill:
                mid_prefill = [r for r in mid_prefill if not r.is_batch]
        in_backfill = bool(batch_decoding or batch_prefill)

        # Fused K-step decode windows apply whenever this step cannot make
        # admission progress anyway (nothing admissible waiting, no prompt
        # chunks in flight), in particular in the saturated regime, where
        # spreading the dispatch over K tokens pays most. Otherwise K = 1
        # keeps admission latency at one step. K is uniform across the
        # batch and capped so no sequence runs past max_model_len. A step
        # that carries batch rows pins K to 1: they ride at one token, and
        # one dispatch cannot mix widths.
        can_admit = bool(self.waiting) and len(self.running) < self.config.max_num_seqs
        gate = bool(decoding) and not mid_prefill and not can_admit and not in_backfill
        k = 1
        spec_w = 1
        if self.spec_k:
            # The fused verify window under the same gate: the largest
            # candidate whose max-acceptance width, window x (1 + k) a
            # row, fits the whole decode batch in the budget; none fitting
            # means one-shot verify steps.
            if self.spec_windows and gate:
                per_batch = (1 + self.spec_k) * len(decoding)
                for w in reversed(self.spec_windows):
                    if w * per_batch <= budget:
                        spec_w = w
                        break
        elif self.config.decode_window > 1 and gate:
            room = min(self.max_model_len - r.num_dispatched_tokens for r in decoding)
            k = max(1, min(self.config.decode_window, room))
        if self.spec_k and decoding:
            self.spec_step += 1

        # 1. Decodes claim pages FIRST: a running decode must never be
        #    starved by prefill admission taking the last free pages.
        for req in decoding:
            if req.status is not RequestStatus.RUNNING:
                continue  # reset by a preemption earlier in this loop
            if budget <= 0:
                break
            k_row, draft_cap = self._plan_width(req, k, spec_w)
            if not self._ensure_pages(req, k_row):
                # Never evict a sequence already placed in this step's
                # batch: the runner still writes its pages.
                if not self._preempt_for(req, exclude=scheduled):
                    continue
                if not self._ensure_pages(req, k_row):
                    continue
            decodes.append(ScheduledSeq(
                req, k_row, draft_tokens=[] if self.spec_k else None, spec_draft_cap=draft_cap))
            scheduled.add(req.request_id)
            # Drafted positions are compute of the step: speculative rows
            # charge their planned width.
            budget -= k_row if self.spec_k else 1

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
        #    Interactive only: a batch head waits for phase 4, and an
        #    interactive head short of a slot or of pages takes them from
        #    running batch rows first.
        while self.waiting and budget > 0:
            req = self.waiting[0]
            if req.kv_fetch_pending:
                # Parked by the pager, its window not back on the device
                # yet: a wait, not a fault. The pager retries the restore
                # each step; admission stays FCFS behind it.
                break
            if self._batch_band and req.is_batch:
                break
            if len(self.running) >= self.config.max_num_seqs:
                if not (self._batch_band
                        and self._preempt_for(req, exclude=scheduled, batch_only=True)):
                    break
                continue
            if req.num_computed_tokens == 0:
                self._apply_prefix_cache(req)
            chunk = self._chunk(req, budget)
            if chunk <= 0:
                break
            if (not self.config.enable_chunked_prefill
                    and chunk < req.num_prompt_tokens - req.num_dispatched_tokens):
                break  # whole-prompt admission only
            if not self._ensure_ring(req):
                # Out of ring pages; retry next step. (The JAX scheduler
                # also takes a waiting preload's ring here; the port has no
                # preloads, and the rings of waiting hybrid hits go back
                # when a step would schedule nothing: ``schedule``.)
                break
            if not self._ensure_pages_reclaiming_batch(req, chunk, scheduled):
                # A waiting request keeps no ring it has computed nothing
                # into: held, it could stall an earlier arrival's
                # admission. A ring seeded by a hybrid hit stays.
                if req.swa_block_ids and req.num_computed_tokens == 0:
                    self._free_ring(req)
                break  # out of pages; retry next step
            self._admit(req, chunk, prefills, scheduled)
            budget -= chunk

        # 4. The batch band backfills what the interactive phases left.
        if self._batch_band and budget > 0:
            budget = self._schedule_batch_backfill(
                batch_decoding, batch_prefill, decodes, prefills, scheduled, budget)
        self.last_batch_backfill_tokens = sum(
            s.num_tokens for s in (*prefills, *decodes) if s.request.is_batch)
        return ScheduledBatch(prefills=prefills, decodes=decodes, spec_window=spec_w)

    @property
    def _batch_band(self) -> bool:
        return self.config.batch_backfill

    def _admit(self, req: Request, chunk: int, prefills: list[ScheduledSeq],
               scheduled: set[str]) -> None:
        """Move the waiting head ``req`` to running with its first chunk."""
        self.waiting.pop(0)
        req.status = RequestStatus.RUNNING
        self.running.append(req)
        prefills.append(ScheduledSeq(req, chunk))
        scheduled.add(req.request_id)

    def _ensure_pages_reclaiming_batch(self, req: Request, new_tokens: int,
                                       exclude: set[str]) -> bool:
        """``_ensure_pages`` for an interactive request, preempting running
        batch rows (youngest first) until the pages fit or no batch row is
        left to take them from."""
        while not self._ensure_pages(req, new_tokens):
            if not (self._batch_band
                    and self._preempt_for(req, exclude=exclude, batch_only=True)):
                return False
        return True

    def _schedule_batch_backfill(self, batch_decoding: list[Request],
                                 batch_prefill: list[Request], decodes: list[ScheduledSeq],
                                 prefills: list[ScheduledSeq], scheduled: set[str],
                                 budget: int) -> int:
        """The batch band's step, after the interactive phases (JAX
        ``_schedule_batch_backfill``): running batch decodes at one token
        (draft-less under speculative decoding: cap 0, so no verify column
        is planned for them), then their prefill chunks, then new batch
        rows while the queue head is a batch request, a slot is free, the
        pool's used share is at or below ``batch_kv_watermark`` and
        ``batch_max_seqs`` has room. Page pressure here preempts batch rows
        only. Returns the budget left."""
        for req in batch_decoding:
            if req.status is not RequestStatus.RUNNING or not req.in_decode_dispatched:
                continue  # reset by a preemption earlier in this pass
            if budget <= 0:
                break
            if not self._ensure_pages(req, 1):
                if not self._preempt_for(req, exclude=scheduled, batch_only=True):
                    continue
                if not self._ensure_pages(req, 1):
                    continue
            decodes.append(ScheduledSeq(
                req, 1, draft_tokens=[] if self.spec_k else None,
                spec_draft_cap=0 if self.spec_k else None))
            scheduled.add(req.request_id)
            budget -= 1
        for req in batch_prefill:
            if req.status is not RequestStatus.RUNNING or budget <= 0:
                continue
            chunk = self._chunk(req, budget)
            if chunk <= 0 or not self._ensure_pages(req, chunk):
                continue  # waits for room: batch never preempts upward
            prefills.append(ScheduledSeq(req, chunk))
            scheduled.add(req.request_id)
            budget -= chunk
        while (self.waiting and budget > 0
               and len(self.running) < self.config.max_num_seqs
               and self.waiting[0].is_batch and not self.waiting[0].kv_fetch_pending):
            if (self.config.batch_max_seqs
                    and sum(1 for r in self.running if r.is_batch) >= self.config.batch_max_seqs):
                break
            if self.allocator.usage() > self.config.batch_kv_watermark:
                break  # the pool is too full to take more batch rows
            req = self.waiting[0]
            if req.num_computed_tokens == 0:
                self._apply_prefix_cache(req)
            chunk = self._chunk(req, budget)
            if chunk <= 0:
                break
            if (not self.config.enable_chunked_prefill
                    and chunk < req.num_prompt_tokens - req.num_dispatched_tokens):
                break  # whole-prompt admission only
            if not self._ensure_ring(req):
                break  # rings are interactive capacity: never reclaimed
            if not self._ensure_pages(req, chunk):
                if req.swa_block_ids and req.num_computed_tokens == 0:
                    self._free_ring(req)
                break  # out of pages; retry next step
            self._admit(req, chunk, prefills, scheduled)
            budget -= chunk
        return budget

    def _plan_width(self, req: Request, k: int, spec_w: int) -> tuple[int, int | None]:
        """A decode row's planned width and draft cap. Without speculative
        decoding: the decode window K. A one-shot verify row plans 1 + k
        (1 when backed off); in a fused verify window an eligible row plans
        window x (1 + k) and may pre-draft one less (a fully accepted
        iteration consumes k scored columns and the bonus slot), and a
        backed-off row rides the window one token an iteration, without a
        draft. Every width stops at ``max_model_len``."""
        if not self.spec_k:
            return k, None
        cap = self.max_model_len - req.num_dispatched_tokens
        if spec_w > 1:
            if self._spec_eligible(req):
                k_row = max(1, min(spec_w * (1 + self.spec_k), cap))
                return k_row, k_row - 1
            return max(1, min(spec_w, cap)), 0
        k_row = 1
        if self._spec_eligible(req):
            k_row += max(0, min(self.spec_k, cap - 1))
        return k_row, None

    def _chunk(self, req: Request, budget: int) -> int:
        """The prompt tokens ``req`` computes this step: what is left, at
        most the budget and, under the ring, ``swa_chunk_tokens``."""
        chunk = min(req.num_prompt_tokens - req.num_dispatched_tokens, budget)
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
        extra = self.hash_extra(req)
        cached = self.allocator.lookup_and_touch_prefix(
            req.prompt_token_ids, max_pages=(req.num_prompt_tokens - 1) // page, extra=extra
        )
        if not cached:
            return
        req.block_ids.extend(cached)
        n = len(cached)
        req.num_cached_tokens = n * page
        req.num_computed_tokens = req.num_cached_tokens
        parent = _ROOT_HASH
        for i in range(n):
            parent = hash_page(parent, req.prompt_token_ids[i * page : (i + 1) * page], extra)
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
        # From the dispatched position: in-flight tokens own their slots.
        need_slots = req.num_dispatched_tokens + new_tokens
        missing = -(-need_slots // self.allocator.page_size) - len(req.block_ids)
        if missing <= 0:
            return True
        try:
            req.block_ids.extend(self.allocator.allocate(missing))
            return True
        except NoFreePagesError:
            return False

    def _preempt_for(self, req: Request | None, exclude: set[str] = frozenset(),
                     batch_only: bool = False) -> bool:
        """Evict the youngest running sequence other than ``req`` (lowest
        priority first, so batch rows before any interactive row) to
        recompute later; ``batch_only`` takes batch rows only. In-flight
        sequences (``protected``) are never victims: the device still
        writes their pages, and a preemption frees them at once."""
        victims = [
            r for r in self.running
            if r is not req and r.request_id not in exclude
            and r.request_id not in self.protected
            and (not batch_only or r.is_batch)
        ]
        if not victims:
            return False
        victim = max(victims, key=lambda r: (-r.priority, r.arrival_time))
        if victim.is_batch:
            self.num_batch_preemptions += 1
        kept = self.park_hook(victim) if self.park_hook is not None else 0
        if kept:
            # Parked: the pager put the computed KV in the host tier and
            # freed the pages; the victim resumes from there.
            victim.num_pending_tokens = 0
            self.protected.discard(victim.request_id)
        else:
            self._release(victim)
        self.running.remove(victim)
        # Fold generated tokens into the prompt and restart from scratch
        # (or, parked, from the pager's kept prefix).
        victim.num_prior_output_tokens += len(victim.output_token_ids)
        victim.prompt_token_ids = victim.all_token_ids
        victim.output_token_ids = []
        self.num_preemptions += 1
        victim.num_computed_tokens = kept
        victim.num_cached_tokens = kept
        victim.status = RequestStatus.PREEMPTED
        # insort keeps the victim FCFS-ordered by its original arrival time
        # within its priority class, so it resumes ahead of newer arrivals.
        bisect.insort(self.waiting, victim, key=_queue_key)
        return True

    def _release(self, req: Request) -> None:
        req.num_pending_tokens = 0
        self.protected.discard(req.request_id)
        if req.block_ids:
            # A paged-out index holds a stale id: the pager freed that page
            # when it spilled it, and another sequence may own it now.
            ids = [b for i, b in enumerate(req.block_ids) if i not in req.paged_out]
            if ids:
                self.allocator.free(ids)
            req.block_ids = []
        req.paged_out.clear()
        req.kv_fetch_pending = False
        if req.swa_block_ids:
            self._free_ring(req)
        self._chain.pop(req.request_id, None)

    def seed_commit_chain(self, req: Request, parent: bytes, committed: int) -> None:
        """Mark ``req``'s first ``committed`` pages as already in the prefix
        index, ``parent`` the chain's tail (a hybrid hit's, or the last page
        the pager spilled or parked): they are not hashed and committed
        again."""
        self._chain[req.request_id] = (parent, committed)

    def commit_chain_state(self, req: Request) -> tuple[bytes, int]:
        """(chain tail, committed pages) of ``req``: the pager seeds the
        chain past a spilled range only where it is not already further."""
        return self._chain.get(req.request_id, (_ROOT_HASH, 0))

    @staticmethod
    def hash_extra(req: Request) -> bytes:
        """The page-hash salt of ``req`` (JAX ``_hash_extra``): an adapter
        row's KV (v carries the adapter) is never shared with the base
        model or another adapter. By name (stable across processes, and
        the router folds ``lora:<model>``); a row with a slot and no name
        in a namespace of its own, so that a digit-only name never meets
        a slot id."""
        if not req.lora_id:
            return b""
        if req.lora_name:
            return f"lora:{req.lora_name}".encode()
        return f"lora-slot:{req.lora_id}".encode()

    # ------------------------------------------------------------------ #
    # post-step bookkeeping

    def note_dispatch(self, batch: ScheduledBatch) -> None:
        """Mark a dispatched batch's tokens as in flight: until the readback
        commits them (``update_after_step``), scheduling plans against the
        dispatched positions and the sequences are protected from
        preemption. The synchronous engine calls both back to back."""
        for seq in batch.seqs:
            seq.request.num_pending_tokens += seq.num_tokens
            self.protected.add(seq.request.request_id)

    def _commit_pending(self, seq: ScheduledSeq) -> None:
        req = seq.request
        req.num_pending_tokens = max(0, req.num_pending_tokens - seq.num_tokens)
        self.protected.discard(req.request_id)

    def forget_pending(self, seqs: list[ScheduledSeq]) -> None:
        """Drop a dispatched step whose readback will never be committed
        (the step failed): its tokens are no longer pending and its
        sequences no longer protected."""
        for seq in seqs:
            self._commit_pending(seq)

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
            self._commit_pending(seq)
            req.num_computed_tokens += seq.num_tokens
            if req.is_batch:
                self.batch_tokens += seq.num_tokens
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
            self._commit_pending(seq)
            window = sampled[req.request_id]
            if seq.device_accept is not None:
                self._count_window(req, seq.device_accept, batch.spec_window)
            elif seq.draft_tokens:
                # One-shot verify: the accepted prefix and the correction
                # or bonus sample, then the stop checks below.
                window, n_acc = accept_draft_tokens(seq.draft_tokens, window)
                self.spec_proposed_tokens += len(seq.draft_tokens)
                self.spec_accepted_tokens += n_acc
                self.spec_accept_len_hist[n_acc] += 1
                req.spec_drafted_tokens += len(seq.draft_tokens)
                req.spec_accepted_tokens += n_acc
                # A fully rejected draft backs the row off (``_spec_eligible``).
                req.spec_consec_rejected = req.spec_consec_rejected + 1 if n_acc == 0 else 0
            elif seq.draft_tokens is not None:
                # A speculative row that drafted nothing: plain samples, one
                # an iteration of a window that fell back to plain decode.
                self.spec_accept_len_hist[0] += len(window) if batch.spec_window > 1 else 1
            acc: list[int] = []
            reason = None
            for token in window:
                req.num_computed_tokens += 1
                req.output_token_ids.append(token)
                acc.append(token)
                reason = self._check_stop(req, token)
                if reason is not None:
                    break
            accepted[req.request_id] = acc
            if req.is_batch:
                self.batch_tokens += len(acc)
            if reason is not None:
                self._finish(req, reason)
            else:
                self._commit_full_pages(req)
                if seq.draft_tokens or (batch.spec_window > 1 and seq.draft_tokens is not None):
                    # Drafting rows wrote provisional KV, and windowed rows
                    # planned pages for a width they may not have emitted.
                    # A draft-less one-shot row holds at most one page of
                    # headroom, which its next step reuses.
                    self._truncate_spec_pages(req)
        return accepted

    def _count_window(self, req: Request, meta: tuple, window: int) -> None:
        """Fold a fused verify window's device-resolved meta (emitted,
        drafted, accepted, iterations active) into the counters the
        one-shot path feeds. The per-iteration accepted lengths stay on the
        device: the histogram gets ``iters`` entries summing to the
        accepted count (full-k entries, one remainder, zeros), so its mean
        is exact."""
        _emitted, drafted, n_acc, iters = meta
        self.spec_proposed_tokens += drafted
        self.spec_accepted_tokens += n_acc
        req.spec_drafted_tokens += drafted
        req.spec_accepted_tokens += n_acc
        self.spec_window_iters += iters
        if iters < window:
            self.spec_window_early_exit += 1
        if iters > 0:
            full, part = divmod(n_acc, self.spec_k)
            self.spec_accept_len_hist[self.spec_k] += full
            used = full
            if part:
                self.spec_accept_len_hist[part] += 1
                used += 1
            self.spec_accept_len_hist[0] += max(0, iters - used)
        if drafted and n_acc == 0:
            req.spec_consec_rejected += 1
        elif n_acc > 0:
            req.spec_consec_rejected = 0

    def _spec_eligible(self, req: Request) -> bool:
        """Draft backoff: after c fully rejected drafts in a row a request
        drafts only on steps where the shared clock is a multiple of
        2**min(c + 1, 8), so retries of many rows fall on the same steps.
        One accepted token resets it."""
        c = req.spec_consec_rejected
        return c == 0 or self.spec_step % (1 << min(c + 1, 8)) == 0

    def _truncate_spec_pages(self, req: Request) -> None:
        """Free the pages a speculative row holds past its accepted span.
        Rejected drafts' KV sits in slots >= ``num_computed_tokens``, which
        ``_commit_full_pages`` never commits; freeing the trailing pages
        before any commit keeps rejected content out of the prefix index.
        Under async stepping the slots a staged next step may be planned
        against stay: up to ``num_dispatched_tokens + spec_plan_max``. The
        synchronous engine keeps the computed span; the next schedule's
        ``_ensure_pages`` extends it again."""
        page = self.allocator.page_size
        slots = req.num_computed_tokens
        if self.config.async_scheduling:
            slots = req.num_dispatched_tokens + self.spec_plan_max
        keep = -(-slots // page)
        if keep < len(req.block_ids):
            self.allocator.free(req.block_ids[keep:])
            del req.block_ids[keep:]

    def _finish(self, req: Request, reason: FinishReason) -> None:
        # Commit computed full pages before release: the KV is valid, so
        # future identical prompts (and P/D exports) can reuse it.
        self._commit_full_pages(req)
        if self.finish_hook is not None:
            self.finish_hook(req)
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
        if committed >= full:
            return
        tokens = req.all_token_ids
        extra = self.hash_extra(req)
        while committed < full:
            chunk = tokens[committed * page : (committed + 1) * page]
            h = hash_page(parent, chunk, extra)
            self.allocator.commit_page(req.block_ids[committed], h, chunk, parent)
            parent = h
            committed += 1
        self._chain[req.request_id] = (parent, committed)
