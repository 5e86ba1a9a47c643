"""LLMEngine: scheduler + page allocator + model runner.

Keeps the JAX engine's public API (``add_request``, ``step``,
``generate``, ``abort_request``, ``has_work``), its synchronous step
(``llmd_tpu/engine/engine.py:_step_sync``) and, with
``SchedulerConfig.async_scheduling``, its two-slot pipeline
(``_step_async``): while step N runs on the device, step N+1 is scheduled
against the dispatched positions and staged; then the engine blocks on
N's readback, commits it, rolls back the staged rows of sequences that
finished in N, dispatches N+1, and assembles N's outputs while N+1 runs.
The pipeline changes when host work happens, never what the engine emits;
outputs arrive one step later. A step that is eligible runs as
one unified program (the flat step over the packed token stream, or the
bucketed ``[B, Q]`` program without ``ragged_qlens``); otherwise its
prefill chunks go out as Q-bucket groups and its decode rows as one fused
window of K iterations (the split engine, and every engine whose
scheduler picked ``K > 1``). Either way the step ends in one host
readback, and a decode row's output carries up to K tokens.

Under the sliding-window ring (``CacheConfig.swa_ring``; JAX
``engine.py:390-518``) the engine owns a second page allocator for the
ring pool and, with prefix caching on, the retained sliding-window
sections of ``SwaSectionCache``: prefix caching becomes hybrid, a hit is
taken at arrival and only where a retained section can seed the fresh
ring (``_try_hybrid_ring_hit``). The ring is refused without chunked
prefill and beside tiered offload, as in JAX.

Tiered offload (``EngineConfig.offload``; JAX ``engine.py:432-470,
562-571, 878-883``): ``kvtransfer/offload.py``'s host cache and
connector. Every page committed to the prefix cache is saved to the host
tier after its step (the synchronous engine gathers and copies it after
the commit; the async engine enqueues the gather before it dispatches the
next step and puts the pages in the host cache while that step runs, so a
page reused by the next step is gathered before it is overwritten), and
``add_request`` restores the host pages that extend a prompt's device
prefix run before the request is queued. With ``offload.store_master_url``
the cross-slice store is the tier behind them: the engine's store client
(``kvstore/``) and ``KVFederation`` (``federation/``) publish pages and
fetch the ones no local tier holds.

KV events (JAX ``engine.py:461-470``): the allocator tells ``event_sink``
(the server's ``events.ZMQEventSink``, or one that drops them) of each page
stored, each cached page evicted and each clear; with offload the sink is
wrapped in ``TieredEventSink`` (a device eviction of a page a host tier
holds is a ``cpu`` store), and the federation announces its accepted
publications and withdrawals to the sink it wraps (medium ``store``).

The batch tier (``SchedulerConfig.batch_backfill``, ``Request.is_batch``)
is the scheduler's; the engine reports its counters (``batch_*``).

P/D disaggregation (``EngineConfig.kv_role``; JAX ``engine.py:604-702,
842-925, 1314-1425``): ``kvtransfer/connector.py``'s connector. A
producer exports a finished request's prompt pages in the scheduler's
finish hook, before the pages are released, and its answer carries the
transfer params; a step whose prefills are all export-only (one token,
``do_remote_decode``) answers without reading their tokens back
(eager-ACK), and async stepping is off for a producer. A consumer imports
at ``add_request``: the bundle seeds the prefix cache, or under the ring
the pages and a fresh ring go to the request; a group-streamed import
parks the request until the stream resolves (``_admit_kv_streams``).

Under speculative decoding (``SchedulerConfig.speculative_ngram``; JAX
``engine.py:1600-1850``) the engine proposes every decode row's draft at
dispatch, from committed tokens only (``_propose_drafts``), so async
staging plans widths and the drafts come after the previous step's
commit. A window-1 step with drafts rides the flat step or the bucketed
unified step as verify rows; a decode-only step of the split or bucketed
engine runs the one-shot verify program, the plain one-token program (no
row drafted) or both (``dispatch_spec_split``); a step the scheduler gave
a verify window runs the fused verify window, or the plain decode window
at its depth where no row drafted.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import time
import uuid

import numpy as np
import torch

from llmd_tpu_torch import faults
from llmd_tpu_torch.config import EngineConfig, swa_ring_spec
from llmd_tpu_torch.engine.kv_cache import (
    KVEventSink,
    NoFreePagesError,
    PageAllocator,
    page_hashes_for_tokens,
)
from llmd_tpu_torch.engine.request import (
    Request,
    RequestOutput,
    RequestStatus,
    SamplingParams,
)
from llmd_tpu_torch.engine.runner import (
    ModelRunner,
    PendingDecode,
    PendingPrefill,
    PendingUnified,
    StagedDecode,
    StagedUnified,
    StagedVerify,
    StagedVerifyWindow,
    StepResult,
    resolve_device,
)
from llmd_tpu_torch.engine.scheduler import (
    EngineScheduler,
    ScheduledBatch,
    ScheduledSeq,
)
from llmd_tpu_torch.engine.spec import NgramProposer

# What the async pipeline stages ahead of a dispatch.
Staged = StagedUnified | StagedDecode | StagedVerify | StagedVerifyWindow


class SwaSectionCache:
    """Retained sliding-window sections: hybrid prefix caching under the
    ring (JAX ``engine.py:47 SwaSectionCache``).

    A ring's pages belong to one sequence, so a bare main-pool prefix hit
    would skip sliding-layer KV that no longer exists. This cache keeps,
    for recently prefilled prefixes, a copy of the ring's in-window
    section (logical pages ``[s0, n_pre)``, ``SwaRingSpec.section``) in
    ring-pool pages it holds. A repeated prefix seeds a fresh ring from
    its section on the device and starts at ``n_pre * page`` tokens.
    LRU by entries and by a page budget; an entry frees its pages when
    evicted."""

    def __init__(self, swa_allocator: PageAllocator, runner, capacity: int,
                 page_budget: int) -> None:
        self._alloc = swa_allocator
        self._runner = runner
        self.capacity = capacity
        # Retention pages are provisioned beside the rings (the engine adds
        # them to the ring pool); the budget keeps retention from eating
        # ring capacity even for a moment.
        self.page_budget = page_budget
        self.retained_pages = 0
        # key -> (s0, n_pre, section page ids)
        self._entries: collections.OrderedDict[bytes, tuple[int, int, list[int]]] = (
            collections.OrderedDict())
        self.hits = 0
        self.captures = 0

    def capture(self, key: bytes, ring_ids: list[int], s0: int, n_pre: int) -> None:
        """Copy ring slots ``[s0, n_pre)`` into retained pages on the
        device. Nothing happens if the key is retained already or the ring
        pool has no room (a ring allocation must never fail because
        retention holds pages)."""
        if key in self._entries or n_pre <= s0:
            return
        cnt = n_pre - s0
        while self._entries and (len(self._entries) >= self.capacity
                                 or self.retained_pages + cnt > self.page_budget):
            self.evict_one()
        if self.retained_pages + cnt > self.page_budget:
            return  # one section larger than the budget
        try:
            dst = self._alloc.allocate(cnt)
        except NoFreePagesError:
            return
        R = len(ring_ids)
        try:
            self._runner.copy_ring_pages([ring_ids[l % R] for l in range(s0, n_pre)], dst)
        except BaseException:
            self._alloc.free(dst)  # or the pool shrinks at every failed capture
            raise
        self.retained_pages += cnt
        self._entries[key] = (s0, n_pre, dst)
        self.captures += 1

    def evict_one(self) -> bool:
        """Free the least recently used section (ring pressure: a live
        sequence's ring outranks idle retention); whether one was freed."""
        if not self._entries:
            return False
        _, (_, _, ids) = self._entries.popitem(last=False)
        self._alloc.free(ids)
        self.retained_pages -= len(ids)
        return True

    def has(self, key: bytes) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def candidate_lengths(self, n_pre_max: int) -> list[int]:
        """The retained spans (``n_pre``) a prompt whose own span is
        ``n_pre_max`` pages can use, longest first: a section captured at
        k pages holds the window before token k * page, so a longer
        prompt with that prefix skips its first k pages too."""
        return sorted({e[1] for e in self._entries.values() if e[1] <= n_pre_max},
                      reverse=True)

    def seed(self, key: bytes, ring_ids: list[int]) -> None:
        """Seed a fresh ring from the retained section ``key``."""
        s0, n_pre, ids = self._entries[key]
        self._entries.move_to_end(key)
        R = len(ring_ids)
        self._runner.copy_ring_pages(ids, [ring_ids[(s0 + i) % R] for i in range(n_pre - s0)])
        self.hits += 1


@dataclasses.dataclass
class EngineStats:
    """What ``serve/metrics.py:render_metrics`` reads: the router's metrics
    contract (JAX ``engine.py:170 EngineStats``). The engine thread writes
    these plain ints and floats; a scrape on the event loop reads each
    atomically, with no lock on the step path. Fields of features the port
    does not have yet (the decode pager, context-parallel prefill, LoRA,
    wide EP) stay at 0 or empty, so the page carries the JAX engine's
    names."""

    # Gauges, refreshed once a step (``_refresh_gauges``).
    num_waiting: int = 0
    num_running: int = 0
    kv_usage: float = 0.0
    prefix_hit_ratio: float = 0.0
    num_pages: int = 0
    page_size: int = 0
    # The sliding-window ring: the ring pool's used share and pages, and
    # the retained sections (entries, hybrid hits, captures).
    swa_ring_usage: float = 0.0
    swa_ring_pages: int = 0
    swa_sections: int = 0
    swa_section_hits: int = 0
    swa_section_captures: int = 0
    # Counters of the engine's work.
    prompt_tokens: int = 0
    generation_tokens: int = 0
    requests_finished: int = 0
    preemptions: int = 0
    engine_steps_total: int = 0
    # Host time of the last step and its running sum: scheduling, staging
    # and dispatch, then the work after the readback (the time the device
    # waits on the host); not the wait for the readback itself.
    step_host_gap_ms: float = 0.0
    step_host_gap_ms_total: float = 0.0
    # Device programs enqueued: one per unified step, per prefill Q-bucket
    # group and per decode window.
    step_dispatches_total: int = 0
    # Programs that carried decode rows, and their count per generated token.
    decode_dispatches_total: int = 0
    dispatches_per_emitted_token: float = 0.0
    # Steps that ran as one unified program.
    unified_steps_total: int = 0
    # Tokens the programs computed for real, and the pads their shapes added.
    live_tokens_total: int = 0
    padded_tokens_total: int = 0
    # Step watchdog trips (``serve/async_engine.py``).
    engine_watchdog_stalls_total: int = 0
    # Async stepping: staged rows dropped because their sequence finished
    # (or was aborted) in the step that was in flight when they were staged.
    async_rollbacks_total: int = 0
    # Speculative decoding: draft tokens proposed and accepted, their
    # ratio, the accepted-length histogram (index j: row-steps that
    # accepted j draft tokens), the fused verify windows' row-iterations
    # and rows that stopped before their window's last iteration, and the
    # dispatched rows by 1 + draft width.
    spec_proposed_tokens_total: int = 0
    spec_accepted_tokens_total: int = 0
    spec_acceptance_rate: float = 0.0
    spec_accepted_len_hist: tuple = ()
    spec_window_iters_total: int = 0
    spec_window_early_exit_total: int = 0
    spec_row_depth_hist: tuple = ()
    # Tiered offload: host-DRAM pages, file-tier pages, pages saved and
    # restored (``HostKVCache.stats``).
    offload_pages: int = 0
    offload_fs_pages: int = 0
    offload_saves: int = 0
    offload_restores: int = 0
    # The batch tier: batch requests waiting, batch tokens computed, batch
    # rows preempted, and the last step's batch tokens over its budget.
    batch_backlog_jobs: int = 0
    batch_tokens: int = 0
    batch_preemptions: int = 0
    batch_backfill_utilization: float = 0.0
    # P/D transfer (``KVConnector.stats``): requests and bytes exported
    # and imported, failed imports, v3 cells landed and the last import's
    # first-group ms, CRC rejections, recomputes after a failed import,
    # and failures by (stage, policy).
    kv_exported_requests: int = 0
    kv_exported_bytes: int = 0
    kv_imported_requests: int = 0
    kv_imported_bytes: int = 0
    kv_import_failures: int = 0
    kv_stream_groups_total: int = 0
    kv_stream_first_group_ms: float = 0.0
    kv_transfer_failures: tuple = ()
    kv_bundle_crc_failures_total: int = 0
    kv_recompute_fallbacks_total: int = 0
    # The store tier (``kvstore/``, ``federation/``): pages pulled, failed
    # pulls and misses of the store client, this replica's publications
    # the master accepted, pages fetched from the store, the prompt tokens
    # those pages spared, and the publish bytes the pacer delayed.
    kvstore_pulls: int = 0
    kvstore_pull_failures: int = 0
    kvstore_misses: int = 0
    kv_federation_published: int = 0
    kv_federation_hits: int = 0
    recompute_avoided_tokens: int = 0
    kv_publish_paced_bytes_total: int = 0
    # Failover resume (``serve/api.py``): resumed streams, the output
    # tokens they replayed as prompt, and resumes refused.
    stream_resumes_total: int = 0
    resume_replayed_tokens_total: int = 0
    stream_resume_failures_total: int = 0
    # Features the port does not have yet: always 0 or empty here.
    kv_paged_out_bytes: int = 0
    kv_pager_prefetch_late_total: int = 0
    cp_ring_steps_total: int = 0
    max_lora: int = 0
    running_lora_adapters: tuple = ()
    waiting_lora_adapters: tuple = ()
    resident_lora_adapters: tuple = ()
    available_lora_adapters: tuple = ()
    lora_pool_resident_adapters: int = 0
    lora_pool_evictions_total: int = 0
    lora_cold_loads_total: int = 0
    lora_load_failures_total: int = 0
    moe_expert_tokens: tuple = ()
    moe_dropped_slots_total: int = 0
    moe_peak_demand: float = 0.0
    moe_capacity_factor: float = 0.0
    moe_rebalances_total: int = 0


@dataclasses.dataclass
class _InflightStep:
    """One dispatched step whose readback is not read yet (async stepping)."""

    batch: ScheduledBatch
    pending_prefill: PendingPrefill | None
    pending_decode: PendingDecode | None
    pending_unified: PendingUnified | None
    dispatch_time: float


class LLMEngine:
    def __init__(
        self,
        config: EngineConfig,
        params: dict | None = None,
        device: str | torch.device = "cuda",
        event_sink: KVEventSink | None = None,
    ) -> None:
        self.config = config
        self.device = resolve_device(device)
        cache = config.cache
        spec = swa_ring_spec(config.model, cache, config.scheduler)
        if spec is not None and not config.scheduler.enable_chunked_prefill:
            raise ValueError(
                "kv_swa_ring requires chunked prefill: a whole-prompt chunk "
                "can exceed the span the ring is sized for "
                "(SwaRingSpec.chunk_tokens)"
            )
        offload = config.offload if config.offload is not None and config.offload.enabled else None
        if spec is not None and offload is not None:
            raise ValueError(
                "kv_swa_ring does not compose with tiered KV offload: "
                "host-cached pages would lack the sliding layers' KV "
                "— disable one of the two"
            )
        prefix_caching = cache.enable_prefix_caching
        if spec is not None and cache.swa_section_cache <= 0:
            # No retained section, so no usable hit: hash nothing.
            prefix_caching = False
        retention = 0
        if spec is not None and prefix_caching:
            # Retention pages come on top of the rings, in the same pool.
            retention = cache.swa_section_cache * spec.max_section_pages(cache.page_size)
            spec = dataclasses.replace(spec, num_swa_blocks=spec.num_swa_blocks + retention)
        self._swa = spec
        # Tiered offload: the store tier's client and federation first, then
        # the host tiers, then the tier-honest sink around the given one.
        self._host_cache = self.offloader = None
        self._kvstore_client = self._federation = None
        if offload is not None:
            # Imported here: the tiers' module imports the engine package.
            from llmd_tpu_torch.kvtransfer.offload import HostKVCache, TieredEventSink

            if offload.store_master_url:
                from llmd_tpu_torch.federation import KVFederation
                from llmd_tpu_torch.kvstore import CrossSliceStoreClient

                self._kvstore_client = CrossSliceStoreClient(
                    master_url=offload.store_master_url, advertised_host=config.kv_host,
                    data_port=offload.store_data_port,
                    segment_bytes=offload.store_segment_bytes)
                try:
                    self._federation = KVFederation(
                        self._kvstore_client, publish_policy=offload.publish_policy,
                        publish_min_hits=offload.publish_min_hits)
                except ValueError:
                    self._kvstore_client.close()
                    raise
            self._host_cache = HostKVCache(
                max_pages=offload.cpu_chunks, fs_dir=offload.fs_dir,
                fs_max_pages=offload.fs_max_pages, federation=self._federation)
            event_sink = TieredEventSink(event_sink or KVEventSink(), self._host_cache)
            if self._federation is not None:
                self._federation.event_sink = event_sink.inner
        self.allocator = PageAllocator(
            num_pages=cache.num_blocks,
            page_size=cache.page_size,
            enable_prefix_caching=prefix_caching,
            event_sink=event_sink,
        )
        self.swa_allocator = None if spec is None else PageAllocator(
            num_pages=spec.num_swa_blocks, page_size=cache.page_size,
            enable_prefix_caching=False,
        )
        self.scheduler = EngineScheduler(
            config.scheduler, cache, self.allocator, config.model.max_model_len,
            swa_allocator=self.swa_allocator,
            swa_ring_pages=spec.ring_pages if spec else 0,
            swa_chunk_tokens=spec.chunk_tokens if spec else 0,
        )
        self.runner = ModelRunner(config, params=params, device=self.device, swa_spec=spec)
        self._swa_sections = None
        if retention:
            self._swa_sections = SwaSectionCache(
                self.swa_allocator, self.runner, cache.swa_section_cache, retention)
            self.scheduler.prefill_complete_hook = self._capture_swa_section
            self.scheduler.ring_pressure_hook = self._swa_sections.evict_one
        # The tiered offload's save/restore pump; a page fetched from the
        # store comes back in the runner's staging dtype.
        if offload is not None:
            from llmd_tpu_torch.kvtransfer.offload import OffloadConnector

            self.offloader = OffloadConnector(self.runner, self.allocator, self._host_cache)
            self.allocator.commit_hook = self.offloader.on_commit
            if self._federation is not None:
                self._federation.page_dtype = self.runner.staging_dtype
        self.stats = EngineStats(num_pages=cache.num_blocks, page_size=cache.page_size)
        self._counter = itertools.count()
        # P/D disaggregation (JAX ``engine.py:604-620``): the KV connector;
        # a producer exports in the scheduler's finish hook, while the
        # request's pages are live.
        self.kv_connector = None
        if config.kv_role:
            from llmd_tpu_torch.kvtransfer.connector import KVConnector, KVTransferConfig

            self.kv_connector = KVConnector(KVTransferConfig(
                role=config.kv_role, host=config.kv_host, port=config.kv_transfer_port,
                lease_ms=config.kv_lease_ms,
                load_failure_policy=config.kv_load_failure_policy,
                transfer_dtype=config.kv_transfer_dtype,
                local_fastpath=config.kv_local_fastpath,
                stream_groups=config.kv_stream_groups,
            ), self.runner, self.allocator)
            self.scheduler.finish_hook = self._on_finish
        # Requests parked on a group-streamed import: (request, handle).
        self._kv_parked: list = []
        # Async stepping; off for a P/D producer, whose eager answers rely
        # on the synchronous step order (JAX ``engine.py:631-643``).
        self._async = bool(config.scheduler.async_scheduling)
        if self._async and config.kv_role in ("kv_producer", "kv_both"):
            logging.getLogger(__name__).info(
                "async_scheduling disabled: P/D eager-ACK producers rely on synchronous "
                "step ordering")
            self._async = False
        self._inflight: _InflightStep | None = None
        # Aborts of in-flight requests: freeing their pages while the step
        # that writes them runs, and committing that step for a request
        # that is gone, are both wrong, so they wait for the commit.
        self._deferred_aborts: set[str] = set()
        # Speculative decoding: the host-only proposer, and the dispatched
        # decode rows by 1 + draft width (the last bucket takes wider).
        sched = config.scheduler
        self._spec_proposer = (NgramProposer(min_match=sched.spec_ngram_min_match)
                               if sched.speculative_ngram else None)
        self._spec_row_depth = [0] * (2 + sched.spec_ngram_k)

    def add_request(
        self,
        prompt_token_ids: list[int],
        sampling: SamplingParams | None = None,
        request_id: str | None = None,
        priority: int = 0,
        resume_output_tokens: int = 0,
        kv_transfer_params: dict | None = None,
    ) -> str:
        """Queue a request; returns its id. ``resume_output_tokens`` > 0
        marks the prompt's last that many tokens as output a replica that
        died mid-stream already delivered (failover resume): generation
        continues at that output position. ``kv_transfer_params``: a
        producer's ``do_remote_decode``, or on a consumer the producer's
        answer, whose KV is imported before the request is queued (JAX
        ``engine.py:842-915``); the serving layer may have fetched it
        already (``"__pulled__"``), or hands in the handle of a
        group-streamed import (``"__stream__"``), and the request parks
        until it resolves."""
        if not prompt_token_ids:
            raise ValueError("empty prompt")
        if resume_output_tokens and not 0 < resume_output_tokens < len(prompt_token_ids):
            raise ValueError(
                f"resume_output_tokens {resume_output_tokens} must leave a "
                f"non-empty prompt head (prompt carries "
                f"{len(prompt_token_ids)} tokens)"
            )
        vocab = self.config.model.vocab_size
        if not all(0 <= t < vocab for t in prompt_token_ids):
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        if len(prompt_token_ids) >= self.config.model.max_model_len:
            raise ValueError(
                f"prompt length {len(prompt_token_ids)} >= max_model_len "
                f"{self.config.model.max_model_len}"
            )
        sched = self.config.scheduler
        if (not sched.enable_chunked_prefill
                and len(prompt_token_ids) > sched.max_num_batched_tokens):
            raise ValueError(
                f"prompt length {len(prompt_token_ids)} > max_num_batched_tokens "
                f"{sched.max_num_batched_tokens} and chunked prefill is disabled"
            )
        rid = request_id or f"req-{next(self._counter)}-{uuid.uuid4().hex[:8]}"
        preload = kv_stream = None
        conn = self.kv_connector
        if conn is not None and conn.wants_import(kv_transfer_params):
            kv_transfer_params = dict(kv_transfer_params)
            kv_stream = kv_transfer_params.pop("__stream__", None)
            if kv_stream is None:
                bundle = (kv_transfer_params.pop("__pulled__") if "__pulled__" in kv_transfer_params
                          else conn.fetch_remote_policy(list(prompt_token_ids), kv_transfer_params))
                if bundle is not None and self._swa is not None:
                    # A ring engine has no prefix cache: the pages and a
                    # fresh ring go straight to the request.
                    preload = conn.apply_preload(list(prompt_token_ids), bundle,
                                                 self.swa_allocator, self._swa.ring_pages)
                elif bundle is not None:
                    conn.apply_bundle(list(prompt_token_ids), bundle)
        if self.offloader is not None and kv_stream is None:
            # Host pages extending the prompt's device prefix run go back
            # to the device now; the prefix-cache hit at admission takes them.
            self.offloader.restore_for_prompt(list(prompt_token_ids))
        req = Request(
            request_id=rid,
            prompt_token_ids=list(prompt_token_ids),
            sampling=sampling or SamplingParams(),
            priority=priority,
            kv_transfer_params=kv_transfer_params,
        )
        if resume_output_tokens:
            # Admitted through the recompute-preemption seam: the history is
            # prompt, and num_prior_output_tokens carries the output
            # position, which seeded sampling and the length check count.
            req.num_prior_output_tokens = resume_output_tokens
            self.stats.stream_resumes_total += 1
            self.stats.resume_replayed_tokens_total += resume_output_tokens
        if preload is not None:
            req.block_ids = list(preload["block_ids"])
            req.swa_block_ids = list(preload["swa_block_ids"])
            req.num_computed_tokens = req.num_cached_tokens = preload["tokens"]
        elif self._swa_sections is not None and kv_stream is None:
            self._try_hybrid_ring_hit(req)
        if kv_stream is not None:
            # Schedulable once the import resolves (``_admit_kv_streams``).
            self._kv_parked.append((req, kv_stream))
            return rid
        self.scheduler.add_request(req)
        return rid

    def _on_finish(self, req: Request) -> None:
        if self.kv_connector.wants_export(req):
            req.export_params = self.kv_connector.export_finished(req)

    def _admit_kv_streams(self) -> None:
        """At a step boundary, queue the parked requests whose streamed
        import resolved (JAX ``engine.py:1314-1360``): a landed bundle is
        applied (its pages are written: the hash chain is committed) and
        the prefill becomes a prefix-cache hit; a failed one is a local
        recompute. With nothing else to do, wait up to 50 ms on the oldest
        stream rather than spin."""
        while True:
            still, admitted = [], False
            for req, handle in self._kv_parked:
                if not handle.done.is_set():
                    still.append((req, handle))
                    continue
                bundle = handle.take()
                if bundle is not None:
                    self.kv_connector.apply_bundle(list(req.prompt_token_ids), bundle)
                elif self.offloader is not None:
                    self.offloader.restore_for_prompt(list(req.prompt_token_ids))
                self.scheduler.add_request(req)
                admitted = True
            self._kv_parked = still
            if admitted or not still or self._inflight is not None or self.scheduler.has_work():
                return
            if not still[0][1].done.wait(0.05):
                return

    def _section_key(self, prompt_token_ids: list[int]) -> tuple[bytes | None, int, int]:
        """(key, n_pre, s0) of a prompt's section: the hash of its page
        ``n_pre - 1``; the same derivation at capture and at a hit."""
        page = self.config.cache.page_size
        n_pre, s0, _ = self._swa.section(len(prompt_token_ids), page)
        if n_pre <= s0:
            return None, 0, 0
        hashes = page_hashes_for_tokens(prompt_token_ids[: n_pre * page], page)
        return hashes[n_pre - 1], n_pre, s0

    def _capture_swa_section(self, req: Request) -> None:
        """The scheduler's hook when a prompt completes: its ring still
        holds the prompt's last window, so retain a copy for later hits
        (at finish the ring has moved past the prompt)."""
        key, n_pre, s0 = self._section_key(req.prompt_token_ids)
        if key is None or not req.swa_block_ids:
            return
        try:
            self._swa_sections.capture(key, req.swa_block_ids, s0, n_pre)
        except Exception:  # a failed capture costs a later hit, not this request
            logging.getLogger(__name__).exception("sliding-window section capture failed")

    def _try_hybrid_ring_hit(self, req: Request) -> None:
        """A hybrid prefix hit under the ring: taken only where a main-pool
        prefix run and a retained section cover the same span, the longest
        retained span the prompt covers. The fresh ring is seeded from the
        section on the device and the request starts past the span. A
        miss, no free ring or a failed seed leaves it a plain prefill with
        nothing held."""
        page = self.config.cache.page_size
        n_pre, _, _ = self._swa.section(len(req.prompt_token_ids), page)
        lengths = self._swa_sections.candidate_lengths(n_pre) if n_pre > 0 else []
        if not lengths:
            return
        # One hash walk serves the section keys and the main-pool lookup.
        hashes = page_hashes_for_tokens(req.prompt_token_ids[: n_pre * page], page)
        for k in lengths:
            key = hashes[k - 1]
            # A probe that touches nothing: a candidate left unused must
            # not count as a hit or refresh its pages' recency.
            if not self._swa_sections.has(key) or self.allocator.peek_hash_run(hashes[:k]) < k:
                continue
            cached = self.allocator.lookup_and_touch_hashes(hashes[:k])
            ring: list[int] = []
            try:
                ring = self.swa_allocator.allocate(self._swa.ring_pages)
                self._swa_sections.seed(key, ring)
            except Exception as e:  # a hit never fails the request
                self.allocator.free(cached)
                if ring:
                    self.swa_allocator.free(ring)
                if not isinstance(e, NoFreePagesError):
                    logging.getLogger(__name__).exception("hybrid ring seed failed; prefilling")
                return
            req.block_ids = cached
            req.swa_block_ids = ring
            req.num_computed_tokens = req.num_cached_tokens = k * page
            # The chain starts past the hit: the cached prefix is not
            # committed again.
            self.scheduler.seed_commit_chain(req, key, k)
            return

    def abort_request(self, request_id: str) -> bool:
        for i, (req, handle) in enumerate(self._kv_parked):
            if req.request_id == request_id:
                # Parked on a stream: abandon() frees the fetched bundle's
                # pages on whichever side holds it.
                del self._kv_parked[i]
                handle.abandon()
                return True
        if self._inflight is not None and any(
                s.request.request_id == request_id for s in self._inflight.batch.seqs):
            self._deferred_aborts.add(request_id)
            return True
        return self.scheduler.abort_request(request_id) is not None

    def drop_inflight(self) -> None:
        """Forget the step in flight after a step raised (the serving loop
        calls it before it aborts the failed step's requests): its tokens
        will never be committed, so its sequences are no longer protected,
        and the deferred aborts are applied now, freeing their pages. A
        later step is ordered after the dropped one on the device's one
        stream, so no later write races the dropped step's."""
        inflight, self._inflight = self._inflight, None
        if inflight is not None:
            self.scheduler.forget_pending(inflight.batch.seqs)
        self._apply_deferred_aborts()

    def _apply_deferred_aborts(self) -> None:
        aborts, self._deferred_aborts = self._deferred_aborts, set()
        for rid in sorted(aborts):
            self.scheduler.abort_request(rid)

    def cached_prefix_pages(self, prompt_token_ids: list[int]) -> int:
        """Leading full pages of this prompt that the device prefix cache
        or a host tier holds (JAX ``engine.py:1033``): the P/D sidecar's
        probe before a transfer. Called off the engine thread: each lookup
        is one dict membership test (the host cache's under its lock),
        which takes no reference and moves nothing, and a probe racing a
        step sees the cache before or after it."""
        hashes = page_hashes_for_tokens(list(prompt_token_ids), self.allocator.page_size)
        n = 0
        for h in hashes:
            if not (self.allocator.has_cached(h)
                    or (self._host_cache is not None and self._host_cache.has(h))):
                break
            n += 1
        return n

    def has_work(self) -> bool:
        return self.scheduler.has_work() or self._inflight is not None or bool(self._kv_parked)

    def close(self) -> None:
        """Release what outlives a step (JAX ``close``): the host tiers'
        file writer finishes its spills, so that a process started over
        the same directory finds every page the cache spilled; the KV
        connector's shipper stops; the store client finishes its queued
        publications, withdraws its segment and stops its threads."""
        if self._host_cache is not None:
            self._host_cache.close()
        if self.kv_connector is not None:
            self.kv_connector.close()
        if self._kvstore_client is not None:
            self._kvstore_client.close()

    def warmup(self) -> int:
        """Build the kernels and prepare the decode steps' programs (CUDA
        graphs on the card) before serving; returns how many
        (``ModelRunner.warmup``)."""
        return self.runner.warmup()

    def step(self) -> list[RequestOutput]:
        # Fault site: a wedged device program stalls the whole step (the
        # step watchdog's case). Unarmed, one global read.
        faults.delay("engine.step.stall")
        if self._kv_parked:
            self._admit_kv_streams()
        return self._step_async() if self._async else self._step_sync()

    def _step_sync(self) -> list[RequestOutput]:
        t0 = time.perf_counter()
        batch: ScheduledBatch = self.scheduler.schedule()
        if batch.is_empty:
            return []
        now = time.monotonic()
        pend_p, pend_d, pend_u = self._dispatch(batch)
        t_dispatched = time.perf_counter()
        # One readback for the whole step, whatever it dispatched. Under
        # eager-ACK (JAX ``engine.py:1396-1425``) the step's prefill rows
        # are all a producer's export-only prefills: their sampled token
        # is thrown away by the routing sidecar, so it is not read back
        # (it is 0) and the answer leaves once the step is dispatched,
        # without waiting for the device. The device's program order puts
        # the export's snapshots after it. A step with decode rows still
        # reads them back.
        if self._eager_ack(batch):
            if pend_u is not None and not batch.decodes:
                pend_u = None
            pres, dres = self.runner.wait_step(None, pend_d, pend_u)
            pres = None
        else:
            pres, dres = self.runner.wait_step(pend_p, pend_d, pend_u)
        t_read = time.perf_counter()
        sampled, logprobs = self._collect(batch, pres, dres)
        accepted = self.scheduler.update_after_step(batch, sampled)
        outputs = self._assemble_outputs(batch, accepted, logprobs, now)
        if self.offloader is not None:
            self.offloader.flush()  # the pages this step committed
        self._finish_step((t_dispatched - t0) + (time.perf_counter() - t_read))
        return outputs

    def _eager_ack(self, batch: ScheduledBatch) -> bool:
        conn = self.kv_connector
        return bool(batch.prefills) and conn is not None and conn.cfg.is_producer and all(
            s.request.kv_transfer_params is not None
            and s.request.kv_transfer_params.get("do_remote_decode")
            and s.request.sampling.max_tokens == 1
            for s in batch.prefills)

    def _step_async(self) -> list[RequestOutput]:
        """The two-slot pipeline (JAX ``_step_async``). While step N runs,
        schedule step N+1 against the dispatched positions (each in-flight
        row assumed to land its tokens) and stage its host arrays; only
        then block on N's one readback. Commit N; apply the aborts that
        waited for it; drop the staged rows of sequences that finished in
        N (their pages, the ones claimed for N+1 included, went back when
        they finished) and count them; dispatch the rest at once. N's
        outputs are assembled while N+1 runs, so they come one call
        late; the first call only dispatches."""
        inflight = self._inflight
        if inflight is None:
            batch = self.scheduler.schedule()
            if not batch.is_empty:
                self._dispatch_async(batch)
            return []
        # ---- overlapped: the device runs N ----
        staged = self.scheduler.schedule()
        staged_arrays: Staged | None = None
        if not staged.is_empty and self._unified_eligible(staged):
            # Tables and knobs now; tokens, drafts, positions and seeds at
            # dispatch.
            staged_arrays = self.runner.stage_unified(staged.prefills, staged.decodes)
        elif staged.decodes and self._spec_proposer is not None:
            # The verify shapes; the drafts come at dispatch, after N's
            # commit.
            staged_arrays = (
                self.runner.stage_spec_verify_window(staged.decodes, staged.spec_window)
                if staged.spec_window > 1 else self.runner.stage_spec_verify(staged.decodes))
        elif staged.decodes:
            staged_arrays = self.runner.stage_decode(
                staged.decodes, k_steps=staged.decodes[0].num_tokens)
        # ---- N's one readback ----
        pres, dres = self.runner.wait_step(
            inflight.pending_prefill, inflight.pending_decode, inflight.pending_unified)
        t_read = time.perf_counter()
        sampled, logprobs = self._collect(inflight.batch, pres, dres)
        accepted = self.scheduler.update_after_step(inflight.batch, sampled)
        self._inflight = None
        self._apply_deferred_aborts()
        # ---- reconcile the staged step with the finishes N brought ----
        live_p = [s for s in staged.prefills if s.request.status is RequestStatus.RUNNING]
        live_d = [s for s in staged.decodes if s.request.status is RequestStatus.RUNNING]
        rolled = len(staged.prefills) - len(live_p) + len(staged.decodes) - len(live_d)
        if rolled:
            self.stats.async_rollbacks_total += rolled
            # Survivors keep their planned widths and draft caps: a batch of
            # windows stays a batch of windows of the same K, and verify
            # windows keep their size.
            reconciled = ScheduledBatch(prefills=live_p, decodes=live_d,
                                        spec_window=staged.spec_window)
            if isinstance(staged_arrays, StagedUnified):
                if not reconciled.is_empty and self._unified_eligible(reconciled):
                    staged_arrays = self.runner.subset_staged_unified(
                        staged_arrays, live_p, live_d)
                else:
                    staged_arrays = None
            elif len(live_d) != len(staged.decodes):
                staged_arrays = None  # another row set: staged again at dispatch
            staged = reconciled
        if staged.is_empty and rolled and self.scheduler.has_work():
            # The whole staged step went; what it held may admit other work.
            staged = self.scheduler.schedule()
            staged_arrays = None
        if self.offloader is not None:
            # N's committed pages: gathered before N+1 is enqueued, which
            # may write pages freed since (the host insert waits below).
            self.offloader.launch()
        if not staged.is_empty:
            self._dispatch_async(staged, staged_arrays)
        # The device waits on the host from the readback to this point;
        # the output assembly and the gauges below overlap N+1.
        host_gap = time.perf_counter() - t_read
        outputs = self._assemble_outputs(inflight.batch, accepted, logprobs, inflight.dispatch_time)
        if self.offloader is not None:
            self.offloader.finish()
        self._finish_step(host_gap)
        return outputs

    def _dispatch_async(self, batch: ScheduledBatch, staged: Staged | None = None) -> None:
        now = time.monotonic()
        pend_p, pend_d, pend_u = self._dispatch(batch, staged)
        self._inflight = _InflightStep(batch, pend_p, pend_d, pend_u, now)

    def _dispatch(
        self, batch: ScheduledBatch, staged: Staged | None = None
    ) -> tuple[PendingPrefill | None, PendingDecode | None, PendingUnified | None]:
        """Enqueue a scheduled step and mark its tokens in flight: one
        unified program (drafts proposed first), or the prefill groups and
        the decode programs. ``staged`` is the step's staging when it was
        staged ahead (async stepping); otherwise it is staged here."""
        pend_p = pend_d = pend_u = None
        if self._unified_eligible(batch):
            if self._spec_proposer is not None and batch.decodes:
                self._propose_drafts(batch.decodes)
            if not isinstance(staged, StagedUnified):
                staged = self.runner.stage_unified(batch.prefills, batch.decodes)
            pend_u = self.runner.dispatch_staged_unified(staged)
            self.stats.unified_steps_total += 1
            self.stats.step_dispatches_total += 1
            if batch.decodes:
                self.stats.decode_dispatches_total += 1
        else:
            if batch.prefills:
                pend_p = self.runner.dispatch_prefill(batch.prefills)
                self.stats.step_dispatches_total += len(pend_p.entries)
            if batch.decodes:
                pend_d = self._dispatch_decodes(
                    batch.decodes, batch.spec_window,
                    None if isinstance(staged, StagedUnified) else staged)
        self.stats.prompt_tokens += sum(s.num_tokens for s in batch.prefills)
        self.scheduler.note_dispatch(batch)
        return pend_p, pend_d, pend_u

    def _finish_step(self, host_gap_s: float) -> None:
        """Count the step and its host gap (JAX ``engine.py:1891``), then
        refresh the gauges."""
        gap_ms = host_gap_s * 1e3
        self.stats.engine_steps_total += 1
        self.stats.step_host_gap_ms = round(gap_ms, 3)
        self.stats.step_host_gap_ms_total = round(self.stats.step_host_gap_ms_total + gap_ms, 3)
        self._refresh_gauges()

    def _refresh_gauges(self) -> None:
        """The gauges of ``EngineStats`` from the scheduler, the allocators
        and the runner, once a step (JAX ``engine.py:1947``)."""
        st = self.stats
        st.num_waiting = self.scheduler.num_waiting
        st.num_running = self.scheduler.num_running
        st.kv_usage = self.allocator.usage()
        if self.swa_allocator is not None:
            st.swa_ring_usage = self.swa_allocator.usage()
            st.swa_ring_pages = self.swa_allocator.num_pages
            if self._swa_sections is not None:
                sec = self._swa_sections
                st.swa_sections = len(sec)
                st.swa_section_hits = sec.hits
                st.swa_section_captures = sec.captures
        st.prefix_hit_ratio = self.allocator.hit_ratio()
        st.preemptions = self.scheduler.num_preemptions
        sch = self.scheduler
        st.batch_backlog_jobs = sum(1 for r in sch.waiting if r.is_batch)
        st.batch_tokens = sch.batch_tokens
        st.batch_preemptions = sch.num_batch_preemptions
        st.batch_backfill_utilization = round(
            sch.last_batch_backfill_tokens / max(1, self.config.scheduler.max_num_batched_tokens), 6)
        if self._host_cache is not None:
            hs = self._host_cache.stats()
            st.offload_pages = hs["pages"]
            st.offload_fs_pages = hs["fs_pages"]
            st.offload_saves = hs["saves"]
            st.offload_restores = hs["restores"]
            st.recompute_avoided_tokens = self.offloader.recompute_avoided_tokens
        if self._kvstore_client is not None:
            ks = self._kvstore_client.stats()
            st.kvstore_pulls = ks["pulls"]
            st.kvstore_pull_failures = ks["pull_failures"]
            st.kvstore_misses = ks["misses"]
            st.kv_publish_paced_bytes_total = ks["paced_publish_bytes"]
            fs = self._federation.stats()
            st.kv_federation_published = fs["published"]
            st.kv_federation_hits = fs["hits"]
        if sch.spec_k:
            st.spec_proposed_tokens_total = sch.spec_proposed_tokens
            st.spec_accepted_tokens_total = sch.spec_accepted_tokens
            st.spec_acceptance_rate = round(
                sch.spec_accepted_tokens / max(1, sch.spec_proposed_tokens), 6)
            st.spec_accepted_len_hist = tuple(sch.spec_accept_len_hist)
            st.spec_window_iters_total = sch.spec_window_iters
            st.spec_window_early_exit_total = sch.spec_window_early_exit
            st.spec_row_depth_hist = tuple(self._spec_row_depth)
        if self.kv_connector is not None:
            cs = self.kv_connector.stats()
            st.kv_exported_requests = cs["exported_requests"]
            st.kv_exported_bytes = cs["exported_bytes"]
            st.kv_imported_requests = cs["imported_requests"]
            st.kv_imported_bytes = cs["imported_bytes"]
            st.kv_import_failures = cs["import_failures"]
            st.kv_stream_groups_total = cs["stream_groups_total"]
            st.kv_stream_first_group_ms = cs["last_first_group_ms"]
            st.kv_bundle_crc_failures_total = cs["crc_failures"]
            st.kv_recompute_fallbacks_total = cs["recompute_fallbacks"]
            st.kv_transfer_failures = tuple(sorted(cs["transfer_failures"].items()))
        st.live_tokens_total = self.runner.live_tokens_total
        st.padded_tokens_total = self.runner.padded_tokens_total
        st.dispatches_per_emitted_token = round(
            st.decode_dispatches_total / max(1, st.generation_tokens), 6)

    def _unified_eligible(self, batch: ScheduledBatch) -> bool:
        """Does this batch ride the unified single-dispatch program?
        Window-1 steps only: a fused decode or verify window keeps its own
        dispatch (one-shot verify rows, planned at 1 + k, are window-1
        rows). The flat step takes every such step. The bucketed unified
        program takes only steps for which the split engine would launch
        more than one program: mixed prefill + decode steps, and
        prefill-only steps that span several Q buckets."""
        if batch.spec_window != 1:
            return False
        if self._spec_proposer is None and any(s.num_tokens != 1 for s in batch.decodes):
            return False
        if self.runner.flat:
            return True
        if not self.config.scheduler.unified_step or not batch.prefills:
            return False
        if batch.decodes:
            return True
        return self.runner.prefill_group_count(batch.prefills) > 1

    def _dispatch_decodes(self, decodes: list[ScheduledSeq], spec_window: int = 1,
                          staged: Staged | None = None) -> PendingDecode:
        """The step's decode rows: one fused decode window (K uniform
        across the batch, the scheduler's choice), or under speculative
        decoding the programs ``_dispatch_decode_programs`` picks.
        ``staged`` is their staging if it was staged ahead."""
        pend = self._dispatch_decode_programs(decodes, spec_window, staged)
        self.stats.decode_dispatches_total += len(pend.entries)
        self.stats.step_dispatches_total += len(pend.entries)
        return pend

    def _dispatch_decode_programs(self, decodes: list[ScheduledSeq], spec_window: int,
                                  staged: Staged | None) -> PendingDecode:
        """JAX ``_dispatch_decode_programs``. Under speculative decoding:
        the fused verify window where the scheduler gave one and a row
        drafted, else the plain decode window at the window's depth (capped
        by the narrowest planned row, down to a decode window the engine
        dispatches); one-shot, the verify program where every row drafted,
        the plain one-token program where none did, both where some did."""
        runner = self.runner
        if self._spec_proposer is None:
            if not isinstance(staged, StagedDecode):
                staged = runner.stage_decode(decodes, k_steps=decodes[0].num_tokens)
            return runner.dispatch_staged_decode(staged)
        self._propose_drafts(decodes)
        if spec_window > 1:
            window_staged = (isinstance(staged, StagedVerifyWindow)
                             and staged.window == spec_window
                             and len(staged.seqs) == len(decodes)
                             and all(a is b for a, b in zip(staged.seqs, decodes)))
            if any(s.draft_tokens for s in decodes):
                if not window_staged:
                    staged = runner.stage_spec_verify_window(decodes, spec_window)
                return runner.dispatch_staged_verify_window(staged)
            k = min(spec_window, min(s.num_tokens for s in decodes))
            k = max(w for w in runner.decode_windows if w <= k)
            staged = (runner.degrade_staged_window(staged, k) if window_staged
                      else runner.stage_decode(decodes, k_steps=k))
            return runner.dispatch_staged_decode(staged)
        drafted = sum(1 for s in decodes if s.draft_tokens)
        if drafted == len(decodes):
            if not isinstance(staged, StagedVerify):
                staged = runner.stage_spec_verify(decodes)
            return runner.dispatch_staged_verify(staged)
        if drafted == 0:
            # No row drafted: the plain one-token program, no idle verify
            # columns. The rows stay speculative (empty drafts), so the
            # accounting and the truncation still run.
            return runner.dispatch_staged_decode(runner.stage_decode(decodes, k_steps=1))
        return runner.dispatch_spec_split(
            decodes, staged if isinstance(staged, StagedVerify) else None)

    def _propose_drafts(self, decodes: list[ScheduledSeq]) -> None:
        """Each speculative decode row's draft from its committed tokens,
        at dispatch (async staging runs a step early, before the tail
        token is known). The cap (``spec_draft_cap``, or the one-shot
        width ``num_tokens - 1``; 0 for a backed-off row) keeps the draft
        inside the slots the scheduler planned, even where a short
        acceptance left the row behind its planned position."""
        max_len = self.config.model.max_model_len
        for seq in decodes:
            req = seq.request
            cap = seq.num_tokens - 1 if seq.spec_draft_cap is None else seq.spec_draft_cap
            cap = min(cap, max_len - req.num_computed_tokens - 1)
            if cap <= 0:
                seq.draft_tokens = []
                continue
            if req.spec_gram_state is None:
                req.spec_gram_state = self._spec_proposer.new_state()
            seq.draft_tokens = self._spec_proposer.propose(
                req.all_token_ids, cap, req.spec_gram_state)
        for seq in decodes:
            depth = 1 + len(seq.draft_tokens or ())
            self._spec_row_depth[min(depth, len(self._spec_row_depth) - 1)] += 1

    @staticmethod
    def _collect(
        batch: ScheduledBatch, pres: StepResult | None, dres: StepResult | None
    ) -> tuple[dict[str, list[int]], dict[str, list[float]]]:
        """Per request id: the window of sampled tokens and their logprobs.
        A fused verify window's row keeps its emitted columns and carries
        its device meta to the scheduler (``device_accept``); a one-shot
        speculative row keeps 1 + its draft's columns (a window that fell
        back to plain decode keeps every column)."""
        sampled: dict[str, list[int]] = {}
        logprobs: dict[str, list[float]] = {}
        if batch.prefills and pres is None:
            # Eager-ACK: the prefills' tokens were not read back.
            n = len(batch.prefills)
            pres = StepResult(np.zeros((n, 1), np.int32), np.zeros((n, 1), np.float32))
        for i, seq in enumerate(batch.prefills):
            sampled[seq.request.request_id] = pres.tokens[i].tolist()
            logprobs[seq.request.request_id] = pres.logprobs[i].tolist()
        for i, seq in enumerate(batch.decodes):
            toks, lps = dres.tokens[i], dres.logprobs[i]
            if dres.meta is not None:
                seq.device_accept = tuple(int(v) for v in dres.meta[i])
                m = seq.device_accept[0]
                toks, lps = toks[:m], lps[:m]
            elif seq.draft_tokens is not None and batch.spec_window == 1:
                m = 1 + len(seq.draft_tokens)
                toks, lps = toks[:m], lps[:m]
            sampled[seq.request.request_id] = toks.tolist()
            logprobs[seq.request.request_id] = lps.tolist()
        return sampled, logprobs

    def _assemble_outputs(
        self,
        batch: ScheduledBatch,
        accepted: dict[str, list[int]],
        logprobs: dict[str, list[float]],
        now: float,
    ) -> list[RequestOutput]:
        outputs: list[RequestOutput] = []
        finished = 0
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
            self.stats.generation_tokens += len(new_tokens)
            finished += int(req.is_finished)
            outputs.append(
                RequestOutput(
                    request_id=req.request_id,
                    new_token_ids=new_tokens,
                    finished=req.is_finished,
                    finish_reason=req.finish_reason,
                    num_prompt_tokens=req.num_prompt_tokens - req.num_prior_output_tokens,
                    num_output_tokens=req.total_output_tokens,
                    num_cached_tokens=req.num_cached_tokens,
                    kv_transfer_params=req.export_params,
                )
            )
        self.stats.requests_finished += finished
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
