"""The decode pager: a sliding-window sequence's device pages bounded by its
window, not by its context (JAX ``llmd_tpu/engine/pager.py``,
``OffloadConfig.decode_paging``).

Every attention read of a layer that slides is masked to the trailing
``window`` positions, so the pages of a long context below the window are
never read again while the sequence decodes. The pager moves them out:

- **Spill** (``tick``, once a step): the pages of a running sequence that
  lie wholly below ``num_computed_tokens - (window + horizon)`` go to the
  tiered host cache (``kvtransfer/offload.py``) under the prefix index's
  chained content hash, and their device pages are freed. The stale ids
  stay in ``Request.block_ids`` (the logical list keeps its length): the
  kernels start their walk at the window's first page and never read them,
  the plain ``[B, Q]`` functions mask them to an exact zero weight, and
  the scheduler frees no ``paged_out`` index.
- **Park** (``Scheduler.park_hook``): a preemption victim's computed KV
  goes to the host tier and all its pages are freed; it waits with
  ``num_computed_tokens`` kept, not recomputed from zero.
- **Restore** (``pump``, before each schedule): a parked request at the
  waiting queue gets its window back (window + horizon, the spill's steady
  state) in fresh pages, written in ``stream_groups`` layer groups as the
  v3 wire's streamed import writes them. Until then it is fetch-pending,
  which the scheduler waits on. A page the host tier lost refunds the
  request to a recompute from zero, the same tokens as a plain preemption.

The port moves pages on the runner's one set of page legs. A spill is the
save's leg (``launch_page_copies``: the gather on the compute stream, then
copies into ``HostPagePool``'s pinned slots on a copy stream) and frees the
pages at once: a later step that writes a freed page is enqueued after the
gather, and the gathered buffer is kept until its copies are done. The
pages reach the host cache (``HostKVCache.put``) in ``finish``, which waits
only for those copies: the synchronous engine calls it after its tick (the
device has nothing else queued then), the async engine at its next tick,
after that step's readback, and a restore calls it before it reads the
host tier. A restore uploads the host pages (``upload_pages_device``) and
scatters them in place (``scatter_pages_from_device(..., layers=)``), so
captured decode graphs read the restored pages with no new capture.
"""

from __future__ import annotations

import logging
import time
from typing import TYPE_CHECKING

from llmd_tpu_torch.engine.kv_cache import _ROOT_HASH, NoFreePagesError, page_hashes_for_tokens

if TYPE_CHECKING:  # pragma: no cover
    from llmd_tpu_torch.engine.request import Request

log = logging.getLogger(__name__)


def _layer_slice(t, l0: int, span: int):
    """Layers ``[l0, l0 + span)`` of an uploaded bundle, carrying the
    upload's ``ready`` event, which the scatter waits for."""
    out = t.narrow(0, l0, span)
    ready = getattr(t, "ready", None)
    if ready is not None:
        out.ready = ready
    return out


class KVPager:
    """Spill, park and restore for the decode pager. The engine builds it
    only where the tiered offload is on and every layer slides (a full
    layer reads arbitrarily far back, so none of its pages is ever cold);
    the port runs on one host, and the ring, which bounds the window's
    pages its own way, is refused beside the offload."""

    def __init__(self, runner, scheduler, allocator, host_cache, pool, *,
                 window: int, horizon: int, stream_groups: int = 1) -> None:
        self.runner = runner
        self.sched = scheduler
        self.allocator = allocator
        self.host = host_cache
        self.pool = pool  # the offload's HostPagePool: the spills' slots
        self.page = allocator.page_size
        self.window = int(window)
        self.horizon = int(horizon)
        self.keep_tokens = self.window + self.horizon
        self.stream_groups = max(1, int(stream_groups))
        # JAX's six counters (EngineStats, /metrics).
        self.paged_out_bytes = 0
        self.pages_spilled_total = 0
        self.pages_restored_total = 0
        self.prefetch_late_total = 0
        self.parks_total = 0
        self.refunds_total = 0
        # Spills whose copies to the host are enqueued: (hashes, slots, event).
        self._launched: list[tuple[list[bytes], list, object]] = []
        # Host seconds in tick + finish and in restores (``chip_smoke.py``).
        self.tick_host_s = 0.0
        self.restore_host_s = 0.0

    def _hashes(self, req: Request, upto: int) -> list[bytes]:
        """Chained hashes of the first ``upto`` pages, the prefix index's
        keys (salted as the scheduler salts them), so that a spilled page
        is also a host-tier hit for a later prompt with that prefix."""
        return page_hashes_for_tokens(req.all_token_ids[: upto * self.page], self.page,
                                      self.sched.hash_extra(req))

    # -- spill ------------------------------------------------------------ #

    def tick(self, running: list[Request]) -> None:
        """Spill the cold pages of running sequences: a page is cold when
        every position in it is below the window + horizon of the
        sequence's computed frontier. In-flight (protected) sequences are
        skipped: a dispatched step still holds their page tables. Puts the
        previous tick's spills in the host tier first."""
        t0 = time.perf_counter()
        self.finish()
        for req in running:
            if req.request_id in self.sched.protected:
                continue
            lo_page = (req.num_computed_tokens - self.keep_tokens) // self.page
            if lo_page <= 0:
                continue
            lo_page = min(lo_page, len(req.block_ids))
            idxs = [i for i in range(lo_page) if i not in req.paged_out]
            if not idxs:
                continue
            hashes = self._hashes(req, lo_page)
            self._spill(req, idxs, hashes)
            # The chain moves past the spilled range, so that a commit at
            # finish never reads a stale id; a prefix hit may have seeded
            # it further already.
            _, committed = self.sched.commit_chain_state(req)
            if committed < lo_page:
                self.sched.seed_commit_chain(req, hashes[lo_page - 1], lo_page)
        self.tick_host_s += time.perf_counter() - t0

    def _spill(self, req: Request, idxs: list[int], hashes: list[bytes]) -> None:
        """Copy the given resident pages to the host and free them."""
        ids = [req.block_ids[i] for i in idxs]
        slots = [self.pool.take() for _ in ids]
        done = self.runner.launch_page_copies(ids, slots)
        self._launched.append(([hashes[i] for i in idxs], slots, done))
        for i in idxs:
            req.paged_out[i] = hashes[i]
        self.allocator.free(ids)
        self.pages_spilled_total += len(idxs)
        self.paged_out_bytes += sum(s.numel() * s.element_size() for s in slots)

    def finish(self) -> None:
        """Wait for the enqueued spills' copies and put their pages in the
        host tier."""
        launched, self._launched = self._launched, []
        for hashes, slots, done in launched:
            self.runner.wait_copies(done)
            for h, slot in zip(hashes, slots):
                if not self.host.put(h, slot):
                    self.pool.give(slot)  # the tier holds this content already

    # -- park ------------------------------------------------------------- #

    def park(self, req: Request) -> int:
        """The preemption hook: host the victim's computed KV and free all
        its pages. Returns the tokens kept (page-aligned, leaving at least
        one token to recompute so that the resume has a chunk), or 0 when
        nothing is worth parking: a plain recompute preemption then."""
        total = req.num_tokens
        bp = min(req.num_computed_tokens // self.page, (total - 1) // self.page)
        bp = min(bp, len(req.block_ids))
        if bp <= 0:
            return 0
        hashes = self._hashes(req, bp)
        need = [i for i in range(bp) if i not in req.paged_out and not self.host.has(hashes[i])]
        if need:
            self._spill(req, need, hashes)
        # Everything still resident (pages the tier holds already, and the
        # partial frontier past bp, recomputed at resume) is freed.
        ids = [b for i, b in enumerate(req.block_ids) if i not in req.paged_out]
        if ids:
            self.allocator.free(ids)
        req.block_ids = []
        req.paged_out = {i: hashes[i] for i in range(bp)}
        # Commits at finish start past the parked range, which lives in the
        # host tier.
        self.sched.seed_commit_chain(req, hashes[bp - 1], bp)
        req.kv_fetch_pending = True
        self.parks_total += 1
        return bp * self.page

    # -- restore ---------------------------------------------------------- #

    def pump(self, waiting: list[Request]) -> None:
        """Bring the windows of parked requests back, before a schedule:
        only window + horizon is restored, the pages below stay in the
        host tier, as the spill leaves a live sequence."""
        pending = [req for req in waiting if req.kv_fetch_pending]
        if not pending:
            return
        t0 = time.perf_counter()
        self.finish()
        for req in pending:
            self._restore(req)
        self.restore_host_s += time.perf_counter() - t0

    def _restore(self, req: Request) -> None:
        kept = req.num_computed_tokens
        bp = kept // self.page
        lo = max(0, kept - self.keep_tokens) // self.page
        idxs = list(range(lo, bp))
        if not idxs:
            req.kv_fetch_pending = False
            return
        pages = []
        for i in idxs:
            h = req.paged_out.get(i)
            got, tier = (None, None) if h is None else self.host.get_tagged(h)
            if got is None:
                # The tier dropped the page: recompute (the copy failed,
                # the compute did not).
                self._refund(req)
                return
            if tier != "dram":
                # Not staged in host DRAM: the fetch came late.
                self.prefetch_late_total += 1
            pages.append(got)
        try:
            new_ids = self.allocator.allocate(len(idxs))
        except NoFreePagesError:
            return  # still fetch-pending; retried next step
        try:
            up = self.runner.upload_pages_device(pages)  # [L, n, ...]
            num_layers = up.shape[0]
            groups = min(self.stream_groups, num_layers)
            base, rem = divmod(num_layers, groups)
            l0 = 0
            for g in range(groups):
                span = base + (1 if g < rem else 0)
                self.runner.scatter_pages_from_device(
                    new_ids, _layer_slice(up, l0, span), layers=(l0, span))
                l0 += span
        except BaseException:
            self.allocator.free(new_ids)
            raise
        req.block_ids = [0] * lo + list(new_ids)
        for i in idxs:
            req.paged_out.pop(i, None)
        req.kv_fetch_pending = False
        self.pages_restored_total += len(idxs)

    def _refund(self, req: Request) -> None:
        """Fall back to a recompute from zero."""
        ids = [b for i, b in enumerate(req.block_ids) if i not in req.paged_out]
        if ids:
            self.allocator.free(ids)
        req.block_ids = []
        req.paged_out.clear()
        req.kv_fetch_pending = False
        req.num_computed_tokens = 0
        req.num_cached_tokens = 0
        self.sched.seed_commit_chain(req, _ROOT_HASH, 0)
        self.refunds_total += 1
        log.info("kv pager refund: %s recomputes from zero (host tier miss)", req.request_id)
