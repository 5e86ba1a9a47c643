"""Tiered KV offload: HBM -> host DRAM -> files -> the cross-slice store.

The port's own copy of ``llmd_tpu/kvtransfer/offload.py`` (``HostKVCache``,
``TieredEventSink``, ``OffloadConnector``):

  * save on commit: every page committed to the device prefix cache is
    also copied HBM -> host (one gather an engine step) and put in a
    host LRU with a page cap, keyed by the page's chained content hash;
  * restore on arrival: before a request is queued, host pages that
    extend the device cache's prefix run are copied host -> HBM and
    committed, so the ordinary prefix-cache hit takes them;
  * an optional file tier: pages the host LRU evicts are written to
    ``<fs_dir>/<hash hex>.npy`` by a writer thread (off the engine
    thread, where a step's spills stalled every running row, PERF.md §5)
    and loaded back on a miss; a new cache over the same directory indexes
    the files already there, so the tier outlives the process;
  * the store tier (``federation/``, ``kvstore/``): behind DRAM and files,
    the fleet-wide store. ``KVFederation`` publishes saved pages (policy
    ``save``) or hot pages the device evicts (``evict-hot``), and the
    restore walk fetches, in one round trip, the pages of the prompt's
    chain that no local tier holds; the tokens those pages spare are
    ``recompute_avoided_tokens``;
  * tier-honest events (``TieredEventSink``): a device eviction of a page a
    host tier still holds is announced as ``BlockStored(medium="cpu")``,
    not as a removal, so the router's index scores the pod's host tier.

A host page is one page of the runner's canonical bundle, ``[L, K, page,
2D]`` (MLA: ``[L, 1, page, Dl]``) in ``ModelRunner.staging_dtype`` (an int8
pool's pages dequantized). The engine's pages live in ``HostPagePool``'s
slabs of pinned memory, into which the save's copies from the device land
and from which a restore's copies to the device read: no page is copied on
the host, where one thread copies a page slower than the link moves it
(PERF.md §6). A file-tier page is a ``.npy`` of its bits (bf16 as
``uint16``, ``runner.pages_to_numpy``). A page fetched from the store is
restored to the device from the CPU tensor it was decoded into, and comes
into host DRAM as every committed page does: the save copies it from the
device into a slot.
"""

from __future__ import annotations

import collections
import logging
import os
import pathlib
import queue
import threading
import time

import numpy as np
import torch

from llmd_tpu_torch.engine.kv_cache import (
    KVEventSink,
    NoFreePagesError,
    page_hashes_for_tokens,
)
from llmd_tpu_torch.engine.runner import pages_to_numpy

log = logging.getLogger(__name__)

# Spilled pages that may wait for the file tier's writer; a spill past
# them waits on the engine thread, so the disk and not the host's memory
# sets the pace of a tier that spills faster than it writes.
FS_BACKLOG_PAGES = 256


class HostPagePool:
    """Host memory for the host tier's pages: slabs of ``slab_pages`` pages
    of ``shape`` and ``dtype`` (pinned where ``pin``) and a free list of
    their slots. ``reserve`` pages are allocated up front: pinning host
    memory is slow, and a save that pinned a new slab would pay for it
    inside its step (PERF.md §6), so the engine reserves its whole budget
    when it starts; past the reserve a slab is added when the free list
    runs out. ``take`` hands out a slot (a view of its slab), ``give``
    takes it back once the tier has let the page go (it ignores an
    ndarray, a file-tier page, and refuses a tensor of no slab, so the
    free list holds the slabs' slots only). A slot taken back is only
    written again by a later save, whose copy follows on the device
    whatever read it before (the compute stream waits for a restore's
    copy to the device before its scatter, and a later save's copy waits
    for a gather enqueued there after it); no host copy writes a slot.
    ``give`` may come from the file tier's writer thread."""

    def __init__(self, shape: tuple[int, ...], dtype: torch.dtype, pin: bool,
                 slab_pages: int = 64, reserve: int = 0) -> None:
        self.shape, self.dtype, self.pin, self.slab_pages = shape, dtype, pin, slab_pages
        self._slabs: list[torch.Tensor] = []
        self._slab_ptrs: set[int] = set()
        self._free: list[torch.Tensor] = []
        self._lock = threading.Lock()
        while len(self._free) < reserve:
            self._grow()

    def _grow(self) -> None:
        slab = torch.empty((self.slab_pages, *self.shape), dtype=self.dtype, pin_memory=self.pin)
        self._slabs.append(slab)
        self._slab_ptrs.add(slab.untyped_storage().data_ptr())
        self._free[:0] = reversed(slab.unbind(0))

    def take(self) -> torch.Tensor:
        with self._lock:
            if not self._free:
                self._grow()
            return self._free.pop()

    def give(self, page) -> None:
        if not isinstance(page, torch.Tensor):
            return
        with self._lock:
            if page.untyped_storage().data_ptr() not in self._slab_ptrs:
                raise ValueError("HostPagePool.give: not a slot of this pool")
            self._free.append(page)

    @property
    def bytes(self) -> int:
        """Host bytes the slabs hold."""
        return sum(t.numel() * t.element_size() for t in self._slabs)


class HostKVCache:
    """Host-DRAM page store, content hash -> page (an ndarray, or a host
    tensor of ``HostPagePool``): an LRU of at most ``max_pages`` pages,
    whose evictions spill to the file tier when ``fs_dir`` is set;
    ``release`` (if set) takes each page that leaves host DRAM. Thread-safe:
    the engine thread saves and restores, and the server's cache probe asks
    ``has`` from another thread.

    A spill is counted and indexed in the file tier when the page leaves
    the LRU (the counters and the tiers' contents are those of a cache
    that writes in place, as JAX's does); the writer thread then writes
    the file (to a temporary name, renamed when whole) and only then
    releases the page. Until then a load reads the page from memory, as
    the file will hold it. ``drain`` waits for the writes, ``close`` also
    stops the thread (a process that restarts over the directory closes
    its cache first).

    ``federation`` (a ``KVFederation``) is the store tier behind DRAM and
    files: a page saved for the first time goes to its publish policy, a
    page saved again or served from DRAM or files counts as a use in its
    hotness book, and the pages no local tier holds may be fetched from
    the store in one batch (``fetch_store_many``)."""

    def __init__(self, max_pages: int = 25_000, fs_dir: str | None = None,
                 fs_max_pages: int = 100_000, federation=None) -> None:
        self.max_pages = max_pages
        self.fs_dir = pathlib.Path(fs_dir) if fs_dir else None
        self.fs_max_pages = fs_max_pages
        self.federation = federation
        self.release = None
        self._lock = threading.Lock()
        self._pages: collections.OrderedDict[bytes, object] = collections.OrderedDict()
        self._fs_lru: collections.OrderedDict[bytes, None] = collections.OrderedDict()
        if self.fs_dir is not None:
            self.fs_dir.mkdir(parents=True, exist_ok=True)
            for f in sorted(self.fs_dir.glob("*.npy")):
                try:
                    self._fs_lru[bytes.fromhex(f.stem)] = None
                except ValueError:
                    continue
        self.saves = 0
        self.restores = 0
        self.fs_spills = 0
        self.fs_loads = 0
        # Pages on their way to their files, by hash, and the writer that
        # takes them from ``_spills`` (started at the first spill).
        self._writing: dict[bytes, object] = {}
        self._spills: queue.Queue = queue.Queue(maxsize=FS_BACKLOG_PAGES)
        self._writer: threading.Thread | None = None
        # The writer's seconds in its writes (``profile_step.py``).
        self.fs_write_s = 0.0

    def __len__(self) -> int:
        with self._lock:
            return len(self._pages)

    def has(self, h: bytes) -> bool:
        with self._lock:
            return h in self._pages or h in self._fs_lru

    def put(self, h: bytes, page, publish: bool = True) -> bool:
        """Insert (or refresh) a page; whether ``page`` was stored. A new
        page goes to the federation's publish policy unless ``publish`` is
        false (a page the store itself served); a refreshed one counts as
        a use."""
        with self._lock:
            stored = h not in self._pages
            if stored:
                self._pages[h] = page
                self.saves += 1
            else:
                self._pages.move_to_end(h)
            spill = []
            while len(self._pages) > self.max_pages:
                spill.append(self._pages.popitem(last=False))
        for old_h, old_p in spill:
            if not self._spill_fs(old_h, old_p):
                self._release(old_p)
        if self.federation is not None:
            if not stored:
                self.federation.touch(h)
            elif publish:
                self.federation.on_save(h, page)
        return stored

    def _release(self, page) -> None:
        if self.release is not None:
            self.release(page)

    def get(self, h: bytes):
        page, _ = self.get_tagged(h)
        return page

    def get_tagged(self, h: bytes) -> tuple[object, str | None]:
        """A page and the local tier that served it (``"dram"``, ``"fs"``),
        or (None, None). The restore walk fetches the store's pages in one
        batch (``fetch_store_many``)."""
        with self._lock:
            page = self._pages.get(h)
            if page is not None:
                self._pages.move_to_end(h)
                self.restores += 1
                if self.federation is not None:
                    self.federation.touch(h)
                return page, "dram"
        page = self._load_fs(h)
        if page is not None:
            with self._lock:
                self.restores += 1
            if self.federation is not None:
                self.federation.touch(h)
            return page, "fs"
        return None, None

    # ------------------------------------------------------------------ #
    # the store tier

    def fetch_store_many(self, hs: list[bytes]) -> dict:
        """The restore walk's store leg: every candidate hash in one
        federation round trip, as CPU tensors. JAX puts them in DRAM here;
        the port's DRAM holds only the pool's slots, which a host copy may
        not write while an upload from a recycled slot is still pending, so
        a fetched page comes into DRAM through the save of its restored
        device page (``OffloadConnector``, without a publication, as JAX's
        promotion). ``restores`` counts only the pages the walk takes
        (``note_store_restore``)."""
        if self.federation is None or not hs:
            return {}
        return self.federation.fetch_many(list(hs))

    def note_store_restore(self) -> None:
        """Count one page of a batched store fetch restored to the device."""
        with self._lock:
            self.restores += 1

    def note_use(self, h: bytes) -> None:
        """A device prefix hit the restore walk saw: a use for the hotness
        book (the device tier never calls ``get``)."""
        if self.federation is not None:
            self.federation.touch(h)

    def publish_evicted(self, h: bytes) -> None:
        """Publish on evict (``TieredEventSink.blocks_removed``): the device
        evicted a page this host still holds. The hotness gate runs here
        on the engine thread; the page is read (from DRAM, copied, or from
        its file) and framed on the store's publisher thread."""
        fed = self.federation
        if fed is None or not fed.wants_publish_on_evict(h):
            return

        def loader():
            with self._lock:
                page = self._pages.get(h)
                # A pinned slot goes back to the pool when the page leaves
                # DRAM, and a later save writes it: copy it while it is ours.
                if isinstance(page, torch.Tensor):
                    page = page.clone()
            return page if page is not None else self._load_fs(h)

        fed.publish_deferred(h, loader)

    # ------------------------------------------------------------------ #
    # the file tier

    def _path(self, h: bytes) -> pathlib.Path:
        return self.fs_dir / f"{h.hex()}.npy"

    def _unlink(self, h: bytes) -> None:
        try:
            self._path(h).unlink(missing_ok=True)
        except OSError:
            pass

    def _spill_fs(self, h: bytes, page) -> bool:
        """Hand a page the LRU evicted to the writer; whether it took it
        (it releases the page once written)."""
        if self.fs_dir is None:
            return False
        with self._lock:
            self._fs_lru[h] = None
            self._writing[h] = page
            self.fs_spills += 1
            evicted = []
            while len(self._fs_lru) > self.fs_max_pages:
                old, _ = self._fs_lru.popitem(last=False)
                if old not in self._writing:  # else the writer drops its file
                    evicted.append(old)
            if self._writer is None:
                self._writer = threading.Thread(target=self._write_spills,
                                                name="llmd-kv-fs-writer", daemon=True)
                self._writer.start()
        self._spills.put((h, page))
        for old in evicted:
            self._unlink(old)
        return True

    def _write_spills(self) -> None:
        while True:
            item = self._spills.get()
            try:
                if item is None:
                    return
                h, page = item
                t0 = time.perf_counter()
                path = self._path(h)
                tmp = path.with_name(path.name + ".tmp")
                try:
                    with open(tmp, "wb") as f:
                        np.save(f, page if isinstance(page, np.ndarray) else pages_to_numpy(page))
                    os.replace(tmp, path)
                    written = True
                except Exception:  # the writer must outlive a bad page or disk
                    log.exception("FS spill failed")
                    written = False
                with self._lock:
                    if self._writing.get(h) is page:
                        del self._writing[h]
                    if not written:
                        self._fs_lru.pop(h, None)
                    kept = h in self._fs_lru
                    self.fs_write_s += time.perf_counter() - t0
                if not kept:  # evicted or dropped while it was written
                    self._unlink(h)
                self._release(page)
            finally:
                self._spills.task_done()

    def drain(self) -> None:
        """Wait until every page spilled so far is in its file."""
        self._spills.join()

    def close(self) -> None:
        """Finish the spills and stop the writer."""
        with self._lock:
            writer, self._writer = self._writer, None
        if writer is not None:
            self._spills.put(None)
            writer.join()

    def _load_fs(self, h: bytes) -> np.ndarray | None:
        if self.fs_dir is None:
            return None
        with self._lock:
            if h not in self._fs_lru:
                return None
            page = self._writing.get(h)
            if page is not None:  # not written yet: the bits its file will hold
                self.fs_loads += 1
                return np.array(page if isinstance(page, np.ndarray) else pages_to_numpy(page))
        try:
            page = np.load(self._path(h))
        except (OSError, ValueError):
            with self._lock:
                self._fs_lru.pop(h, None)
            return None
        with self._lock:
            self.fs_loads += 1
        return page

    def drop(self, h: bytes) -> None:
        with self._lock:
            page = self._pages.pop(h, None)
            had_fs = self._fs_lru.pop(h, None) is not None
        if page is not None:
            self._release(page)
        if had_fs:
            self._unlink(h)

    def clear(self) -> None:
        """Drop every tier (new weights: the cached KV no longer matches);
        the store keeps other hosts' pages, this host withdraws its own."""
        self.drain()
        with self._lock:
            pages = list(self._pages.values())
            self._pages.clear()
            fs = list(self._fs_lru)
            self._fs_lru.clear()
        for page in pages:
            self._release(page)
        for h in fs:
            self._unlink(h)
        if self.federation is not None:
            self.federation.clear_local()

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "pages": len(self._pages),
                "fs_pages": len(self._fs_lru),
                "saves": self.saves,
                "restores": self.restores,
                "fs_spills": self.fs_spills,
                "fs_loads": self.fs_loads,
            }


class TieredEventSink(KVEventSink):
    """The engine's event sink with tier-honest events (JAX
    ``offload.py:285``): a device eviction of a page a host tier still
    holds is announced as ``BlockStored(medium="cpu")`` (the pod can still
    serve it, from host memory) and is the publish-on-evict trigger. Each
    event names its medium as an argument, so the store client's threads
    (``KVFederation``'s publications and withdrawals, medium ``store``,
    sent to ``inner`` directly) and the engine thread share no state
    here."""

    def __init__(self, inner: KVEventSink, host: HostKVCache) -> None:
        self.inner = inner
        self.host = host

    def blocks_stored(self, hashes, parent, token_ids, medium=None) -> None:
        self.inner.blocks_stored(hashes, parent, token_ids, medium)

    def blocks_removed(self, hashes, medium=None) -> None:
        gone, kept = [], []
        for h in hashes:
            (kept if self.host.has(h) else gone).append(h)
        if gone:
            self.inner.blocks_removed(gone, medium)
        if kept:
            for h in kept:
                self.host.publish_evicted(h)
            self.inner.blocks_stored(kept, None, [], "cpu")

    def all_cleared(self) -> None:
        # The device is cleared, the host tiers may not be: announce a clear
        # only when they hold nothing.
        if len(self.host) == 0:
            self.inner.all_cleared()


class OffloadConnector:
    """The engine's side of the tiers: save committed pages, restore them
    for a prompt.

    The save path has two halves. ``launch`` enqueues the copies of the
    pages committed since the last call into slots of ``pool``
    (``ModelRunner.launch_page_copies``: the gather on the compute stream,
    so it reads the pages as the committing step left them, and a step
    dispatched after it writes nothing it reads; the copies to the host on
    a stream of their own); ``finish`` waits for those copies and puts the
    pages in the host cache. The synchronous engine calls both after a
    step's commit (``flush``); the async engine launches before it
    dispatches the next step and finishes while that step runs."""

    def __init__(self, runner, allocator, host: HostKVCache) -> None:
        self.runner = runner
        self.allocator = allocator
        self.host = host
        # The host budget, one step's commits beyond it (a step's pages
        # take their slots before the host cache evicts for them) and the
        # pages that wait for the file tier's writer.
        backlog = FS_BACKLOG_PAGES if host.fs_dir is not None else 0
        self.pool = HostPagePool(runner.page_shape, runner.staging_dtype,
                                 pin=runner.device.type == "cuda",
                                 reserve=host.max_pages + allocator.num_pages // 8 + backlog)
        host.release = self.pool.give
        # (content hash, page id, whether to publish) committed since the
        # last launch, and the store pages a restore is committing (saved
        # without a publication: the store has them).
        self._pending: list[tuple[bytes, int, bool]] = []
        self._fetched: set[bytes] = set()
        # Copies launched and not finished: (their pending list, their host
        # pages, the copies' event).
        self._launched: list[tuple[list[tuple[bytes, int, bool]], list[torch.Tensor], object]] = []
        # Host seconds in launch + finish and in restores, and the bytes
        # saved (``profile_step.py``, ``chip_smoke.py``).
        self.save_host_s = 0.0
        self.restore_host_s = 0.0
        self.saved_bytes = 0
        # Prompt tokens whose prefill pages fetched from the store served
        # (committed), and those pages.
        self.recompute_avoided_tokens = 0
        self.store_pages_committed = 0

    # -- save ------------------------------------------------------------ #

    def on_commit(self, page_id: int, content_hash: bytes) -> None:
        """``PageAllocator.commit_hook``."""
        if not self.host.has(content_hash):
            self._pending.append((content_hash, page_id, content_hash not in self._fetched))

    def launch(self) -> None:
        if not self._pending:
            return
        t0 = time.perf_counter()
        pending, self._pending = self._pending, []
        slots = [self.pool.take() for _ in pending]
        done = self.runner.launch_page_copies([pid for _, pid, _ in pending], slots)
        self._launched.append((pending, slots, done))
        self.save_host_s += time.perf_counter() - t0

    def finish(self) -> None:
        if not self._launched:
            return
        t0 = time.perf_counter()
        launched, self._launched = self._launched, []
        for pending, slots, done in launched:
            self.runner.wait_copies(done)
            for (h, _, publish), slot in zip(pending, slots):
                self.saved_bytes += slot.numel() * slot.element_size()
                if not self.host.put(h, slot, publish):
                    self.pool.give(slot)  # the same content saved twice in one step
        self.save_host_s += time.perf_counter() - t0

    def flush(self) -> None:
        """Save the pages committed this step (JAX ``flush``)."""
        self.launch()
        self.finish()

    # -- restore --------------------------------------------------------- #

    def restore_for_prompt(self, prompt_token_ids: list[int]) -> int:
        """Seed the device prefix cache from the host tiers: the leading
        full pages of the prompt that the device misses and a tier holds,
        up to the first page none holds, are copied into fresh pages,
        committed, and their references dropped (the prefix-cache hit
        takes them). At the first page no local tier holds, the rest of
        the chain that no tier holds is fetched from the store in one
        round trip (JAX ``offload.py:415-474``). Under page pressure
        nothing is restored (the prompt is computed instead). Returns the
        pages restored."""
        t0 = time.perf_counter()
        page = self.allocator.page_size
        hashes = page_hashes_for_tokens(prompt_token_ids, page)
        restore: list[tuple[int, bytes, object]] = []
        store_batch: dict = {}
        store_batched = False
        for idx, h in enumerate(hashes):
            if self.allocator.has_cached(h):
                self.host.note_use(h)  # a use for the hotness book
                continue
            if store_batched and h in store_batch:
                # Fetched by this walk.
                data, tier = store_batch[h], "store"
                self.host.note_store_restore()
            else:
                data, tier = self.host.get_tagged(h)
            if data is None:
                if not store_batched:
                    # Only pages no local tier holds go to the store.
                    store_batched = True
                    store_batch = self.host.fetch_store_many([
                        h2 for h2 in hashes[idx:]
                        if not self.allocator.has_cached(h2) and not self.host.has(h2)])
                    data = store_batch.get(h)
                    if data is not None:
                        tier = "store"
                        self.host.note_store_restore()
                if data is None:
                    break  # the chain breaks: nothing past here is usable
            if tier == "store":
                self._fetched.add(h)
            restore.append((idx, h, data))
        store_pages = len(self._fetched)
        if not restore:
            self._fetched.clear()
            return 0
        try:
            page_ids = self.allocator.allocate(len(restore))
        except NoFreePagesError:
            self._fetched.clear()
            return 0
        try:
            self.runner.scatter_pages(page_ids, [d for _, _, d in restore])
            for pid, (idx, h, _) in zip(page_ids, restore):
                self.allocator.commit_page(pid, h, prompt_token_ids[idx * page : (idx + 1) * page],
                                           hashes[idx - 1] if idx > 0 else None)
        finally:
            # A failed restore falls back to computing the prompt; it must
            # not keep the pages it took.
            self._fetched.clear()
            self.allocator.free(page_ids)
        if store_pages:
            # The store pages' saves into host DRAM start now, while their
            # device pages hold what was restored (free and cached, a later
            # step could evict them before its own save).
            self.launch()
            # Counted once the commit landed: these tokens' prefill now
            # rides the prefix cache.
            self.store_pages_committed += store_pages
            self.recompute_avoided_tokens += store_pages * page
        self.restore_host_s += time.perf_counter() - t0
        return len(page_ids)
