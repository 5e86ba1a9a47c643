"""Tiered KV offload: HBM -> host DRAM -> files.

The port's own copy of ``llmd_tpu/kvtransfer/offload.py`` (``HostKVCache``,
``OffloadConnector``), without the cross-slice store and federation tiers
and without the KV-event sink, which wait for later parts of ROADMAP.md
queue 1 item 7:

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
    the files already there, so the tier outlives the process.

A host page is one page of the runner's canonical bundle, ``[L, K, page,
2D]`` (MLA: ``[L, 1, page, Dl]``) in ``ModelRunner.staging_dtype`` (an int8
pool's pages dequantized). The engine's pages live in ``HostPagePool``'s
slabs of pinned memory, into which the save's copies from the device land
and from which a restore's copies to the device read: no page is copied on
the host, where one thread copies a page slower than the link moves it
(PERF.md §6). A file-tier page is a ``.npy`` of its bits (bf16 as
``uint16``, ``runner.pages_to_numpy``).
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

from llmd_tpu_torch.engine.kv_cache import NoFreePagesError, page_hashes_for_tokens
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
    takes it back once the tier has let the page go. A slot taken back is
    only written again by a later save, whose copy follows on the device
    whatever read it before (the compute stream waits for a restore's
    copy to the device before its scatter, and a later save's copy waits
    for a gather enqueued there after it). ``give`` may come
    from the file tier's writer thread."""

    def __init__(self, shape: tuple[int, ...], dtype: torch.dtype, pin: bool,
                 slab_pages: int = 64, reserve: int = 0) -> None:
        self.shape, self.dtype, self.pin, self.slab_pages = shape, dtype, pin, slab_pages
        self._slabs: list[torch.Tensor] = []
        self._free: list[torch.Tensor] = []
        self._lock = threading.Lock()
        while len(self._free) < reserve:
            self._grow()

    def _grow(self) -> None:
        slab = torch.empty((self.slab_pages, *self.shape), dtype=self.dtype, pin_memory=self.pin)
        self._slabs.append(slab)
        self._free[:0] = reversed(slab.unbind(0))

    def take(self) -> torch.Tensor:
        with self._lock:
            if not self._free:
                self._grow()
            return self._free.pop()

    def give(self, page) -> None:
        if isinstance(page, torch.Tensor):
            with self._lock:
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
    its cache first)."""

    def __init__(self, max_pages: int = 25_000, fs_dir: str | None = None,
                 fs_max_pages: int = 100_000) -> None:
        self.max_pages = max_pages
        self.fs_dir = pathlib.Path(fs_dir) if fs_dir else None
        self.fs_max_pages = fs_max_pages
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

    def put(self, h: bytes, page) -> bool:
        """Insert (or refresh) a page; whether ``page`` was stored."""
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
        return stored

    def _release(self, page) -> None:
        if self.release is not None:
            self.release(page)

    def get(self, h: bytes):
        page, _ = self.get_tagged(h)
        return page

    def get_tagged(self, h: bytes) -> tuple[object, str | None]:
        """A page and the tier that served it (``"dram"``, ``"fs"``), or
        (None, None)."""
        with self._lock:
            page = self._pages.get(h)
            if page is not None:
                self._pages.move_to_end(h)
                self.restores += 1
                return page, "dram"
        page = self._load_fs(h)
        if page is not None:
            with self._lock:
                self.restores += 1
            return page, "fs"
        return None, None

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
        """Drop every tier (new weights: the cached KV no longer matches)."""
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
        # (content hash, page id) committed since the last launch.
        self._pending: list[tuple[bytes, int]] = []
        # Copies launched and not finished: (their pending list, their host
        # pages, the copies' event).
        self._launched: list[tuple[list[tuple[bytes, int]], list[torch.Tensor], object]] = []
        # Host seconds in launch + finish and in restores, and the bytes
        # saved (``profile_step.py``, ``chip_smoke.py``).
        self.save_host_s = 0.0
        self.restore_host_s = 0.0
        self.saved_bytes = 0

    # -- save ------------------------------------------------------------ #

    def on_commit(self, page_id: int, content_hash: bytes) -> None:
        """``PageAllocator.commit_hook``."""
        if not self.host.has(content_hash):
            self._pending.append((content_hash, page_id))

    def launch(self) -> None:
        if not self._pending:
            return
        t0 = time.perf_counter()
        pending, self._pending = self._pending, []
        slots = [self.pool.take() for _ in pending]
        done = self.runner.launch_page_copies([pid for _, pid in pending], slots)
        self._launched.append((pending, slots, done))
        self.save_host_s += time.perf_counter() - t0

    def finish(self) -> None:
        if not self._launched:
            return
        t0 = time.perf_counter()
        launched, self._launched = self._launched, []
        for pending, slots, done in launched:
            self.runner.wait_copies(done)
            for (h, _), slot in zip(pending, slots):
                self.saved_bytes += slot.numel() * slot.element_size()
                if not self.host.put(h, slot):
                    self.pool.give(slot)  # the same content saved twice in one step
        self.save_host_s += time.perf_counter() - t0

    def flush(self) -> None:
        """Save the pages committed this step (JAX ``flush``)."""
        self.launch()
        self.finish()

    # -- restore --------------------------------------------------------- #

    def restore_for_prompt(self, prompt_token_ids: list[int]) -> int:
        """Seed the device prefix cache from the host tiers: the leading
        full pages of the prompt that the device misses and a host tier
        holds, up to the first page neither holds, are copied into fresh
        pages, committed, and their references dropped (the prefix-cache
        hit takes them). Under page pressure nothing is restored (the
        prompt is computed instead). Returns the pages restored."""
        t0 = time.perf_counter()
        page = self.allocator.page_size
        hashes = page_hashes_for_tokens(prompt_token_ids, page)
        restore: list[tuple[int, bytes, object]] = []
        for idx, h in enumerate(hashes):
            if self.allocator.has_cached(h):
                continue
            data = self.host.get(h)
            if data is None:
                break  # the chain breaks: nothing past here is usable
            restore.append((idx, h, data))
        if not restore:
            return 0
        try:
            page_ids = self.allocator.allocate(len(restore))
        except NoFreePagesError:
            return 0
        try:
            self.runner.scatter_pages(page_ids, [d for _, _, d in restore])
            for pid, (_, h, _) in zip(page_ids, restore):
                self.allocator.commit_page(pid, h)
        finally:
            # A failed restore falls back to computing the prompt; it must
            # not keep the pages it took.
            self.allocator.free(page_ids)
        self.restore_host_s += time.perf_counter() - t0
        return len(page_ids)
