"""Paged KV cache: host-side page allocator with automatic prefix caching.

The device pool is one stacked tensor per engine (layer-major); this
module manages page lifetimes on the host: a free list, per-page refcounts,
and a content-addressed index of full pages (hash-chained over token ids)
giving automatic prefix caching. Evicted-but-cached pages live in an LRU
so a cache hit can resurrect them until they are reused for new data.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import threading
from collections.abc import Iterable, Sequence

# Sentinel parent hash for the first page of a sequence.
_ROOT_HASH = b"llmd-root"


def hash_page(parent_hash: bytes, token_ids: Sequence[int], extra: bytes = b"") -> bytes:
    """Chained content hash of one full page. ``extra`` folds in the
    request's cache identity (a LoRA adapter's ``lora:<name>``, from
    ``EngineScheduler.hash_extra``), so one adapter's pages never serve
    the base model or another adapter."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent_hash)
    h.update(b"|")
    h.update(b",".join(str(t).encode() for t in token_ids))
    if extra:
        h.update(b"#")
        h.update(extra)
    return h.digest()


def page_hashes_for_tokens(token_ids: Sequence[int], page_size: int,
                           extra: bytes = b"") -> list[bytes]:
    """Hashes of all *full* pages covering a token prefix."""
    hashes: list[bytes] = []
    parent = _ROOT_HASH
    for start in range(0, len(token_ids) - page_size + 1, page_size):
        parent = hash_page(parent, token_ids[start : start + page_size], extra)
        hashes.append(parent)
    return hashes


def _locked(fn):
    """Run an allocator method under the instance's lock."""

    @functools.wraps(fn)
    def inner(self, *a, **k):
        with self._lock:
            return fn(self, *a, **k)

    return inner


class KVEventSink:
    """Where the allocator's KV events go (JAX ``engine/kv_cache.py:64``):
    ``blocks_stored`` when a page's content is registered for reuse,
    ``blocks_removed`` when a cached page is reused for new content,
    ``all_cleared`` when the whole cache is dropped. The router's precise
    prefix scorer indexes them. This one drops them; the server installs
    ``events.ZMQEventSink`` when ``--kv-events-endpoint`` is given.
    ``medium`` names the tier an event is about (the allocator leaves it
    None: the sink's own, the device; the tiered sink passes ``cpu`` and
    ``store``)."""

    def blocks_stored(self, hashes: list[bytes], parent: bytes | None,
                      token_ids: list[int], medium: str | None = None) -> None:
        pass

    def blocks_removed(self, hashes: list[bytes], medium: str | None = None) -> None:
        pass

    def all_cleared(self) -> None:
        pass


@dataclasses.dataclass
class PageMeta:
    ref_count: int = 0
    content_hash: bytes | None = None


class PageAllocator:
    """Refcounted page allocator with a content-addressed reuse index.

    The engine thread owns it; a P/D fetch thread allocates and frees a
    streamed import's pages, so the methods that change it hold a lock.
    ``event_sink`` sees each page stored, each cached page evicted and each
    clear, at JAX's three sites."""

    def __init__(
        self, num_pages: int, page_size: int, enable_prefix_caching: bool = True,
        event_sink: KVEventSink | None = None,
    ) -> None:
        self.num_pages = num_pages
        self.page_size = page_size
        self.enable_prefix_caching = enable_prefix_caching
        self.event_sink = event_sink or KVEventSink()
        self._lock = threading.RLock()
        self._meta = [PageMeta() for _ in range(num_pages)]
        # Pages with ref_count == 0, LRU-ordered: left = oldest = evict first.
        # Freed cached pages are appended right so hot content survives longest.
        self._free: collections.OrderedDict[int, None] = collections.OrderedDict(
            (i, None) for i in range(num_pages)
        )
        # content hash -> page id (only pages whose content is intact).
        self._cached: dict[bytes, int] = {}
        self.metrics_hits = 0
        self.metrics_queries = 0
        # Called with (page id, content hash) on every commit that
        # registers content (the tiered offload's save path).
        self.commit_hook = None

    @property
    def num_free_pages(self) -> int:
        return len(self._free)

    def usage(self) -> float:
        return 1.0 - len(self._free) / self.num_pages

    def lookup_and_touch_prefix(
        self, token_ids: Sequence[int], max_pages: int | None = None, extra: bytes = b""
    ) -> list[int]:
        """The leading run of cached full pages for this prompt (up to
        ``max_pages``), its hashes salted by ``extra``, referenced
        atomically."""
        if not self.enable_prefix_caching:
            return []
        hashes = page_hashes_for_tokens(token_ids, self.page_size, extra)
        if max_pages is not None:
            hashes = hashes[:max_pages]
        return self.lookup_and_touch_hashes(hashes)

    def peek_hash_run(self, hashes: Sequence[bytes]) -> int:
        """Length of the leading cached run of a hash chain, touching
        nothing and counting no query: a probe (the hybrid ring hit's)."""
        n = 0
        for h in hashes:
            if h not in self._cached:
                break
            n += 1
        return n

    def has_cached(self, content_hash: bytes) -> bool:
        """Whether a page holds this content: a lookup that takes no
        reference, counts no query and moves nothing in the LRU."""
        return content_hash in self._cached

    @_locked
    def lookup_and_touch_hashes(self, hashes: Sequence[bytes]) -> list[int]:
        """The leading run of cached pages of a hash chain the caller
        already holds, referenced."""
        if not self.enable_prefix_caching:
            return []
        pages: list[int] = []
        for h in hashes:
            self.metrics_queries += 1
            pid = self._cached.get(h)
            if pid is None:
                break
            self.metrics_hits += 1
            pages.append(pid)
        if pages:
            self.touch(pages)
        return pages

    @_locked
    def touch(self, page_ids: Iterable[int]) -> None:
        """Take a reference on cached pages (prefix-cache hit path)."""
        for pid in page_ids:
            meta = self._meta[pid]
            if meta.ref_count == 0:
                del self._free[pid]  # resurrect from the free LRU
            meta.ref_count += 1

    @_locked
    def allocate(self, n: int) -> list[int]:
        """Allocate n fresh pages (ref=1), evicting cached content LRU-first."""
        if n > len(self._free):
            raise NoFreePagesError(n, len(self._free))
        out: list[int] = []
        for _ in range(n):
            pid, _ = self._free.popitem(last=False)
            meta = self._meta[pid]
            if meta.content_hash is not None:
                # Evicted: the page is reused for new content.
                self._cached.pop(meta.content_hash, None)
                self.event_sink.blocks_removed([meta.content_hash])
                meta.content_hash = None
            meta.ref_count = 1
            out.append(pid)
        return out

    @_locked
    def allocate_with_floor(self, n: int, floor: int) -> list[int]:
        """``allocate(n)`` only if at least ``floor`` free pages remain after
        it, in one locked call (a streamed import's reservation must leave
        the decode headroom); NoFreePagesError otherwise."""
        if len(self._free) - n < floor:
            raise NoFreePagesError(n + floor, len(self._free))
        return self.allocate(n)

    @_locked
    def commit_page(self, page_id: int, content_hash: bytes, token_ids: Sequence[int],
                    parent: bytes | None) -> None:
        """Register a now-full page's content (its ``token_ids``, chained on
        ``parent``) for reuse, unless another page already holds that
        content; the event sink and ``commit_hook`` see each
        registration."""
        if not self.enable_prefix_caching:
            return
        existing = self._cached.get(content_hash)
        if existing is not None and existing != page_id:
            return
        self._cached[content_hash] = page_id
        self._meta[page_id].content_hash = content_hash
        self.event_sink.blocks_stored([content_hash], parent, token_ids)
        if self.commit_hook is not None:
            self.commit_hook(page_id, content_hash)

    @_locked
    def free(self, page_ids: Iterable[int]) -> None:
        for pid in page_ids:
            meta = self._meta[pid]
            if meta.ref_count <= 0:
                raise AssertionError(f"double free of page {pid}")
            meta.ref_count -= 1
            if meta.ref_count == 0:
                # Cached pages go to the LRU tail (evicted last); uncached
                # pages to the head (reused first).
                self._free[pid] = None
                if meta.content_hash is None:
                    self._free.move_to_end(pid, last=False)

    @_locked
    def clear(self) -> None:
        """Forget every page's content (new weights: the cached KV no
        longer matches); the references stay."""
        self._cached.clear()
        for meta in self._meta:
            meta.content_hash = None
        self.event_sink.all_cleared()

    def hit_ratio(self) -> float:
        if not self.metrics_queries:
            return 0.0
        return self.metrics_hits / self.metrics_queries


class NoFreePagesError(RuntimeError):
    def __init__(self, wanted: int, available: int) -> None:
        super().__init__(f"wanted {wanted} KV pages, {available} free")
        self.wanted = wanted
        self.available = available
