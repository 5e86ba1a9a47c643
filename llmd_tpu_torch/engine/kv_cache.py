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
import hashlib
from collections.abc import Iterable, Sequence

# Sentinel parent hash for the first page of a sequence.
_ROOT_HASH = b"llmd-root"


def hash_page(parent_hash: bytes, token_ids: Sequence[int]) -> bytes:
    """Chained content hash of one full page (the JAX package's with no
    ``extra``: the port's requests carry no LoRA or other cache salt)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent_hash)
    h.update(b"|")
    h.update(b",".join(str(t).encode() for t in token_ids))
    return h.digest()


def page_hashes_for_tokens(token_ids: Sequence[int], page_size: int) -> list[bytes]:
    """Hashes of all *full* pages covering a token prefix."""
    hashes: list[bytes] = []
    parent = _ROOT_HASH
    for start in range(0, len(token_ids) - page_size + 1, page_size):
        parent = hash_page(parent, token_ids[start : start + page_size])
        hashes.append(parent)
    return hashes


@dataclasses.dataclass
class PageMeta:
    ref_count: int = 0
    content_hash: bytes | None = None


class PageAllocator:
    """Refcounted page allocator with a content-addressed reuse index.

    Not thread-safe: the engine thread owns it."""

    def __init__(
        self, num_pages: int, page_size: int, enable_prefix_caching: bool = True
    ) -> None:
        self.num_pages = num_pages
        self.page_size = page_size
        self.enable_prefix_caching = enable_prefix_caching
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

    @property
    def num_free_pages(self) -> int:
        return len(self._free)

    def usage(self) -> float:
        return 1.0 - len(self._free) / self.num_pages

    def lookup_and_touch_prefix(
        self, token_ids: Sequence[int], max_pages: int | None = None
    ) -> list[int]:
        """The leading run of cached full pages for this prompt (up to
        ``max_pages``), referenced atomically."""
        if not self.enable_prefix_caching:
            return []
        hashes = page_hashes_for_tokens(token_ids, self.page_size)
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

    def touch(self, page_ids: Iterable[int]) -> None:
        """Take a reference on cached pages (prefix-cache hit path)."""
        for pid in page_ids:
            meta = self._meta[pid]
            if meta.ref_count == 0:
                del self._free[pid]  # resurrect from the free LRU
            meta.ref_count += 1

    def allocate(self, n: int) -> list[int]:
        """Allocate n fresh pages (ref=1), evicting cached content LRU-first."""
        if n > len(self._free):
            raise NoFreePagesError(n, len(self._free))
        out: list[int] = []
        for _ in range(n):
            pid, _ = self._free.popitem(last=False)
            meta = self._meta[pid]
            if meta.content_hash is not None:
                self._cached.pop(meta.content_hash, None)
                meta.content_hash = None
            meta.ref_count = 1
            out.append(pid)
        return out

    def commit_page(self, page_id: int, content_hash: bytes) -> None:
        """Register a now-full page's content for reuse, unless another
        page already holds that content."""
        if not self.enable_prefix_caching or content_hash in self._cached:
            return
        self._cached[content_hash] = page_id
        self._meta[page_id].content_hash = content_hash

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

    def hit_ratio(self) -> float:
        if not self.metrics_queries:
            return 0.0
        return self.metrics_hits / self.metrics_queries


class NoFreePagesError(RuntimeError):
    def __init__(self, wanted: int, available: int) -> None:
        super().__init__(f"wanted {wanted} KV pages, {available} free")
        self.wanted = wanted
        self.available = available
