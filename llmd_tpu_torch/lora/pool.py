"""The paged adapter pool: a fixed set of device slots of rank ``r`` over
an unbounded registry (JAX ``llmd_tpu/lora/pool.py``).

The KV pool's pattern applied to adapter weights: ``num_slots`` device
slots (the model's ``num_lora_adapters``, slot ids from 1) hold the
resident working set, the registry every loadable adapter. Residency is
LRU with pin-while-referenced: a slot that a running or queued row names
is never evicted (``pinned`` scans the scheduler's lists), and a cold
adapter is installed at a step boundary, so the batch never stalls on one
tenant's miss. Rows see only slot ids; the prefix cache salts adapter
pages by name, not slot, so reusing a slot for another tenant is safe for
the cache and an adapter's pages outlive its eviction.

Threads: the engine thread resolves names and drains the loading queue;
the server's load and unload threads register, install into free slots
and remove. One lock guards the pool's state. Admission leases
(``acquire``) pin a name from its resolution until its row is where the
pinned scan sees it; the eviction scan honours leases and pins under the
lock; two installs of one name racing keep the winner's slot and give the
loser's back; ``remove`` checks the references again under the lock. A
slot is written outside the lock (reserved meanwhile; the runner's device
lock orders the write) and published only once its weights are in.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable

from llmd_tpu_torch.lora.registry import AdapterRegistry


class AdapterPool:
    def __init__(self, registry: AdapterRegistry, install: Callable[[int, dict], None],
                 num_slots: int, pinned: Callable[[str], bool] | None = None) -> None:
        if num_slots <= 0:
            raise ValueError("AdapterPool needs at least one slot")
        self.registry = registry
        self.num_slots = num_slots
        self._install_fn = install
        self._pinned = pinned or (lambda name: False)
        self._lock = threading.Lock()
        # name -> slot of the resident adapters, published after install.
        self._slot_of: dict[str, int] = {}
        # Residency recency, least recent first (the eviction scan's order).
        self._lru: collections.OrderedDict[str, None] = collections.OrderedDict()
        self._free: list[int] = list(range(1, num_slots + 1))
        self._evictions = 0
        self._cold_loads = 0
        # Admission leases: names resolved by ``add_request`` whose rows
        # the pinned scan cannot see yet; the eviction scan counts them
        # as pinned.
        self._acquiring: dict[str, int] = {}

    # -- reads -------------------------------------------------------------- #

    def slot_of(self, name: str) -> int | None:
        with self._lock:
            return self._slot_of.get(name)

    def acquire(self, name: str) -> int | None:
        """``name``'s resident slot, with an admission lease that pins it
        until ``release_acquire``; None when it is not resident (no lease)."""
        with self._lock:
            slot = self._slot_of.get(name)
            if slot is None:
                return None
            self._lru.move_to_end(name)
            self._acquiring[name] = self._acquiring.get(name, 0) + 1
            return slot

    def release_acquire(self, name: str) -> None:
        with self._lock:
            n = self._acquiring.get(name, 0) - 1
            if n <= 0:
                self._acquiring.pop(name, None)
            else:
                self._acquiring[name] = n

    def touch(self, name: str) -> None:
        """A request for ``name``: it becomes the most recent."""
        with self._lock:
            if name in self._lru:
                self._lru.move_to_end(name)

    def resident_names(self) -> list[str]:
        with self._lock:
            return sorted(self._slot_of)

    def counters(self) -> dict:
        with self._lock:
            return {"resident": len(self._slot_of), "evictions": self._evictions,
                    "cold_loads": self._cold_loads}

    # -- install and evict --------------------------------------------------- #

    def _take_slot_locked(self, allow_evict: bool) -> int | None:
        if self._free:
            return self._free.pop()
        if not allow_evict:
            return None
        # The least recently used resident that no row references: a
        # referenced slot is read by every step, and replacing it would
        # mix weights within a stream.
        for name in self._lru:
            if name in self._acquiring or self._pinned(name):
                continue
            slot = self._slot_of.pop(name)
            del self._lru[name]
            self._evictions += 1
            return slot
        return None

    def _publish_slot_locked(self, name: str, slot: int) -> None:
        self._slot_of[name] = slot
        self._lru[name] = None
        self._lru.move_to_end(name)

    def _install(self, name: str, allow_evict: bool) -> int | None:
        rec = self.registry.get(name)
        if rec is None:
            raise KeyError(f"adapter {name!r} is not registered")
        with self._lock:
            slot = self._slot_of.get(name)
            if slot is not None:
                self._lru.move_to_end(name)
                return slot
            slot = self._take_slot_locked(allow_evict)
            if slot is None:
                return None
        try:
            self._install_fn(slot, rec.weights)
        except BaseException:
            with self._lock:
                self._free.append(slot)
            raise
        with self._lock:
            existing = self._slot_of.get(name)
            if existing is not None:
                # Another install of this name published first: keep its
                # slot and give ours back (both wrote the same weights).
                self._free.append(slot)
                self._lru.move_to_end(name)
                return existing
            self._publish_slot_locked(name, slot)
            return slot

    def install_cold(self, name: str) -> int | None:
        """A cold load on the engine thread, at a step boundary: evicts an
        idle least recently used resident when no slot is free. None when
        every slot is pinned: the caller keeps the requests waiting."""
        slot = self._install(name, allow_evict=True)
        if slot is not None:
            with self._lock:
                self._cold_loads += 1
        return slot

    def install_prefetch(self, name: str) -> int | None:
        """Residency at load time, into a free slot only (no eviction off
        the engine thread). None when the pool is full: the adapter stays
        one cold load away."""
        return self._install(name, allow_evict=False)

    def remove(self, name: str) -> bool:
        """Unload: free the adapter's slot. References are checked again
        under the lock, so a row admitted since the caller's check still
        refuses it."""
        with self._lock:
            slot = self._slot_of.get(name)
            if slot is None:
                return False
            if name in self._acquiring or self._pinned(name):
                raise RuntimeError(f"cannot remove adapter {name!r}: request(s) in flight")
            del self._slot_of[name]
            self._lru.pop(name, None)
            self._free.append(slot)
            return True
