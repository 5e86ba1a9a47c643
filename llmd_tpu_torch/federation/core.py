"""One engine's membership in the fleet-wide prefix cache: the port's copy
of ``llmd_tpu/federation/core.py``.

It joins the host tiers (``kvtransfer/offload.py``), the cross-slice store
(``kvstore/``) and the KV events (``events/``) into one prefix cache across
replicas:

- **publish**: under the ``save`` policy every page the host tier saves is
  framed (``federation/wire.py``), registered with this host's shipper and
  put to the master, all on the store client's publisher thread; under
  ``evict-hot`` a page waits until the device cache evicts it while the
  host tier still holds it, and goes only if its hash was used
  ``publish_min_hits`` times (the hotness book); ``off`` only fetches. A
  publication the master accepts is announced as ``BlockStored(medium=
  "store")``; one the master's watermark evicts later is withdrawn with
  ``BlockRemoved(medium="store")``.
- **fetch**: the restore walk asks for the pages of a prompt's hash chain
  that no local tier holds, all in one round trip (``fetch_many``: one
  locate, one pipelined pull a segment). Any failure (a master timeout, a
  locate miss, a failed pull, a CRC reject, the ``kv.pull.drop`` fault
  site) leaves the page out: the caller computes it.

``page_dtype`` (set by the engine: the runner's staging dtype) is the
dtype a fetched page comes back in, as a CPU tensor; None leaves it an
ndarray. Counters: ``published`` (accepted publications), ``hits``
(pages fetched), ``crc_failures``; the store client counts pulls, failed
pulls and misses, and the offload connector the tokens a fetched page
spared.
"""

from __future__ import annotations

import collections
import logging
import threading

import torch

from llmd_tpu_torch import faults
from llmd_tpu_torch.federation.wire import PageDecodeError, decode_page, encode_page

log = logging.getLogger(__name__)

PUBLISH_POLICIES = ("save", "evict-hot", "off")


class KVFederation:
    """One engine's membership in the fleet-wide prefix cache.

    Owns the publish policy and the fetch path; the store client
    (``kvstore.client.CrossSliceStoreClient``) owns the wire.
    ``event_sink`` (the engine's sink, which ``TieredEventSink`` wraps) is
    attached by the engine once it exists: publications confirmed before
    that are counted but not announced (the index converges from later
    traffic).

    Threads: ``touch``, ``fetch_many`` and ``publish`` run on the engine
    thread, ``_on_published`` on the client's publisher thread and
    ``_on_store_evicted`` on its heartbeat thread. The hotness and
    publication books sit behind one lock; events are emitted outside it
    (the publisher has its own).
    """

    def __init__(
        self,
        client,
        publish_policy: str = "save",
        publish_min_hits: int = 2,
        hot_track_max: int = 65536,
    ) -> None:
        if publish_policy not in PUBLISH_POLICIES:
            raise ValueError(
                f"unknown publish policy {publish_policy!r} "
                f"(expected one of {PUBLISH_POLICIES})"
            )
        self.client = client
        self.publish_policy = publish_policy
        self.publish_min_hits = max(1, publish_min_hits)
        self.event_sink = None  # the engine's KVEventSink, attached by it
        self.page_dtype = None  # the dtype fetched pages come back in
        self._lock = threading.Lock()
        # hash -> distinct-use count, LRU-bounded (the hotness book).
        # guarded by _lock
        self._touches: collections.OrderedDict[bytes, int] = (
            collections.OrderedDict()
        )
        self._hot_track_max = hot_track_max
        # Keys already handed to the publisher (bounded): the master
        # dedups anyway (first copy wins), this just keeps a hot page
        # that keeps getting device-evicted from re-serializing itself
        # into the publish queue every time.
        # guarded by _lock
        self._enqueued: collections.OrderedDict[str, None] = (
            collections.OrderedDict()
        )
        # publications the master accepted
        self.published = 0  # guarded by _lock
        # publications that did not land
        self.publish_failures = 0  # guarded by _lock
        # pages fetched from the store
        self.hits = 0  # guarded by _lock
        # pulled blobs rejected by the CRC
        self.crc_failures = 0  # guarded by _lock
        client.on_published = self._on_published
        client.on_publish_failed = self._on_publish_failed
        client.on_evicted = self._on_store_evicted

    # ---------------------------------------------------------- hotness

    def touch(self, h: bytes) -> None:
        """Record one use of a page hash (host-tier save/hit or a
        device-cache prefix hit seen by the restore walk)."""
        with self._lock:
            n = self._touches.pop(h, 0)
            self._touches[h] = n + 1
            while len(self._touches) > self._hot_track_max:
                self._touches.popitem(last=False)

    def is_hot(self, h: bytes) -> bool:
        with self._lock:
            return self._touches.get(h, 0) >= self.publish_min_hits

    # ---------------------------------------------------------- publish

    def on_save(self, h: bytes, page) -> None:
        """Host-tier save hook (save-on-fill). Eager ``save`` policy
        publishes everything; ``evict-hot`` waits for the eviction."""
        self.touch(h)
        if self.publish_policy == "save":
            self.publish(h, page)

    def wants_publish_on_evict(self, h: bytes) -> bool:
        """The hotness gate, checked BEFORE the caller pays to
        materialize the page bytes (possibly an FS load)."""
        if self.publish_policy != "evict-hot":
            return False
        with self._lock:
            if h.hex() in self._enqueued:
                return False
            return self._touches.get(h, 0) >= self.publish_min_hits

    def _mark_enqueued(self, key: str) -> bool:
        with self._lock:
            if key in self._enqueued:
                return False
            self._enqueued[key] = None
            while len(self._enqueued) > self._hot_track_max:
                self._enqueued.popitem(last=False)
            return True

    def publish(self, h: bytes, page) -> None:
        """Hand one page to the store's publisher thread, which frames it
        (never blocks the engine thread; queue overflow drops the
        publish). JAX frames the page here, on the engine thread, where
        the CRC and the npy copies of a step's saved pages delay that
        step's tokens; the port only copies a host tensor, whose pinned
        slot a later save may reuse before the publisher reaches it."""
        key = h.hex()
        if self._mark_enqueued(key):
            snap = page.clone() if isinstance(page, torch.Tensor) else page
            self.client.put_async(key, lambda: encode_page(snap))

    def publish_deferred(self, h: bytes, loader) -> None:
        """Evict-path publish: ``loader`` (zero-arg, returns the page
        array or None) runs on the client's publisher thread, so the
        engine thread pays neither the possible FS load nor the
        serialization — eviction bursts land exactly when the engine is
        under memory pressure."""
        key = h.hex()
        if not self._mark_enqueued(key):
            return

        def blob():
            page = loader()
            return None if page is None else encode_page(page)

        self.client.put_async(key, blob)

    def _on_published(self, key: str) -> None:
        """Publisher-thread callback: the master accepted our copy —
        advertise the store tier to the prefix index."""
        with self._lock:
            self.published += 1
            sink = self.event_sink
        if sink is not None:
            try:
                sink.blocks_stored([bytes.fromhex(key)], None, [], "store")
            except Exception as e:  # the publisher thread outlives a sink failure
                log.warning("store-tier event emit failed: %s", e)

    def _on_publish_failed(self, key: str) -> None:
        """The publication did not land (master down, queue overflow,
        page gone before the deferred load ran): forget the enqueued
        mark so a later save/evict retries once the store recovers.
        Rejected puts (another segment already owns the copy) do NOT
        come through here — for those the mark correctly suppresses
        re-serialization."""
        with self._lock:
            self.publish_failures += 1
            self._enqueued.pop(key, None)

    def _on_store_evicted(self, key: str) -> None:
        """Heartbeat-thread callback: the master's watermark eviction
        reclaimed our copy — withdraw the store-tier advertisement so
        routing stops scoring a copy that no longer exists, and unmark
        the key so a future hot eviction can re-publish it."""
        with self._lock:
            self._enqueued.pop(key, None)
            sink = self.event_sink
        if sink is not None:
            try:
                sink.blocks_removed([bytes.fromhex(key)], "store")
            except Exception as e:  # the heartbeat thread outlives a sink failure
                log.warning("store-tier removal emit failed: %s", e)

    # ------------------------------------------------------------ fetch

    def fetch_many(self, hs: list[bytes]) -> dict:
        """Batched fetch-on-miss: every store-held page of a prefix run
        in ONE store round trip (one master locate + one pipelined
        kvship pull per owning segment — the group framing of the store
        leg). Per-page failures (drop, CRC reject, absent) just leave
        that page out of the result; the caller's chain walk stops at
        the first gap and recomputes from there."""
        out: dict = {}
        if not hs:
            return out
        keys = []
        for h in hs:
            key = h.hex()
            # The store leg of the kv.pull.drop site (fault-tolerance.md):
            # a dropped federated pull degrades that page to recompute
            # exactly like a dropped P/D pull.
            if faults.fires("kv.pull.drop", f"store|{key}"):
                continue
            keys.append(key)
        for key, blob in self.client.get_many(keys).items():
            if blob is None:
                continue
            blob = faults.corrupt("kv.bundle.corrupt", blob, f"store|{key}")
            try:
                page = decode_page(blob, self.page_dtype)
            except PageDecodeError as e:
                with self._lock:
                    self.crc_failures += 1
                log.warning("federated page %s rejected: %s", key[:16], e)
                continue
            with self._lock:
                self.hits += 1
            out[bytes.fromhex(key)] = page
        return out

    # ------------------------------------------------------------ misc

    def clear_local(self) -> None:
        """Weight rollout: withdraw this replica's store contribution
        and forget the hotness book (hashes no longer match)."""
        with self._lock:
            self._touches.clear()
            self._enqueued.clear()
        self.client.clear_local()

    def stats(self) -> dict:
        with self._lock:
            return {
                "publish_policy": self.publish_policy,
                "published": self.published,
                "hits": self.hits,
                "crc_failures": self.crc_failures,
            }
