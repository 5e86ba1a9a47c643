"""The cross-slice KV store's client: this host's segment and its reads.
The port's copy of ``llmd_tpu/kvstore/client.py``, on the port's shipper
(``kvtransfer/shipper.py``), so a port engine and a JAX engine share one
store.

* Every engine host owns a segment: page blobs registered with its own
  shipper server and announced to the master (``put``; ``put_async``
  queues one for the publisher thread, at most 256 waiting, and paces it
  to ``LLMD_KV_PUBLISH_BYTES_PER_S`` when that is set).
* A reader asks the master where keys live (``locate``) and pulls the
  bytes from the owner's shipper (``get``, ``get_many``: one locate, one
  pipelined pull an owner); the master moves no bytes.
* The heartbeat thread renews the registration and applies the evictions
  the master hands back (watermark LRU), and registers again after the
  master forgot the segment.

Plain HTTP (``urllib``), synchronous: the callers are the engine thread's
restore walk and the client's own threads, never the server's event loop.
Every call is bounded by ``timeout_s``; a failure is a miss, a slow master
opens a read breaker for ``_read_cooldown_s``. ``kvstore.get.timeout``
makes a call to the master time out.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
import urllib.error
import urllib.request
import uuid

from llmd_tpu_torch import faults
from llmd_tpu_torch.kvtransfer import shipper as shipper_mod

log = logging.getLogger(__name__)

# Objects are master-managed; the local kvship lease is just a safety net
# against a dead master never evicting.
_OBJECT_LEASE_MS = 24 * 3600 * 1000


class CrossSliceStoreClient:
    """Embedded-mode store participant (owner + reader in one)."""

    def __init__(
        self,
        master_url: str,
        advertised_host: str = "127.0.0.1",
        data_port: int = 0,
        segment_bytes: int = 1 << 30,
        segment_id: str | None = None,
        heartbeat_s: float = 2.0,
        timeout_s: float = 5.0,
    ) -> None:
        self.master_url = master_url.rstrip("/")
        self.segment_id = segment_id or f"seg-{uuid.uuid4().hex[:12]}"
        self.segment_bytes = segment_bytes
        self.timeout_s = timeout_s
        self.server = shipper_mod.ShipperServer(port=data_port)
        self.address = f"{advertised_host}:{self.server.port}"
        self.puts = 0
        self.pulls = 0
        self.pull_failures = 0
        self.misses = 0
        self.rejected_puts = 0
        self.dropped_publishes = 0
        self.locate_calls = 0  # master round-trips (batched reads = 1/run)
        # Publish-budget pacing (kv-federation.md): a bytes/s cap on the
        # publisher thread so publish-on-evict bursts — which land
        # exactly when the engine is under memory pressure — cannot
        # starve the transfer NIC the P/D + store-fetch legs ride.
        # Token bucket with a one-second burst allowance; 0 = unpaced.
        self.publish_bytes_per_s = float(
            os.environ.get("LLMD_KV_PUBLISH_BYTES_PER_S", "0") or 0
        )
        self.paced_publish_bytes = 0  # bytes the pacer delayed
        self._pace_tokens = self.publish_bytes_per_s
        self._pace_t = time.monotonic()
        # Federation hooks (federation/core.py). on_published:
        # called (from the publisher thread) with the key of every
        # publication the master ACCEPTED. on_publish_failed: the
        # publication did NOT land (master down, queue overflow) — the
        # federation unmarks the key so a later save/evict retries;
        # rejected puts (another segment won) are terminal, not
        # failures. on_evicted: the master's watermark eviction reached
        # this owner — the store copy is gone, withdraw its
        # advertisement.
        self.on_published = None
        self.on_publish_failed = None
        self.on_evicted = None
        self._local_keys: set[str] = set()
        self._registered = False
        self._stop = threading.Event()
        # Read breaker: a slow/hung master or peer must not stall the
        # engine thread's restore path on every prompt.
        self._read_down_until = 0.0
        self._read_cooldown_s = 10.0
        self._hb = threading.Thread(
            target=self._heartbeat_loop, args=(heartbeat_s,), daemon=True
        )
        # Publications are fire-and-forget off the engine thread: a
        # bounded queue feeds one publisher thread; overflow drops the
        # publish (the store is a cache, the local tiers still hold it).
        # items: (key, bytes | zero-arg loader) — see put_async
        self._pub_queue: "queue.Queue[tuple[str, object] | None]" = queue.Queue(
            maxsize=256
        )
        self._pub = threading.Thread(target=self._publish_loop, daemon=True)
        self._register()
        self._hb.start()
        self._pub.start()

    # ----------------------------------------------------------- http

    def _call(self, path: str, body: dict | None = None, method: str = "POST"):
        # Injection site: a hung/slow master degrades every caller to its
        # documented fallback (reads -> miss, puts -> dropped publish,
        # heartbeat -> deregistered), never an exception escaping.
        if faults.fires("kvstore.get.timeout", path):
            raise TimeoutError(f"injected kvstore.get.timeout at {path}")
        req = urllib.request.Request(
            f"{self.master_url}{path}",
            data=json.dumps(body).encode() if body is not None else None,
            headers={"content-type": "application/json"},
            method=method,
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read() or b"{}")

    def _register(self) -> None:
        try:
            self._call("/v1/segments/register", {
                "segment_id": self.segment_id,
                "address": self.address,
                "capacity_bytes": self.segment_bytes,
            })
            self._registered = True
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            log.warning("kvstore master unreachable at register: %s", e)

    def _heartbeat_loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                if not self._registered:
                    self._register()
                    continue
                reply = self._call(
                    "/v1/segments/heartbeat", {"segment_id": self.segment_id}
                )
                if reply.get("unknown_segment"):
                    # Master restarted (or reaped us): the master's view
                    # of this segment is EMPTY, so withdraw the local
                    # shipper entries too — keeping them would pin
                    # unlocatable bytes in DRAM for the object-lease TTL
                    # and let the master overcommit an apparently-empty
                    # segment. Fresh publications repopulate both sides.
                    log.warning(
                        "kvstore master no longer knows segment %s; "
                        "dropping local objects and re-registering",
                        self.segment_id,
                    )
                    keys, self._local_keys = list(self._local_keys), set()
                    for key in keys:
                        self.server.unregister(key)
                    self._registered = False
                    continue
                for key in reply.get("evict", []):
                    self.server.unregister(key)
                    self._local_keys.discard(key)
                    if self.on_evicted is not None:
                        self.on_evicted(key)
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                log.debug("kvstore heartbeat failed: %s", e)
                self._registered = False

    def _publish_loop(self) -> None:
        while True:
            item = self._pub_queue.get()
            try:
                if item is None:
                    return
                self.put(*item)
            finally:
                self._pub_queue.task_done()

    def flush_publishes(self, timeout_s: float = 10.0) -> None:
        """Wait, at most ``timeout_s``, until every queued publication has
        been attempted (its put finished, not only taken off the queue)."""
        deadline = time.monotonic() + timeout_s
        while self._pub_queue.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.01)

    # ------------------------------------------------------------ api

    def _publish_failed(self, key: str) -> None:
        if self.on_publish_failed is not None:
            self.on_publish_failed(key)

    def put_async(self, key: str, data) -> None:
        """Queue a publication without blocking the caller (the engine
        thread's offload flush). ``data`` is the object bytes, or a
        zero-arg callable the publisher thread invokes to materialize
        them (the evict-path publish defers its FS load + serialization
        here). Overflow drops the publish."""
        try:
            self._pub_queue.put_nowait((key, data))
        except queue.Full:
            self.dropped_publishes += 1
            self._publish_failed(key)

    def _pace_publish(self, nbytes: int) -> None:
        """Publisher-thread token bucket: block until the publish budget
        (LLMD_KV_PUBLISH_BYTES_PER_S) covers ``nbytes``. Runs ONLY on
        the publisher thread — the engine thread's put_async never
        blocks; overflow still just drops (the queue bounds memory, the
        pacer bounds NIC share)."""
        rate = self.publish_bytes_per_s
        if rate <= 0 or nbytes <= 0:
            return
        now = time.monotonic()
        self._pace_tokens = min(
            rate, self._pace_tokens + (now - self._pace_t) * rate
        )
        self._pace_t = now
        self._pace_tokens -= nbytes
        if self._pace_tokens < 0:
            self.paced_publish_bytes += nbytes
            time.sleep(-self._pace_tokens / rate)

    def put(self, key: str, data) -> bool:
        """Publish an object: bytes into the local kvship server, metadata
        to the master. First copy wins cluster-wide; redundant copies are
        dropped locally."""
        if callable(data):
            data = data()  # deferred materialization (publisher thread)
            if data is None:
                # The page left every local tier before the publish ran.
                self._publish_failed(key)
                return False
        if not self._registered:
            self._publish_failed(key)
            return False
        self._pace_publish(len(data))
        try:
            self.server.register(key, data, lease_ms=_OBJECT_LEASE_MS)
            reply = self._call("/v1/objects/put", {
                "segment_id": self.segment_id,
                "key": key,
                "nbytes": len(data),
            })
            if not reply.get("accepted"):
                self.server.unregister(key)
                self.rejected_puts += 1
                return False
            self.puts += 1
            self._local_keys.add(key)
            if self.on_published is not None:
                self.on_published(key)
            return True
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            log.debug("kvstore put failed: %s", e)
            self.server.unregister(key)
            self._publish_failed(key)
            return False

    def locate(self, keys: list[str]) -> dict[str, dict]:
        self.locate_calls += 1
        try:
            return self._call("/v1/objects/locate", {"keys": keys})["found"]
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            log.debug("kvstore locate failed: %s", e)
            return {}

    def get_many(self, keys: list[str]) -> dict[str, bytes]:
        """Batched read: ONE master locate for every key, then one
        pipelined kvship pull per owning segment (shipper.pull_many) —
        a whole prefix run's store fetch costs one locate + one
        connection per owner instead of a locate + connect per page.
        Absent/failed keys are simply missing from the result (the
        caller's recompute policy is the degradation, as ever)."""
        out: dict[str, bytes] = {}
        if not keys:
            return out
        now = time.monotonic()
        if now < self._read_down_until:
            self.misses += len(keys)
            return out
        t0 = now
        loc = self.locate(keys)
        by_owner: dict[str, list[str]] = {}
        for key in keys:
            entry = loc.get(key)
            if entry is None:
                self.misses += 1
                continue
            by_owner.setdefault(entry["address"], []).append(key)
        if not by_owner:
            if time.monotonic() - t0 > self.timeout_s / 2:
                self._read_down_until = (
                    time.monotonic() + self._read_cooldown_s
                )
            return out
        for addr, owner_keys in by_owner.items():
            host, _, port = addr.rpartition(":")
            try:
                got = shipper_mod.pull_many(host, int(port), owner_keys)
            except (shipper_mod.PullError, OSError) as e:
                self.pull_failures += len(owner_keys)
                self._read_down_until = (
                    time.monotonic() + self._read_cooldown_s
                )
                log.debug(
                    "kvstore batched pull from %s failed: %s", addr, e
                )
                continue
            self.pulls += len(got)
            self.misses += len(owner_keys) - len(got)
            out.update(got)
        return out

    def get(self, key: str) -> bytes | None:
        """Pull one object's bytes from whichever segment holds it.

        Runs on the engine thread's restore path, so a misbehaving store
        opens a read breaker instead of stalling every prompt."""
        now = time.monotonic()
        if now < self._read_down_until:
            self.misses += 1
            return None
        t0 = now
        loc = self.locate([key]).get(key)
        if loc is None:
            self.misses += 1
            if time.monotonic() - t0 > self.timeout_s / 2:
                self._read_down_until = time.monotonic() + self._read_cooldown_s
            return None
        host, _, port = loc["address"].rpartition(":")
        try:
            data = shipper_mod.pull(host, int(port), key)
            self.pulls += 1
            return data
        except (shipper_mod.PullError, OSError) as e:
            self.pull_failures += 1
            self._read_down_until = time.monotonic() + self._read_cooldown_s
            # Stale placement (owner restarted): the lease expiry on the
            # master reclaims it.
            log.debug("kvstore pull %s from %s failed: %s", key, loc, e)
            return None

    def clear_local(self) -> None:
        """Withdraw every object this segment published (weight rollout:
        cached KV no longer matches; content hashes do not encode weight
        versions, so each participant must clear its own contribution)."""
        keys, self._local_keys = list(self._local_keys), set()
        for key in keys:
            self.server.unregister(key)
        if keys and self._registered:
            try:
                self._call("/v1/objects/remove", {
                    "segment_id": self.segment_id, "keys": keys,
                })
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                log.debug("kvstore clear_local failed: %s", e)

    def stats(self) -> dict:
        return {
            "segment_id": self.segment_id,
            "registered": self._registered,
            "local_objects": self.server.registered_count,
            "local_bytes": self.server.registered_bytes,
            "puts": self.puts,
            "pulls": self.pulls,
            "pull_failures": self.pull_failures,
            "misses": self.misses,
            "rejected_puts": self.rejected_puts,
            "dropped_publishes": self.dropped_publishes,
            "locate_calls": self.locate_calls,
            "paced_publish_bytes": self.paced_publish_bytes,
        }

    def close(self) -> None:
        self._stop.set()
        self._pub_queue.put(None)
        self._pub.join(timeout=5.0)
        self._hb.join(timeout=2.0)
        try:
            self._call(f"/v1/segments/{self.segment_id}", method="DELETE")
        except (urllib.error.URLError, OSError, TimeoutError):
            pass
        self.server.close()
