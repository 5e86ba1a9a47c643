"""The cross-slice KV store's master: the port's copy of
``llmd_tpu/kvstore/master.py`` (the same routes, JSON, watermarks, leases
and snapshot), so a port deployment runs its store without the JAX
package.

It pools the hosts' segments into one cache tier: it keeps which segment
holds each key, hands out read leases, evicts least recently used objects
once the pool passes its high watermark, and snapshots its metadata. It
moves no bytes: owners serve them from their shippers, readers pull them
there. Keys are opaque (the engines' content hashes, hex).

Protocol (HTTP JSON):
  POST /v1/segments/register   {segment_id, address, capacity_bytes}
  POST /v1/segments/heartbeat  {segment_id} -> {evict: [keys]}
                               ({unknown_segment: true} once forgotten)
  DELETE /v1/segments/{id}     an owner's shutdown: drop its objects
  POST /v1/objects/put         {segment_id, key, nbytes} -> {accepted}
  POST /v1/objects/locate      {keys: [...]} -> {found: {key: {address,
                               nbytes}}}; renews the LRU and a read lease
  POST /v1/objects/remove      {segment_id, keys}
  GET  /healthz, /metrics
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import json
import logging
import pathlib
import time

from aiohttp import web

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Segment:
    segment_id: str
    address: str  # kvship host:port serving this segment's bytes
    capacity_bytes: int
    used_bytes: int = 0
    last_heartbeat: float = 0.0
    pending_evictions: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class StoredObject:
    key: str
    segment_id: str
    nbytes: int
    stored_at: float
    lease_until: float = 0.0
    soft_pin_until: float = 0.0


class MasterState:
    """Metadata + eviction policy (single-threaded under the event loop)."""

    def __init__(
        self,
        eviction_high_watermark_ratio: float = 0.95,
        eviction_ratio: float = 0.05,
        default_kv_lease_ttl_ms: int = 5_000,
        default_kv_soft_pin_ttl_ms: int = 1_800_000,
        segment_dead_after_s: float = 30.0,
        snapshot_path: str | None = None,
    ) -> None:
        self.high_watermark = eviction_high_watermark_ratio
        self.eviction_ratio = eviction_ratio
        self.lease_ttl_s = default_kv_lease_ttl_ms / 1e3
        self.soft_pin_ttl_s = default_kv_soft_pin_ttl_ms / 1e3
        self.segment_dead_after_s = segment_dead_after_s
        self.snapshot_path = (
            pathlib.Path(snapshot_path) if snapshot_path else None
        )
        self.segments: dict[str, Segment] = {}
        # LRU order: oldest-touched first (move_to_end on locate)
        self.objects: collections.OrderedDict[str, StoredObject] = (
            collections.OrderedDict()
        )
        self.hits = 0
        self.misses = 0
        self.evicted = 0
        if self.snapshot_path is not None and self.snapshot_path.exists():
            self._load_snapshot()

    # ------------------------------------------------------------ pool

    @property
    def capacity(self) -> int:
        return sum(s.capacity_bytes for s in self.segments.values())

    @property
    def used(self) -> int:
        return sum(s.used_bytes for s in self.segments.values())

    def register_segment(
        self, segment_id: str, address: str, capacity_bytes: int
    ) -> None:
        seg = self.segments.get(segment_id)
        if seg is None:
            self.segments[segment_id] = Segment(
                segment_id, address, capacity_bytes,
                last_heartbeat=time.monotonic(),
            )
            return
        # Re-registration after owner restart: its DRAM is empty again,
        # so every object it held is gone.
        seg.address = address
        seg.capacity_bytes = capacity_bytes
        seg.last_heartbeat = time.monotonic()
        self._drop_segment_objects(segment_id)

    def remove_segment(self, segment_id: str) -> None:
        self._drop_segment_objects(segment_id)
        self.segments.pop(segment_id, None)

    def _drop_segment_objects(self, segment_id: str) -> None:
        gone = [k for k, o in self.objects.items() if o.segment_id == segment_id]
        for k in gone:
            del self.objects[k]
        seg = self.segments.get(segment_id)
        if seg is not None:
            seg.used_bytes = 0
            seg.pending_evictions.clear()

    def heartbeat(self, segment_id: str) -> list[str] | None:
        """Returns the pending-eviction list, or None for an UNKNOWN
        segment — the signal a cold-restarted master (or a reaped
        registration) sends so the client re-registers instead of
        heartbeating into the void forever."""
        seg = self.segments.get(segment_id)
        if seg is None:
            return None
        seg.last_heartbeat = time.monotonic()
        evict, seg.pending_evictions = seg.pending_evictions, []
        return evict

    def reap_dead_segments(self) -> None:
        now = time.monotonic()
        for sid in list(self.segments):
            if now - self.segments[sid].last_heartbeat > self.segment_dead_after_s:
                log.warning("segment %s missed heartbeats; dropping", sid)
                self.remove_segment(sid)

    # --------------------------------------------------------- objects

    def put(self, segment_id: str, key: str, nbytes: int, soft_pin: bool = False) -> bool:
        seg = self.segments.get(segment_id)
        if seg is None:
            return False
        prev = self.objects.get(key)
        if prev is not None:
            if prev.segment_id == segment_id:
                # Idempotent re-put from the owning segment (page
                # re-offloaded after local eviction while the registration
                # outlived it): accepting keeps the caller from dropping
                # the only live copy the master still points readers at.
                # Treat it as a fresh store: MRU position + soft-pin
                # refresh, or the just-rewritten copy would be the top
                # eviction candidate.
                now = time.monotonic()
                prev.nbytes = nbytes
                prev.stored_at = now
                if soft_pin:
                    prev.soft_pin_until = now + self.soft_pin_ttl_s
                self.objects.move_to_end(key)
                return True
            # First copy wins (content-addressed: replicas are identical);
            # the new copy is redundant, tell the caller to drop it.
            return False
        now = time.monotonic()
        self.objects[key] = StoredObject(
            key, segment_id, nbytes, stored_at=now,
            soft_pin_until=now + self.soft_pin_ttl_s if soft_pin else 0.0,
        )
        seg.used_bytes += nbytes
        self.maybe_evict()
        return True

    def locate(self, keys: list[str]) -> dict[str, dict]:
        now = time.monotonic()
        found: dict[str, dict] = {}
        for key in keys:
            obj = self.objects.get(key)
            if obj is None:
                self.misses += 1
                continue
            seg = self.segments.get(obj.segment_id)
            if seg is None:
                continue
            self.hits += 1
            obj.lease_until = now + self.lease_ttl_s
            self.objects.move_to_end(key)
            found[key] = {"address": seg.address, "nbytes": obj.nbytes}
        return found

    def remove(self, segment_id: str, keys: list[str]) -> None:
        for key in keys:
            obj = self.objects.get(key)
            if obj is not None and obj.segment_id == segment_id:
                del self.objects[key]
                seg = self.segments.get(segment_id)
                if seg is not None:
                    seg.used_bytes = max(0, seg.used_bytes - obj.nbytes)

    def maybe_evict(self) -> int:
        """Watermark-driven LRU eviction (reference configmap defaults:
        trigger at 95% full, evict 5% of capacity per cycle). Leased and
        soft-pinned objects are skipped; owners learn their eviction list
        on the next heartbeat."""
        cap = self.capacity
        if cap <= 0 or self.used < self.high_watermark * cap:
            return 0
        target = int(self.eviction_ratio * cap)
        now = time.monotonic()
        freed = 0
        for key in list(self.objects):  # LRU order
            if freed >= target:
                break
            obj = self.objects[key]
            if obj.lease_until > now or obj.soft_pin_until > now:
                continue
            seg = self.segments.get(obj.segment_id)
            del self.objects[key]
            if seg is not None:
                seg.used_bytes = max(0, seg.used_bytes - obj.nbytes)
                seg.pending_evictions.append(key)
            freed += obj.nbytes
            self.evicted += 1
        return freed

    # ------------------------------------------------------- snapshots

    def snapshot(self) -> None:
        if self.snapshot_path is None:
            return
        data = {
            "segments": [
                {
                    "segment_id": s.segment_id,
                    "address": s.address,
                    "capacity_bytes": s.capacity_bytes,
                    "used_bytes": s.used_bytes,
                }
                for s in self.segments.values()
            ],
            "objects": [
                {
                    "key": o.key,
                    "segment_id": o.segment_id,
                    "nbytes": o.nbytes,
                }
                for o in self.objects.values()
            ],
        }
        tmp = self.snapshot_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(data))
        tmp.replace(self.snapshot_path)

    def _load_snapshot(self) -> None:
        try:
            data = json.loads(self.snapshot_path.read_text())
        except (OSError, json.JSONDecodeError) as e:
            log.warning("snapshot load failed: %s", e)
            return
        now = time.monotonic()
        for s in data.get("segments", []):
            self.segments[s["segment_id"]] = Segment(
                s["segment_id"], s["address"], s["capacity_bytes"],
                used_bytes=s.get("used_bytes", 0),
                # Recovered segments must re-announce within the grace
                # window or their objects drop with them.
                last_heartbeat=now,
            )
        for o in data.get("objects", []):
            self.objects[o["key"]] = StoredObject(
                o["key"], o["segment_id"], o["nbytes"], stored_at=now,
            )

    def stats(self) -> dict:
        return {
            "segments": len(self.segments),
            "objects": len(self.objects),
            "capacity_bytes": self.capacity,
            "used_bytes": self.used,
            "hits": self.hits,
            "misses": self.misses,
            "evicted": self.evicted,
        }


def build_app(
    state: MasterState, snapshot_interval_s: float = 60.0
) -> web.Application:
    async def register(request: web.Request) -> web.Response:
        b = await request.json()
        state.register_segment(
            str(b["segment_id"]), str(b["address"]), int(b["capacity_bytes"])
        )
        return web.json_response({"ok": True})

    async def heartbeat(request: web.Request) -> web.Response:
        b = await request.json()
        evict = state.heartbeat(str(b["segment_id"]))
        if evict is None:
            return web.json_response({"unknown_segment": True, "evict": []})
        return web.json_response({"evict": evict})

    async def unregister(request: web.Request) -> web.Response:
        state.remove_segment(request.match_info["sid"])
        return web.json_response({"ok": True})

    async def put(request: web.Request) -> web.Response:
        b = await request.json()
        accepted = state.put(
            str(b["segment_id"]), str(b["key"]), int(b["nbytes"]),
            soft_pin=bool(b.get("soft_pin", False)),
        )
        return web.json_response({"accepted": accepted})

    async def locate(request: web.Request) -> web.Response:
        b = await request.json()
        return web.json_response({"found": state.locate(list(b["keys"]))})

    async def remove(request: web.Request) -> web.Response:
        b = await request.json()
        state.remove(str(b["segment_id"]), list(b["keys"]))
        return web.json_response({"ok": True})

    async def healthz(request: web.Request) -> web.Response:
        return web.json_response({"status": "ok", **state.stats()})

    async def metrics(request: web.Request) -> web.Response:
        st = state.stats()
        lines = []
        for name, val in st.items():
            metric = f"llm_d_kvstore_{name}"
            kind = "counter" if name in ("hits", "misses", "evicted") else "gauge"
            lines.append(f"# TYPE {metric} {kind}")
            lines.append(f"{metric} {val}")
        return web.Response(text="\n".join(lines) + "\n")

    async def background(app: web.Application):
        async def loop():
            while True:
                await asyncio.sleep(min(snapshot_interval_s, 5.0))
                state.reap_dead_segments()
                state.maybe_evict()
                if time.monotonic() - loop.last_snap >= snapshot_interval_s:
                    state.snapshot()
                    loop.last_snap = time.monotonic()

        loop.last_snap = time.monotonic()
        task = asyncio.create_task(loop())
        yield
        task.cancel()

    app = web.Application()
    app.cleanup_ctx.append(background)
    app.add_routes([
        web.post("/v1/segments/register", register),
        web.post("/v1/segments/heartbeat", heartbeat),
        web.delete("/v1/segments/{sid}", unregister),
        web.post("/v1/objects/put", put),
        web.post("/v1/objects/locate", locate),
        web.post("/v1/objects/remove", remove),
        web.get("/healthz", healthz),
        web.get("/metrics", metrics),
    ])
    return app
