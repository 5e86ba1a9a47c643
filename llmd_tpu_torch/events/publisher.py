"""The engine's KV-event publisher: ``llmd_tpu/events/publisher.py``'s
``ZMQEventSink`` on the port's own PUB socket (``events/zmtp.py``).

The router's precise prefix scorer subscribes to every engine's events
(BlockStored / BlockRemoved / AllBlocksCleared). They go out in batches,
numbered per publisher, so a subscriber that misses one sees the gap and
drops its view of the pod, then converges from the events that follow.

The wire is JAX's, byte for byte: a multipart message ``[topic (utf-8),
seq (u64 big-endian), payload (JSON)]`` with the payload
``{"pod": advertised address, "events": [{"type": "BlockStored", "hashes":
[hex...], "parent": hex | null, "tokens": [...], "medium": "gpu"},
{"type": "BlockRemoved", "hashes": [hex...], "medium": ...},
{"type": "AllBlocksCleared"}]}``. A batch is published when it holds
``max_batch`` events or when the flush thread comes by (every
``flush_interval_s``), whichever is first.
"""

from __future__ import annotations

import json
import logging
import struct
import threading

from llmd_tpu_torch.engine.kv_cache import KVEventSink
from llmd_tpu_torch.events.zmtp import PubSocket

log = logging.getLogger(__name__)


class ZMQEventSink(KVEventSink):
    """Batched PUB publisher implementing the engine's ``KVEventSink``.
    ``medium`` is that of the events that name none (the allocator's)."""

    def __init__(
        self,
        endpoint: str = "tcp://*:5556",
        topic: str = "kv-events",
        flush_interval_s: float = 0.05,
        max_batch: int = 256,
        medium: str = "gpu",
        pod: str = "",
    ) -> None:
        self.topic = topic.encode()
        self.medium = medium
        # The pod's advertised serving address: subscribers attribute the
        # events to endpoints by it (a SUB socket does not see the sender).
        self.pod = pod
        self._sock = PubSocket()
        port = self._sock.bind(endpoint)
        if endpoint.endswith(":0"):
            self.endpoint = endpoint[: endpoint.rfind(":") + 1] + str(port)
        else:
            self.endpoint = endpoint
        self._seq = 0  # guarded by _lock
        self._buf: list[dict] = []  # guarded by _lock
        # Batches the socket refused (a subscriber then sees the gap).
        self.publish_failures = 0  # guarded by _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.max_batch = max_batch
        self._flusher = threading.Thread(
            target=self._flush_loop, args=(flush_interval_s,), name="llmd-kv-events", daemon=True
        )
        self._flusher.start()

    # -- KVEventSink (the engine thread) --------------------------------- #

    def blocks_stored(self, hashes, parent, token_ids, medium=None) -> None:
        self._append({
            "type": "BlockStored",
            "hashes": [h.hex() for h in hashes],
            "parent": parent.hex() if parent else None,
            "tokens": list(token_ids),
            "medium": medium or self.medium,
        })

    def blocks_removed(self, hashes, medium=None) -> None:
        self._append({
            "type": "BlockRemoved",
            "hashes": [h.hex() for h in hashes],
            # Only a store-tier withdrawal needs its medium: a resident
            # removal clears the pod's entry whatever the tier.
            "medium": medium or self.medium,
        })

    def all_cleared(self) -> None:
        self._append({"type": "AllBlocksCleared"})

    # --------------------------------------------------------------------- #

    def _append(self, ev: dict) -> None:
        with self._lock:
            self._buf.append(ev)
            if len(self._buf) >= self.max_batch:
                self._publish_locked()

    def _publish_locked(self) -> None:
        if not self._buf:
            return
        batch, self._buf = self._buf, []
        payload = json.dumps({"pod": self.pod, "events": batch}).encode()
        seq = struct.pack(">Q", self._seq)
        self._seq += 1
        try:
            self._sock.send_multipart([self.topic, seq, payload])
        except OSError as e:
            # Subscribers see the gap and resync; the counter says the
            # gap was this publisher's.
            self.publish_failures += 1
            log.warning("kv-event publish failed: %s", e)

    def _flush_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            with self._lock:
                self._publish_locked()

    @property
    def dropped(self) -> int:
        """Messages a subscriber's full queue dropped."""
        return self._sock.dropped

    def subscriber_count(self) -> int:
        """Subscribers past the handshake whose prefixes take the topic."""
        return self._sock.subscriber_count(self.topic)

    def flush(self) -> None:
        with self._lock:
            self._publish_locked()

    def close(self) -> None:
        self._stop.set()
        self._flusher.join(timeout=2)
        with self._lock:
            self._publish_locked()
        self._sock.close()
