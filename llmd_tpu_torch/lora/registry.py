"""The adapter registry: every loadable adapter, in host memory (JAX
``llmd_tpu/lora/registry.py``).

An adapter registered here is servable: a request naming it waits in the
engine's loading queue while its weights go into a device slot at the next
step boundary. ``/v1/load_lora_adapter`` registers; the slot count bounds
only residency, never the registry.

A name's weights do not change while it is registered (registering a live
name again is an error, as in vLLM's load API). Unregistering leaves the
weights' CRC as a tombstone, so that registering the name again with other
weights is seen: the prefix cache salts adapter pages by name
(``EngineScheduler.hash_extra``), and the old weights' pages would
otherwise serve the new adapter.
"""

from __future__ import annotations

import dataclasses
import threading

from llmd_tpu_torch.lora.source import weights_crc


@dataclasses.dataclass(frozen=True)
class AdapterRecord:
    """One registered adapter: its slot-form factors and identity."""

    name: str
    weights: dict
    crc: int
    source: str = ""


class AdapterRegistry:
    """Name -> ``AdapterRecord``, thread-safe: the server registers from
    its executor threads while the engine thread resolves and installs."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: dict[str, AdapterRecord] = {}
        # CRC of each unregistered name's weights.
        self._tombstones: dict[str, int] = {}

    def register(self, name: str, weights: dict, source: str = "") -> tuple[AdapterRecord, bool]:
        """Register ``name``; returns ``(record, stale_cache)``, where
        ``stale_cache`` says that the name was served before with other
        weights: the caller drops the name-salted cached pages before any
        request can hit them."""
        crc = weights_crc(weights)
        with self._lock:
            if name in self._records:
                raise ValueError(f"adapter {name!r} is already loaded; unload it first")
            rec = AdapterRecord(name=name, weights=dict(weights), crc=crc, source=source)
            self._records[name] = rec
            old = self._tombstones.pop(name, None)
            return rec, old is not None and old != crc

    def unregister(self, name: str) -> AdapterRecord:
        with self._lock:
            rec = self._records.pop(name, None)
            if rec is None:
                raise KeyError(name)
            self._tombstones[name] = rec.crc
            return rec

    def get(self, name: str) -> AdapterRecord | None:
        with self._lock:
            return self._records.get(name)

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._records

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._records)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)
