"""Deterministic fault injection for the port's serving stack.

The port's copy of ``llmd_tpu/faults``: a process-global :class:`FaultPlan`
of scoped :class:`FaultSpec` entries, armed with ``arm(plan)`` or from the
``LLMD_FAULT_PLAN`` environment variable (JSON, read at import). The same
plan's JSON is valid for both packages: ``SITES`` is the reference's whole
catalog, and a plan fires the same hits over the same call sequence.

The port consults these sites:

==========================  =================================================
site                        effect at the injection point
==========================  =================================================
``serve.stream.cut``        an SSE stream's transport is severed after a
                            frame (``serve/api.py``), as a replica dying
                            mid-stream looks to the router
``engine.step.stall``       ``LLMEngine.step`` sleeps ``delay_ms`` (a wedged
                            device program, for the step watchdog)
``kv.pull.delay_ms``        a P/D consumer's pull sleeps ``delay_ms`` first
``kv.pull.drop``            a P/D consumer's pull fails (``PullError``)
``kv.bundle.corrupt``       a pulled bundle's middle byte is flipped
                            (``corrupt``), which its CRC must catch
``lora.fetch.delay_ms``     an adapter fetch sleeps ``delay_ms`` first
                            (``lora/source.py``: a slow adapter store)
``lora.load.fail``          an adapter fetch fails (``AdapterFetchError``);
                            the load is retried once, then fails and counts
==========================  =================================================

Keys: a request id, a KV bundle's shipper key, or an adapter fetch's
``name|source``. The fleet sites wait for the port's items that run those
paths. Unarmed, every helper is one module-global ``None`` check.

Determinism: a spec fires on its matching hits ``after < n <= after +
times``; with ``p < 1`` each firing is drawn from a ``random.Random`` seeded
from ``(plan.seed, site, match)``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time
import zlib

SITES = frozenset({
    "kv.pull.drop",
    "kv.pull.delay_ms",
    "kv.bundle.corrupt",
    "engine.step.stall",
    "epp.scrape.fail",
    "epp.endpoint.refuse",
    "events.drop",
    "kvstore.get.timeout",
    "lockstep.sync.stall",
    "sidecar.prefill.fail",
    "serve.stream.cut",
    "replica.crash",
    "replica.brownout",
    "lora.load.fail",
    "lora.fetch.delay_ms",
})


@dataclasses.dataclass
class FaultSpec:
    """One scoped fault: site, selector and trigger window.

    ``match`` is a substring of the site's key (a request id, or an adapter
    fetch's ``name|source``); empty matches every call. The spec fires on matching
    hits ``after < n <= after + times`` (``times=None``: unbounded), each
    firing gated by ``p`` (seeded)."""

    site: str
    match: str = ""
    times: int | None = 1
    after: int = 0
    p: float = 1.0
    delay_ms: float = 0.0

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} (known: {sorted(SITES)})")


class FaultPlan:
    """An armed set of fault specs with per-spec trigger accounting."""

    def __init__(self, specs: list[FaultSpec], seed: int = 0) -> None:
        self.specs = list(specs)
        self.seed = seed
        self.injected: dict[str, int] = {}  # guarded by _lock
        self._lock = threading.Lock()
        self._hits = [0] * len(self.specs)  # guarded by _lock
        self._fired = [0] * len(self.specs)  # guarded by _lock
        # One seeded stream per spec, keyed by (seed, site, match): the
        # reference's derivation, so both packages draw alike.
        self._rng = [
            random.Random((seed << 1) ^ zlib.crc32(f"{s.site}|{s.match}".encode()))
            for s in self.specs
        ]
        self._sites = frozenset(s.site for s in self.specs)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        """``{"seed": 0, "faults": [{"site": ..., "match": ..., "times": ...,
        "after": ..., "p": ..., "delay_ms": ...}]}``"""
        data = json.loads(text)
        if not isinstance(data, dict):
            raise ValueError("fault plan must be a JSON object")
        specs = [FaultSpec(**f) for f in data.get("faults", [])]
        return cls(specs, seed=int(data.get("seed", 0)))

    def should_fire(self, site: str, key: str) -> FaultSpec | None:
        if site not in self._sites:
            return None
        with self._lock:
            for i, s in enumerate(self.specs):
                if s.site != site or (s.match and s.match not in key):
                    continue
                self._hits[i] += 1
                if self._hits[i] <= s.after:
                    continue
                if s.times is not None and self._fired[i] >= s.times:
                    continue
                if s.p < 1.0 and self._rng[i].random() >= s.p:
                    continue
                self._fired[i] += 1
                self.injected[site] = self.injected.get(site, 0) + 1
                return s
        return None


# The process-global plan; None is the unarmed state.
_PLAN: FaultPlan | None = None


def arm(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` process-wide."""
    global _PLAN
    _PLAN = plan
    return plan


def disarm() -> None:
    global _PLAN
    _PLAN = None


def active() -> FaultPlan | None:
    return _PLAN


def injected_counts() -> dict[str, int]:
    """{site: injections so far}; empty when unarmed (``/metrics``)."""
    plan = _PLAN
    return dict(plan.injected) if plan is not None else {}


def fires(site: str, key: str = "") -> bool:
    """Whether an armed spec fires for (site, key); the call site then
    fails the way production would."""
    plan = _PLAN
    if plan is None:
        return False
    return plan.should_fire(site, key) is not None


def delay_s(site: str, key: str = "") -> float:
    """The firing spec's delay in seconds, without sleeping (0.0 when
    nothing fires)."""
    plan = _PLAN
    if plan is None:
        return 0.0
    spec = plan.should_fire(site, key)
    if spec is not None and spec.delay_ms > 0:
        return spec.delay_ms / 1e3
    return 0.0


def delay(site: str, key: str = "") -> None:
    """Sleep the firing spec's ``delay_ms`` (stall sites)."""
    dt = delay_s(site, key)
    if dt > 0:
        time.sleep(dt)


def corrupt(site: str, data: bytes, key: str = "") -> bytes:
    """``data`` with its middle byte flipped when the spec fires (a KV
    bundle's header survives: what the payload's CRC must catch)."""
    plan = _PLAN
    if plan is None or not data or plan.should_fire(site, key) is None:
        return data
    b = bytearray(data)
    b[len(b) // 2] ^= 0xFF
    return bytes(b)


_env_plan = os.environ.get("LLMD_FAULT_PLAN")
if _env_plan:
    arm(FaultPlan.from_json(_env_plan))
del _env_plan
