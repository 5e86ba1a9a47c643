"""Request tracing: W3C context propagation and OTLP/HTTP JSON export.

The port's copy of ``llmd_tpu/obs/tracing.py`` (stdlib only). Every hop
(router, sidecar, engine) continues the incoming ``traceparent``; sampling
is parent-based trace-id ratio (default 0.1): a parent's sampled flag
decides, and a root span samples by the low 8 bytes of its trace id. Spans
carry the reference's attribute names, so a collector reads the port's
``engine.generate`` span as it reads the JAX server's.

The tracer is a no-op until ``configure_tracing`` is called: a request then
costs one global read and a shared no-op span. An exporter that fails drops
its spans (the OTLP exporter logs at debug level and keeps its buffer
bounded); it never fails the request that ended the span.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import secrets
import threading
import time
import urllib.request

log = logging.getLogger(__name__)

_W3C_VERSION = "00"
FLAG_SAMPLED = 0x01


def _now_ns() -> int:
    return time.time_ns()


def parse_traceparent(value: str | None) -> tuple[str, str, int] | None:
    """traceparent -> (trace_id_hex32, parent_span_id_hex16, flags)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        flags = int(parts[3], 16)
    except ValueError:
        return None
    if parts[1] == "0" * 32 or parts[2] == "0" * 16:
        return None
    return parts[1], parts[2], flags


def format_traceparent(trace_id: str, span_id: str, sampled: bool) -> str:
    flags = FLAG_SAMPLED if sampled else 0
    return f"{_W3C_VERSION}-{trace_id}-{span_id}-{flags:02x}"


class Span:
    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start_ns", "end_ns",
        "attributes", "events", "status_ok", "sampled", "_tracer", "kind",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: str | None,
        sampled: bool,
        kind: str = "SPAN_KIND_INTERNAL",
    ) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled
        self.kind = kind
        self.start_ns = _now_ns()
        self.end_ns = 0
        self.attributes: dict = {}
        self.events: list[tuple[int, str, dict]] = []
        self.status_ok = True

    def set(self, key: str, value) -> "Span":
        if self.sampled:
            self.attributes[key] = value
        return self

    def event(self, name: str, **attrs) -> None:
        if self.sampled:
            self.events.append((_now_ns(), name, attrs))

    def error(self, message: str = "") -> None:
        self.status_ok = False
        if message and self.sampled:
            self.attributes["error.message"] = message

    def end(self) -> None:
        self.end_ns = _now_ns()
        if self.sampled and self._tracer is not None:
            self._tracer._export(self)

    @property
    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id, self.sampled)

    # OTLP/JSON encoding (the /v1/traces HTTP payload item).
    def to_otlp(self) -> dict:
        def _attr(k, v):
            if isinstance(v, bool):
                val = {"boolValue": v}
            elif isinstance(v, int):
                val = {"intValue": str(v)}
            elif isinstance(v, float):
                val = {"doubleValue": v}
            else:
                val = {"stringValue": str(v)}
            return {"key": k, "value": val}

        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            **({"parentSpanId": self.parent_id} if self.parent_id else {}),
            "name": self.name,
            "kind": self.kind,
            "startTimeUnixNano": str(self.start_ns),
            "endTimeUnixNano": str(self.end_ns or _now_ns()),
            "attributes": [_attr(k, v) for k, v in self.attributes.items()],
            "events": [
                {
                    "timeUnixNano": str(ts),
                    "name": name,
                    "attributes": [_attr(k, v) for k, v in attrs.items()],
                }
                for ts, name, attrs in self.events
            ],
            "status": {"code": "STATUS_CODE_OK" if self.status_ok else "STATUS_CODE_ERROR"},
        }


class _NoopSpan:
    __slots__ = ()
    sampled = False
    trace_id = "0" * 32
    span_id = "0" * 16
    traceparent = ""

    def set(self, key, value):
        return self

    def event(self, name, **attrs):
        pass

    def error(self, message=""):
        pass

    def end(self):
        pass


NOOP_SPAN = _NoopSpan()


class InMemoryExporter:
    def __init__(self) -> None:
        self.spans: list[Span] = []

    def export(self, span: Span) -> None:
        self.spans.append(span)

    def close(self) -> None:
        pass


class FileExporter:
    """JSONL span log — grep-able tracing without a collector."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()

    def export(self, span: Span) -> None:
        line = json.dumps(span.to_otlp(), separators=(",", ":"))
        with self._lock, open(self.path, "a") as f:
            f.write(line + "\n")

    def close(self) -> None:
        pass


class OtlpHttpExporter:
    """Batched OTLP/HTTP JSON exporter (collector :4318/v1/traces).

    Export happens on a background thread so span.end() never blocks the
    event loop; batches flush every `flush_s` or `max_batch` spans.
    """

    def __init__(
        self,
        endpoint: str,
        service_name: str,
        flush_s: float = 2.0,
        max_batch: int = 256,
        timeout_s: float = 5.0,
    ) -> None:
        self.endpoint = endpoint.rstrip("/") + "/v1/traces"
        self.service_name = service_name
        self.flush_s = flush_s
        self.max_batch = max_batch
        self.timeout_s = timeout_s
        self._buf: list[dict] = []  # guarded by _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def export(self, span: Span) -> None:
        with self._lock:
            self._buf.append(span.to_otlp())
            if len(self._buf) > self.max_batch * 4:
                # collector down: drop oldest rather than grow unbounded
                del self._buf[: self.max_batch]

    def _payload(self, spans: list[dict]) -> bytes:
        return json.dumps(
            {
                "resourceSpans": [
                    {
                        "resource": {
                            "attributes": [
                                {
                                    "key": "service.name",
                                    "value": {"stringValue": self.service_name},
                                }
                            ]
                        },
                        "scopeSpans": [
                            {"scope": {"name": "llmd-tpu"}, "spans": spans}
                        ],
                    }
                ]
            }
        ).encode()

    def _flush(self) -> None:
        with self._lock:
            batch, self._buf = self._buf[: self.max_batch], self._buf[self.max_batch:]
        if not batch:
            return
        try:
            req = urllib.request.Request(
                self.endpoint,
                data=self._payload(batch),
                headers={"content-type": "application/json"},
            )
            urllib.request.urlopen(req, timeout=self.timeout_s).close()
        except Exception as e:
            log.debug("OTLP export failed: %s", e)

    def _run(self) -> None:
        while not self._stop.wait(self.flush_s):
            self._flush()
        self._flush()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=self.timeout_s + 1)


class Tracer:
    def __init__(
        self,
        service_name: str,
        exporter,
        sample_ratio: float = 0.1,
    ) -> None:
        self.service_name = service_name
        self.exporter = exporter
        self.sample_ratio = max(0.0, min(1.0, sample_ratio))
        # trace-id-ratio threshold over the low 8 bytes of the trace id
        self._threshold = int(self.sample_ratio * (1 << 64))

    # parent-based trace-id-ratio sampling (the reference default
    # `parentbased_traceidratio`): honor the parent's decision; root spans
    # sample by trace-id hash ratio.
    def _sample(self, trace_id: str, parent_flags: int | None) -> bool:
        if parent_flags is not None:
            return bool(parent_flags & FLAG_SAMPLED)
        return int(trace_id[16:], 16) < self._threshold

    def start_span(
        self,
        name: str,
        traceparent: str | None = None,
        parent: Span | None = None,
        kind: str = "SPAN_KIND_INTERNAL",
    ) -> Span:
        if parent is not None and not isinstance(parent, _NoopSpan):
            trace_id, parent_id = parent.trace_id, parent.span_id
            sampled = parent.sampled
        else:
            ctx = parse_traceparent(traceparent)
            if ctx is not None:
                trace_id, parent_id, flags = ctx
                sampled = self._sample(trace_id, flags)
            else:
                trace_id = secrets.token_hex(16)
                parent_id = None
                sampled = self._sample(trace_id, None)
        if not sampled:
            return NOOP_SPAN  # type: ignore[return-value]
        return Span(self, name, trace_id, secrets.token_hex(8), parent_id, True, kind)

    @contextlib.contextmanager
    def span(self, name: str, traceparent: str | None = None, parent=None, **attrs):
        s = self.start_span(name, traceparent, parent)
        for k, v in attrs.items():
            s.set(k, v)
        try:
            yield s
        except BaseException as e:
            s.error(str(e))
            raise
        finally:
            s.end()

    def _export(self, span: Span) -> None:
        try:
            self.exporter.export(span)
        except Exception:
            log.exception("span export failed")

    def close(self) -> None:
        self.exporter.close()


class _NoopTracer:
    sample_ratio = 0.0

    def start_span(self, name, traceparent=None, parent=None, kind=""):
        return NOOP_SPAN

    @contextlib.contextmanager
    def span(self, name, traceparent=None, parent=None, **attrs):
        yield NOOP_SPAN

    def close(self) -> None:
        pass


NOOP_TRACER = _NoopTracer()
_global_tracer = NOOP_TRACER


def configure_tracing(
    service_name: str,
    otlp_endpoint: str | None = None,
    trace_file: str | None = None,
    sample_ratio: float = 0.1,
    exporter=None,
) -> Tracer:
    """Install the process-global tracer. Exporter precedence: explicit >
    OTLP endpoint > file > env (`LLMD_OTLP_ENDPOINT`, `LLMD_TRACE_FILE`)."""
    global _global_tracer
    if exporter is None:
        otlp_endpoint = otlp_endpoint or os.environ.get("LLMD_OTLP_ENDPOINT")
        trace_file = trace_file or os.environ.get("LLMD_TRACE_FILE")
        if otlp_endpoint:
            exporter = OtlpHttpExporter(otlp_endpoint, service_name)
        elif trace_file:
            exporter = FileExporter(trace_file)
        else:
            exporter = InMemoryExporter()
    tracer = Tracer(service_name, exporter, sample_ratio)
    _global_tracer = tracer
    return tracer


def get_tracer():
    return _global_tracer


def reset_tracing() -> None:
    global _global_tracer
    try:
        _global_tracer.close()
    finally:
        _global_tracer = NOOP_TRACER
