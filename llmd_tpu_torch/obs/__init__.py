"""Observability of the port: request tracing (``obs.tracing``), the port's
copy of ``llmd_tpu/obs``."""

from llmd_tpu_torch.obs.tracing import (
    FileExporter,
    InMemoryExporter,
    OtlpHttpExporter,
    Span,
    Tracer,
    configure_tracing,
    get_tracer,
    parse_traceparent,
)

__all__ = [
    "FileExporter",
    "InMemoryExporter",
    "OtlpHttpExporter",
    "Span",
    "Tracer",
    "configure_tracing",
    "get_tracer",
    "parse_traceparent",
]
