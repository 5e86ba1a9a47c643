"""Adapter weight sources: a PEFT directory, a ``LORA1`` frame in a file,
a URL or the KV store (JAX ``llmd_tpu/lora/source.py``).

A frame guards its payload so that a corrupt blob is refused before numpy
parses it, and the load API answers with a counted client error::

    magic "LORA1" | crc32(payload) u32-le | npz payload

``payload`` is an uncompressed ``np.savez`` archive of the slot-form
factors (``la_q``, ``lb_q``, ``la_v``, ``lb_v``, each stacked
``[num_layers, ...]``, float32): the JAX package's bytes.

The fetch consults two fault sites of the plan (``llmd_tpu_torch.faults``):
``lora.fetch.delay_ms`` (the fetch sleeps: a slow adapter store) and
``lora.load.fail`` (the fetch raises ``AdapterFetchError``). A failed
fetch is retried once, then fails the load; base-model rows and resident
adapters are never touched.
"""

from __future__ import annotations

import io
import pathlib
import struct
import urllib.error
import urllib.request
import zlib

import numpy as np
import torch

from llmd_tpu_torch import faults

MAGIC = b"LORA1"
_HEADER = struct.Struct("<5sI")

# The slot-form factors (``ModelRunner.set_lora_weights``). A and B go in
# together a projection; the engine zero-fills a missing pair before it
# registers, so that an install overwrites the evicted tenant's slot whole.
FACTOR_KEYS = ("la_q", "lb_q", "la_v", "lb_v")


class AdapterDecodeError(ValueError):
    """A framed adapter failed its CRC or did not parse."""


class AdapterFetchError(Exception):
    """Adapter weights could not be fetched from their source."""


def as_f32(v) -> np.ndarray:
    """A factor (numpy array or tensor, any float dtype) as float32 numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, np.float32)


def encode_adapter(weights: dict) -> bytes:
    """Frame an adapter's factors for a file, the wire or the store."""
    unknown = set(weights) - set(FACTOR_KEYS)
    if unknown:
        raise ValueError(f"unknown adapter tensors {sorted(unknown)}")
    buf = io.BytesIO()
    np.savez(buf, **{k: as_f32(v) for k, v in weights.items()})
    payload = buf.getvalue()
    return _HEADER.pack(MAGIC, zlib.crc32(payload)) + payload


def decode_adapter(blob: bytes) -> dict:
    """Check and parse a framed adapter; raises ``AdapterDecodeError`` on
    any corruption, so that no half-parsed adapter is installed."""
    if len(blob) < _HEADER.size:
        raise AdapterDecodeError(f"short blob ({len(blob)}B)")
    magic, crc = _HEADER.unpack_from(blob)
    payload = blob[_HEADER.size:]
    if magic != MAGIC:
        raise AdapterDecodeError(f"bad magic {magic!r}")
    if zlib.crc32(payload) != crc:
        raise AdapterDecodeError("payload CRC mismatch")
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as npz:
            out = {k: np.asarray(npz[k]) for k in npz.files}
    except (OSError, ValueError, zlib.error) as e:
        raise AdapterDecodeError(f"npz parse failed: {e}") from e
    unknown = set(out) - set(FACTOR_KEYS)
    if unknown:
        raise AdapterDecodeError(f"unknown adapter tensors {sorted(unknown)}")
    if not out:
        raise AdapterDecodeError("empty adapter archive")
    return out


def weights_crc(weights: dict) -> int:
    """The identity of a set of weights: the CRC of its float32 bytes by
    name, in name order. The registry compares it to see a name registered
    again with other weights."""
    crc = 0
    for k in sorted(weights):
        arr = np.ascontiguousarray(as_f32(weights[k]))
        crc = zlib.crc32(arr.tobytes(), zlib.crc32(k.encode(), crc))
    return crc


def _fetch_once(source: str, model_cfg=None, kvstore_get=None, timeout_s: float = 10.0) -> dict:
    if source.startswith(("http://", "https://")):
        try:
            with urllib.request.urlopen(source, timeout=timeout_s) as resp:
                blob = resp.read()
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise AdapterFetchError(f"URL fetch {source!r} failed: {e}") from e
        return decode_adapter(blob)
    if source.startswith("kvstore://"):
        if kvstore_get is None:
            raise AdapterFetchError(f"source {source!r} needs a kvstore client (--kv-store-master-url)")
        blob = kvstore_get(source[len("kvstore://"):])
        if blob is None:
            raise AdapterFetchError(f"kvstore object {source!r} not found")
        return decode_adapter(bytes(blob))
    p = pathlib.Path(source)
    if p.is_dir():
        # An HF PEFT directory: the startup loader.
        from llmd_tpu_torch.models.loader import load_lora_adapter

        if model_cfg is None:
            raise AdapterFetchError(f"PEFT directory {source!r} needs the model config")
        try:
            return load_lora_adapter(model_cfg, source)
        except (OSError, ValueError, KeyError) as e:
            raise AdapterFetchError(f"PEFT adapter {source!r} rejected: {e}") from e
    if p.is_file():
        try:
            return decode_adapter(p.read_bytes())
        except OSError as e:
            raise AdapterFetchError(f"read {source!r} failed: {e}") from e
    raise AdapterFetchError(f"adapter source {source!r} not found")


def fetch_adapter(source: str, *, name: str = "", model_cfg=None, kvstore_get=None,
                  timeout_s: float = 10.0, retries: int = 1) -> dict:
    """Fetch and decode an adapter's weights from ``source``: a PEFT
    directory, a framed file, an ``http(s)://`` URL or ``kvstore://<key>``.
    A failed fetch is tried again ``retries`` times, then raises
    ``AdapterFetchError``; a decode error is not retried (a corrupt object
    stays corrupt)."""
    key = f"{name}|{source}"
    last: Exception | None = None
    for _ in range(1 + max(0, retries)):
        faults.delay("lora.fetch.delay_ms", key)
        if faults.fires("lora.load.fail", key):
            last = AdapterFetchError(f"injected lora.load.fail for {key!r}")
            continue
        try:
            return _fetch_once(source, model_cfg=model_cfg, kvstore_get=kvstore_get,
                               timeout_s=timeout_s)
        except AdapterDecodeError:
            raise
        except AdapterFetchError as e:
            last = e
    raise last if last is not None else AdapterFetchError(source)
