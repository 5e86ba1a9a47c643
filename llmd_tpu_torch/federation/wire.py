"""Page framing for the store tier: CRC-guarded npy payloads, byte for
byte ``llmd_tpu/federation/wire.py``'s.

A page in the cross-slice store travels host to host over the shipper and
may outlive the process that published it, so every page carries a header,
checked before the payload is parsed:

    magic "KVF1" | crc32(payload) u32 little-endian | npy payload

A blob that fails the check raises ``PageDecodeError``, and the caller
computes the page instead.

numpy has no bfloat16, and the port does not import ``ml_dtypes``. The JAX
package's bf16 page is an ``ml_dtypes.bfloat16`` array, which ``np.save``
writes with the descr ``'<V2'`` (two opaque bytes) and ``np.load`` reads back
as ``|V2``. ``encode_page`` writes a bf16 page (a torch bfloat16 tensor, or
an array whose dtype is named bfloat16) as its bits under that same descr,
so both packages publish the same bytes; ``decode_page`` reads a two-byte
void page as bf16 bits.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
import torch

MAGIC = b"KVF1"
_HEADER = struct.Struct("<4sI")
_U2, _V2 = b"'descr': '<u2'", b"'descr': '<V2'"


class PageDecodeError(ValueError):
    """A blob failed the CRC or did not parse as a page."""


def _npy(page) -> bytes:
    bf16 = False
    if isinstance(page, torch.Tensor):
        page = page.detach().cpu()
        if page.dtype == torch.bfloat16:
            page, bf16 = page.view(torch.int16).numpy().view(np.uint16), True
        else:
            page = page.numpy()
    elif page.dtype.name == "bfloat16":
        page, bf16 = page.view(np.uint16), True
    buf = io.BytesIO()
    np.save(buf, page, allow_pickle=False)
    payload = buf.getvalue()
    if bf16:
        # Version 1.0 header: magic (6), version (2), length u16 (2), dict.
        end = 10 + int.from_bytes(payload[8:10], "little")
        head = payload[:end]
        if head.count(_U2) != 1:
            raise ValueError("unexpected npy header for a bf16 page")
        payload = head.replace(_U2, _V2) + payload[end:]
    return payload


def encode_page(page) -> bytes:
    """Frame one host page (an ndarray or a CPU tensor) for publication."""
    payload = _npy(page)
    return _HEADER.pack(MAGIC, zlib.crc32(payload)) + payload


def decode_page(blob: bytes, dtype: torch.dtype | None = None):
    """Check and parse a pulled page. Without ``dtype`` the ndarray (a bf16
    page as ``uint16`` bits); with it a CPU tensor of that dtype (a bf16
    page read as bf16 bits first). Raises PageDecodeError on any
    corruption."""
    if len(blob) < _HEADER.size:
        raise PageDecodeError(f"short blob ({len(blob)}B)")
    magic, crc = _HEADER.unpack_from(blob)
    payload = memoryview(blob)[_HEADER.size:]
    if magic != MAGIC:
        raise PageDecodeError(f"bad magic {magic!r}")
    if zlib.crc32(payload) != crc:
        raise PageDecodeError("payload CRC mismatch")
    try:
        page = np.load(io.BytesIO(payload), allow_pickle=False)
    except (OSError, ValueError) as e:
        raise PageDecodeError(f"npy parse failed: {e}") from e
    bf16 = page.dtype.kind == "V" and page.dtype.itemsize == 2
    if bf16:
        page = page.view(np.uint16)
    if dtype is None:
        return page
    if bf16:
        return torch.from_numpy(page.view(np.int16)).view(torch.bfloat16).to(dtype)
    return torch.from_numpy(page).to(dtype)
