"""Kernels of the flat step and their plain PyTorch versions.

The entry points below keep the call shape of ``llmd_tpu.ops``'s flat
entries (layer-indexed, on the full ``[L, pages, K, page, 2D]`` pool) and
dispatch by the pool's device alone: a CUDA pool launches the hand-written
kernel (or the call raises), a CPU pool runs the plain version. There is
no switch that sends CUDA tensors to the plain version.
"""

from __future__ import annotations

import torch

from llmd_tpu_torch.ops.kv_write import (
    write_kv_pages_flat_full,
    write_kv_pages_flat_plain,
)
from llmd_tpu_torch.ops.ragged_paged_attention import (
    flat_paged_attention_full,
    flat_paged_attention_plain,
)

# The kernel wrappers of the main path; each counts its launches.
KERNELS = (write_kv_pages_flat_full, flat_paged_attention_full)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


def write_kv_pages_full_flat(
    kv_cache_full: torch.Tensor,
    layer: int,
    k: torch.Tensor,  # [T, 1, K, D]
    v: torch.Tensor,  # [T, 1, K, D]
    page_table: torch.Tensor,  # [R, max_pages] compact per-row table
    rows: torch.Tensor,  # [T] token -> row
    positions: torch.Tensor,  # [T, 1]
    total: int,  # live tokens; the rest of the stream is padding
) -> torch.Tensor:
    """Flattened-token layer-indexed KV write, in place; returns the pool."""
    dt = kv_cache_full.dtype
    return write_kv_pages_flat_full(
        kv_cache_full, layer, k.to(dt).contiguous(), v.to(dt).contiguous(),
        page_table, rows, positions.reshape(-1), total,
    )


def paged_attention_full_flat(
    q: torch.Tensor,  # [T, 1, H, D]
    kv_cache_full: torch.Tensor,
    layer: int,
    rows: torch.Tensor,
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,  # [T] per token: position + 1
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Flattened-token layer-indexed attention over the pool."""
    return flat_paged_attention_full(
        q.contiguous(), kv_cache_full, layer, rows, page_table, kv_lens,
        sm_scale,
    )


__all__ = [
    "flat_paged_attention_full",
    "flat_paged_attention_plain",
    "launch_counts",
    "paged_attention_full_flat",
    "reset_launch_counts",
    "write_kv_pages_flat_full",
    "write_kv_pages_flat_plain",
    "write_kv_pages_full_flat",
]
