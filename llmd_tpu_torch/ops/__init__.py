"""Kernels of the engine's steps and their plain PyTorch versions.

The entry points below keep the call shape of ``llmd_tpu.ops``'s entries
(layer-indexed, on the full ``[L, pages, K, page, 2D]`` pool). The flat
entries (``*_full_flat``) serve the packed token stream. The bucketed
entries (``write_kv_pages_full``, ``paged_attention_full``) follow the JAX
dispatch rule: ``Q == 1`` goes to the decode kernels, ``Q > 1`` to the plain
``[B, Q]`` functions of ``ops.paged_attention``, which the JAX package too
computes outside any kernel. The port's kernels have no (8, 128) tiling
gate: they take what their ``_check`` accepts and raise otherwise.

A kernel wrapper dispatches by the pool's device alone: a CUDA pool
launches the hand-written kernel (or the call raises), a CPU pool runs the
plain version. There is no switch that sends CUDA tensors to the plain
version.
"""

from __future__ import annotations

import torch

from llmd_tpu_torch.ops.kv_write import (
    write_kv_pages_decode,
    write_kv_pages_decode_full,
    write_kv_pages_decode_plain,
    write_kv_pages_flat_full,
    write_kv_pages_flat_plain,
)
from llmd_tpu_torch.ops.paged_attention import (
    paged_attention_xla,
    paged_attention_xla_blocked,
    write_kv_pages,
)
from llmd_tpu_torch.ops.ragged_paged_attention import (
    decode_paged_attention,
    decode_paged_attention_full,
    decode_paged_attention_plain,
    flat_paged_attention_full,
    flat_paged_attention_plain,
)

# The kernel wrappers of the engine's paths; each counts its launches.
KERNELS = (
    write_kv_pages_flat_full,
    flat_paged_attention_full,
    write_kv_pages_decode_full,
    decode_paged_attention_full,
)

# Above this many gathered positions the dense attention's [B, Q, .., S]
# score tensor dominates memory: switch to the blocked online-softmax form.
_DENSE_XLA_MAX_S = 4096


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


def decode_write_prep(
    page_table: torch.Tensor,  # [B, max_pages] i32
    positions: torch.Tensor,  # [B, 1]
    valid: torch.Tensor,  # [B, 1] bool
    page: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Addressing of a one-token-per-row write: (phys [B], offset [B],
    valid [B]), int32, as the decode write kernel takes them. It depends on
    the step alone, so a caller that writes many layers computes it once
    and passes it to ``write_kv_pages_full`` as ``prep``."""
    pos = positions[:, 0].long()
    phys = torch.gather(page_table, 1, (pos // page)[:, None])[:, 0]
    return (
        phys.to(torch.int32),
        (pos % page).to(torch.int32),
        valid[:, 0].to(torch.int32),
    )


def write_kv_pages_full(
    kv_cache_full: torch.Tensor,
    layer: int,
    k: torch.Tensor,  # [B, Q, K, D]
    v: torch.Tensor,  # [B, Q, K, D]
    page_table: torch.Tensor,  # [B, max_pages]
    positions: torch.Tensor,  # [B, Q]
    valid: torch.Tensor,  # [B, Q] bool
    prep: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Bucketed layer-indexed KV write, in place; returns the pool.
    ``Q == 1``: the decode write kernel; ``Q > 1``: the plain scatter."""
    B, Q, K, D = k.shape
    if Q != 1:
        write_kv_pages(kv_cache_full[layer], k, v, page_table, positions, valid)
        return kv_cache_full
    if prep is None:
        prep = decode_write_prep(page_table, positions, valid, kv_cache_full.shape[3])
    kv_new = torch.cat([k, v], dim=-1).reshape(B, K, 2 * D).to(kv_cache_full.dtype)
    return write_kv_pages_decode_full(kv_cache_full, kv_new, layer, *prep)


def paged_attention_full(
    q: torch.Tensor,  # [B, Q, H, D]
    kv_cache_full: torch.Tensor,
    layer: int,
    page_table: torch.Tensor,  # [B, max_pages]
    kv_lens: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B, Q]
    sm_scale: float | None = None,
    live_pages: int | None = None,
) -> torch.Tensor:
    """Bucketed layer-indexed attention over the pool. ``Q == 1``: the
    decode attention kernel; ``Q > 1``: the plain dense or blocked form.
    ``live_pages`` (the batch's largest live page count, known on the host)
    lets the plain forms gather that many table columns instead of all:
    the columns beyond hold no live position, so the result is the same."""
    if q.shape[1] == 1:
        return decode_paged_attention_full(
            q.contiguous(), kv_cache_full, layer, page_table, kv_lens, sm_scale
        )
    sl = kv_cache_full[layer]
    # The form follows the table's full width, as in the JAX package, so
    # both packages run the same arithmetic on the same configuration.
    blocked = page_table.shape[1] * sl.shape[2] > _DENSE_XLA_MAX_S
    if live_pages is not None:
        page_table = page_table[:, :live_pages]
    attend = paged_attention_xla_blocked if blocked else paged_attention_xla
    return attend(q, sl, page_table, kv_lens, positions, sm_scale)


__all__ = [
    "KERNELS",
    "decode_paged_attention",
    "decode_paged_attention_full",
    "decode_paged_attention_plain",
    "decode_write_prep",
    "flat_paged_attention_full",
    "flat_paged_attention_plain",
    "launch_counts",
    "paged_attention_full",
    "paged_attention_full_flat",
    "paged_attention_xla",
    "paged_attention_xla_blocked",
    "reset_launch_counts",
    "write_kv_pages",
    "write_kv_pages_decode",
    "write_kv_pages_decode_full",
    "write_kv_pages_decode_plain",
    "write_kv_pages_flat_full",
    "write_kv_pages_flat_plain",
    "write_kv_pages_full",
    "write_kv_pages_full_flat",
]
