"""Shared model building blocks."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class StepInput:
    """Device inputs of one forward step, in one of two layouts.

    Bucketed (``token_rows is None``): one row per sequence, ``Q`` token
    slots a row.

    token_ids:   [B, Q] input token ids (0 in pad slots)
    positions:   [B, Q] absolute positions (pad slots repeat the last valid)
    query_lens:  [B] valid token slots per row (0 for a pad row)
    kv_lens:     [B] valid kv length per row AFTER this step's writes
    page_table:  [B, max_pages] physical pages per row
    live_pages:  the largest live page count of the batch (host int): the
                 plain ``Q > 1`` attention gathers no more table columns

    Flat (``token_rows`` set, the ``cu_q_lens`` step): the batch axis is
    the packed token stream of T tokens (live tokens first, then pads).

    token_ids:   [T, 1] input token ids (0 for pads)
    positions:   [T, 1] absolute position of each token (0 for pads)
    kv_lens:     [T] causal horizon per token: position + 1 (0 for pads)
    page_table:  [R, max_pages] compact per-row table of physical pages
    token_rows:  [T] token -> row of ``page_table``
    num_live:    number of live tokens (host int; tokens [0, num_live))
    """

    token_ids: torch.Tensor
    positions: torch.Tensor
    kv_lens: torch.Tensor
    page_table: torch.Tensor
    token_rows: torch.Tensor | None = None
    num_live: int = 0
    query_lens: torch.Tensor | None = None
    live_pages: int | None = None

    @property
    def valid(self) -> torch.Tensor:  # [B, Q] bool, bucketed layout
        Q = self.token_ids.shape[1]
        cols = torch.arange(Q, device=self.token_ids.device)
        return cols[None, :] < self.query_lens[:, None]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * weight


def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embedding: [..., head_dim // 2], f32.

    The default (unscaled) rope, which the models of this slice use."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate [T, Q, N, D] with tables [T, Q, half] (HF split-half layout)."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)
