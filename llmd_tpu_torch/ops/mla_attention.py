"""Latent paged attention for MLA over the bucketed ``[B, Q]`` layout.

The port of ``llmd_tpu/ops/mla_attention.py:mla_paged_attention_xla``, which
the JAX package runs outside any kernel for ``Q > 1`` (prefill chunks), as
the port does. With weight absorption, MLA attention runs in the latent
space: the queries are ``q_eff = [q_nope @ W_uk, q_pe]`` per head, the keys
are the cached latent rows ``[c_kv, k_pe]`` and the values their first
``rank`` components. One latent row serves every head: MQA with a wide
head. Pad columns of the latent (past ``rank + rope``) are zero and drop out.

Layouts (one layer of the pool):
  latent_cache: [num_pages, 1, page, Dl]
  q_eff:        [B, Q, H, Dl]
  page_table:   [B, max_pages] int32
"""

from __future__ import annotations

import torch

_MASKED = -1e30


def mla_paged_attention_xla(
    q_eff: torch.Tensor,  # [B, Q, H, Dl]
    latent_cache: torch.Tensor,  # [num_pages, 1, page, Dl]
    page_table: torch.Tensor,  # [B, max_pages]
    kv_lens: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B, Q]
    rank: int,  # kv_lora_rank: value = latent[..., :rank]
    sm_scale: float,
) -> torch.Tensor:  # [B, Q, H, rank]
    """Gather the context latents, masked softmax, value contraction over
    the rank slice. JAX's arithmetic: scores summed in f32, masked at
    -1e30, probabilities rounded to the latent dtype before the second
    product, which sums in f32."""
    B, Q, H, Dl = q_eff.shape
    page = latent_cache.shape[2]
    S = page_table.shape[1] * page
    lat = latent_cache[page_table.long()].reshape(B, S, Dl)
    scores = torch.einsum("bqhd,bsd->bhqs", q_eff.float(), lat.float()) * sm_scale
    key_pos = torch.arange(S, device=q_eff.device)[None, None, :]
    causal = key_pos <= positions[:, :, None]  # [B, Q, S]
    in_ctx = key_pos < kv_lens[:, None, None]  # [B, 1, S]
    mask = (causal & in_ctx)[:, None, :, :]  # [B, 1, Q, S]
    scores = torch.where(mask, scores, _MASKED)
    probs = torch.softmax(scores, dim=-1).to(lat.dtype)
    out = torch.einsum("bhqs,bsr->bqhr", probs.float(), lat[..., :rank].float())
    return out.to(q_eff.dtype)
