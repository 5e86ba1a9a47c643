"""Multi-head latent attention (DeepSeek V2/V3/R1).

The port of ``llmd_tpu/models/mla.py``'s ``mla_write``, ``mla_read`` and
``mla_attention``. Projections (HF names in comments):

  q:  x -> [q_lora_rank] -> norm -> heads x (nope + rope)   (q_a / q_b)
      or x -> heads x (nope + rope) when q_lora_rank == 0
  kv: x -> [kv_lora_rank + rope]                            (kv_a)
      latent = [rmsnorm(c_kv), rope(k_pe)]   <- the cached row
      kv_b: [kv_lora_rank] -> heads x (nope + v)

Attention runs on the latent pool with weight absorption: kv_b's key half
folds into the query (``q_eff = [q_nope @ W_uk, q_pe]``) and its value half
into the output, so per-head K and V are never materialised. The latent row
goes into the pool through ``ops.write_kv_pages_full`` as two halves posing
as K and V (the decode write kernel at ``Q == 1``); the attention is
``ops.mla_paged_attention_full`` (the latent decode kernel at ``Q == 1``).
The absorption products stay ``torch.einsum``, as JAX leaves them to XLA.
DeepSeek's yarn temperature (``rope_scaling`` with ``mscale_all_dim``)
multiplies ``sm_scale`` (``common.yarn_sm_scale_mult``), as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from llmd_tpu_torch import ops
from llmd_tpu_torch.config import ModelConfig
from llmd_tpu_torch.models.common import StepInput, apply_rope, rms_norm, yarn_sm_scale_mult


def mla_write(
    h: torch.Tensor,  # [B, Q, H] (input-normed)
    lp: dict,
    cache: torch.Tensor,  # [L, pages, 1, page, Dl]
    layer: int,
    inp: StepInput,
    cfg: ModelConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    prep=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project and cache this step's latent rows; returns (the pool,
    written in place, and the absorbed queries q_eff ``[B, Q, nh, Dl]``).
    ``prep`` is the step's decode-write addressing
    (``ops.decode_write_prep``) where the caller computed it once."""
    B, Q, _ = h.shape
    nh = cfg.num_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    rank = cfg.kv_lora_rank
    Dl = cfg.kv_cache_entry_dim

    if cfg.q_lora_rank > 0:
        q = rms_norm(h @ lp["wq_a"], lp["q_norm"], cfg.rms_norm_eps) @ lp["wq_b"]
    else:
        q = h @ lp["wq"]
    q = q.reshape(B, Q, nh, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = apply_rope(q_pe, cos, sin)

    kv_a = h @ lp["wkv_a"]  # [B, Q, rank + rope]
    c_kv = rms_norm(kv_a[..., :rank], lp["kv_norm"], cfg.rms_norm_eps)
    k_pe = apply_rope(kv_a[..., None, rank:], cos, sin)[:, :, 0]  # one shared head
    latent = F.pad(torch.cat([c_kv, k_pe], dim=-1), (0, Dl - rank - rope))
    half = Dl // 2
    lat4 = latent[:, :, None, :]  # [B, Q, 1, Dl]
    cache = ops.write_kv_pages_full(
        cache, layer, lat4[..., :half], lat4[..., half:], inp.page_table,
        inp.positions, inp.valid, prep,
    )

    # Absorption, query half: W_uk [nh, rank, nope].
    wkv_b = lp["wkv_b"].reshape(rank, nh, nope + cfg.v_head_dim)
    w_uk = wkv_b[..., :nope].permute(1, 0, 2)
    q_eff_nope = torch.einsum("bqhn,hrn->bqhr", q_nope, w_uk)
    q_eff = F.pad(torch.cat([q_eff_nope, q_pe], dim=-1), (0, Dl - rank - rope))
    return cache, q_eff


def mla_read(
    q_eff: torch.Tensor,  # [B, Q, nh, Dl]
    lp: dict,
    cache: torch.Tensor,
    layer: int,
    inp: StepInput,
    cfg: ModelConfig,
) -> torch.Tensor:
    """Latent attention against ``cache[layer]``, value absorption and the
    output projection; returns ``[B, Q, hidden]``. Reads the pool only."""
    B, Q = q_eff.shape[:2]
    nh = cfg.num_heads
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    rank = cfg.kv_lora_rank
    # MLA scales by the full qk head dim (nope + rope), not the latent's;
    # DeepSeek's yarn folds its mscale² temperature in here.
    sm_scale = (nope + rope) ** -0.5 * yarn_sm_scale_mult(cfg.rope_scaling)
    wkv_b = lp["wkv_b"].reshape(rank, nh, nope + vd)
    w_uv = wkv_b[..., nope:].permute(1, 0, 2)  # [nh, rank, vd]
    out_lat = ops.mla_paged_attention_full(
        q_eff, cache, layer, inp.page_table, inp.kv_lens, inp.positions,
        rank, sm_scale, inp.live_pages,
    )  # [B, Q, nh, rank]
    out = torch.einsum("bqhr,hrv->bqhv", out_lat, w_uv)
    return out.reshape(B, Q, nh * vd) @ lp["wo"]


def mla_attention(
    h: torch.Tensor,
    lp: dict,
    cache: torch.Tensor,
    layer: int,
    inp: StepInput,
    cfg: ModelConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    prep=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (attention output ``[B, Q, hidden]``, the pool)."""
    cache, q_eff = mla_write(h, lp, cache, layer, inp, cfg, cos, sin, prep)
    return mla_read(q_eff, lp, cache, layer, inp, cfg), cache
