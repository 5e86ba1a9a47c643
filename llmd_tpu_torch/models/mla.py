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
into the output, so per-head K and V are never materialised. ``kv_norm``,
the rotary embedding of k_pe and q_pe, the latent row's padding and store
and q_eff's assembly are one launch of K4''s latent form a layer, at every
Q (``ops.rope_write_latent_full``; on the CPU its plain version, the chain
JAX runs); the attention is ``ops.mla_paged_attention_full`` (the latent
decode kernel at ``Q == 1``).
The absorption products stay ``torch.einsum``, as JAX leaves them to XLA;
with int8 weights the projections (``wq``/``wq_a``/``wq_b``, ``wkv_a``,
``wo``) take the int8 product and ``wkv_b`` stays float, as in JAX: the
input norm's fused form quantizes h once for ``wq`` (or ``wq_a``) and
``wkv_a`` (``hq``), ``q_norm`` and the quantization for ``wq_b`` are one
``add_rms_norm_quant``, and ``kv_norm`` (its output is cached, not
quantized) is the latent write's.
DeepSeek's yarn temperature (``rope_scaling`` with ``mscale_all_dim``)
multiplies ``sm_scale`` (``common.yarn_sm_scale_mult``), as in JAX.
"""

from __future__ import annotations

import torch

from llmd_tpu_torch import ops
from llmd_tpu_torch.config import ModelConfig
from llmd_tpu_torch.models.common import (
    StepInput, pdot, qpdot, rms_norm, yarn_sm_scale_mult,
)
from llmd_tpu_torch.ops import quant


def mla_write(
    h: torch.Tensor | None,  # [B, Q, H] (input-normed); None with hq
    lp: dict,
    cache: torch.Tensor,  # [L, pages, 1, page, Dl]
    layer: int,
    inp: StepInput,
    cfg: ModelConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    valid: torch.Tensor | None = None,
    hq: quant.QRows | None = None,  # int8 trees: h's rows quantized
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project and cache this step's latent rows; returns (the pool,
    written in place, and the absorbed queries q_eff ``[B, Q, nh, Dl]``).
    ``valid`` is the step's ``inp.valid`` where the caller computed it
    once."""
    B, Q = inp.token_ids.shape
    nh = cfg.num_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    rank = cfg.kv_lora_rank

    if hq is None:
        if cfg.q_lora_rank > 0:
            q = pdot(rms_norm(pdot(h, lp, "wq_a"), lp["q_norm"], cfg.rms_norm_eps), lp, "wq_b")
        else:
            q = pdot(h, lp, "wq")
    else:
        if cfg.q_lora_rank > 0:
            _, _, xq, scale = quant.add_rms_norm_quant(
                qpdot(hq, lp, "wq_a"), None, None, lp["q_norm"], cfg.rms_norm_eps)
            q = qpdot(hq._replace(xq=xq, scale=scale), lp, "wq_b")
        else:
            q = qpdot(hq, lp, "wq")
    q = q.reshape(B, Q, nh, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    kv_a = (pdot(h, lp, "wkv_a") if hq is None  # [B, Q, rank + rope]
            else qpdot(hq, lp, "wkv_a").reshape(B, Q, rank + rope))

    # Absorption, query half: W_uk [nh, rank, nope]. Ahead of the write,
    # whose one launch assembles q_eff from it (both are pure).
    wkv_b = lp["wkv_b"].reshape(rank, nh, nope + cfg.v_head_dim)
    w_uk = wkv_b[..., :nope].permute(1, 0, 2)
    q_eff_nope = torch.einsum("bqhn,hrn->bqhr", q_nope, w_uk)
    # kv_norm, both ropes, the pads and the latent row's store; q_eff out.
    q_eff = ops.rope_write_latent_full(
        cache, layer, kv_a, lp["kv_norm"], cfg.rms_norm_eps, cos, sin, q_pe, q_eff_nope,
        inp.page_table, inp.positions, inp.valid if valid is None else valid,
    )
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
    return pdot(out.reshape(B, Q, nh * vd), lp, "wo")


def mla_attention(
    h: torch.Tensor,
    lp: dict,
    cache: torch.Tensor,
    layer: int,
    inp: StepInput,
    cfg: ModelConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    valid: torch.Tensor | None = None,
    hq: quant.QRows | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (attention output ``[B, Q, hidden]``, the pool). int8 trees
    pass h's rows quantized (``hq``) in place of h."""
    cache, q_eff = mla_write(h, lp, cache, layer, inp, cfg, cos, sin, valid, hq)
    return mla_read(q_eff, lp, cache, layer, inp, cfg), cache
