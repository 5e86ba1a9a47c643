"""Mixture-of-experts block: router, shared expert and grouped expert FFNs.

The port of ``llmd_tpu/models/moe.py``'s single-device grouped path
(``moe_block_grouped``, JAX's default ``moe_backend="grouped"``): tokens
sorted by expert feed the grouped GEMM (K6′, ``ops.grouped_gemm``), so each
expert multiplies only its routed rows. The router covers Mixtral/Qwen3
(softmax, top-k, renormalised), DeepSeek V2/V3 (softmax or sigmoid scores,
group-limited selection, optional renormalisation, routed scaling) and
gpt-oss (a router bias folded into the logits); the experts' GLU is SwiGLU
or gpt-oss's clamped one with per-expert biases. int8 experts (their
``we_*_scale`` leaves) run K6''s int8 branch on rows quantized once (the
post-norm's fused form gives them, with h for the router, which stays
float, as do the biases); the gated units, shared expert's included, run
``ops.quant.glu_quant``, which quantizes their output for the down
product. The dense-combine and expert-parallel blocks are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from llmd_tpu_torch.config import ModelConfig
from llmd_tpu_torch.models.common import pdot, qpdot
from llmd_tpu_torch.ops import quant
from llmd_tpu_torch.ops.grouped_gemm import moe_apply_grouped


def router_topk(
    h: torch.Tensor,  # [T, H]
    w_router: torch.Tensor,  # [H, E]
    top_k: int,
    cfg: ModelConfig | None = None,
    bias: torch.Tensor | None = None,  # [E] V3 correction or gpt-oss logit bias
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k expert routing; returns (weights [T, k] f32, expert ids [T, k]).

    Without ``cfg``: softmax, top-k, renormalised (Mixtral). With it: the
    scoring, the group-limited selection (DeepSeek V2 max per group, V3
    top-2 sum per group), renormalisation and routed scaling the config
    names. Logits are computed in f32. ``router_logit_bias`` (gpt-oss)
    adds ``bias`` to the logits: softmax, top-k and renormalisation of the
    biased logits are then softmax over the selected biased logits, so it
    is folded in and cleared; otherwise ``bias`` steers the selection only
    (V3)."""
    logits = h.float() @ w_router.float()  # [T, E]
    if cfg is not None and cfg.router_logit_bias and bias is not None:
        logits = logits + bias.float()
        bias = None
    if cfg is None:
        probs = torch.softmax(logits, dim=-1)
        weights, ids = torch.topk(probs, top_k, dim=-1)
        return weights / weights.sum(dim=-1, keepdim=True), ids
    T, E = logits.shape
    if cfg.router_scoring == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    # Selection scores may differ from the combine weights: V3's correction
    # bias steers the selection only.
    choice = scores if bias is None else scores + bias.float()
    if cfg.topk_method in ("group_max", "group_top2") and cfg.n_group > 1:
        g = cfg.n_group
        grouped = choice.reshape(T, g, E // g)
        if cfg.topk_method == "group_max":
            group_scores = grouped.amax(dim=-1)
        else:  # top-2 sum per group (V3 noaux_tc)
            group_scores = torch.topk(grouped, 2, dim=-1).values.sum(dim=-1)
        group_idx = torch.topk(group_scores, cfg.topk_group, dim=-1).indices
        group_mask = torch.zeros((T, g), dtype=torch.bool, device=h.device)
        group_mask.scatter_(1, group_idx, True)
        mask = group_mask.repeat_interleave(E // g, dim=-1)
        fill = 0.0 if cfg.router_scoring == "sigmoid" else float("-inf")
        choice = torch.where(mask, choice, fill)
    ids = torch.topk(choice, top_k, dim=-1).indices
    weights = torch.gather(scores, -1, ids)
    if cfg.norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return weights * cfg.routed_scaling_factor, ids


def _expert_biases(lp: dict) -> tuple | None:
    """(gate, up, down) per-expert biases (gpt-oss experts carry them)."""
    if "we_gate_b" not in lp:
        return None
    return (lp["we_gate_b"], lp["we_up_b"], lp["we_down_b"])


def glu_kind(cfg: ModelConfig | None) -> tuple[str, float]:
    """(``ops.quant.glu``'s kind, its clamp) of a config's experts."""
    if cfg is not None and cfg.moe_activation == "swiglu_oss":
        return "swiglu_oss", cfg.swiglu_limit
    return "silu", 0.0


def expert_glu(
    gate: torch.Tensor, up: torch.Tensor, cfg: ModelConfig | None = None
) -> torch.Tensor:
    """The experts' gated unit before the down projection (``ops.quant.glu``).
    silu (Mixtral, Qwen, DeepSeek; also without ``cfg``): silu(gate) * up.
    swiglu_oss (gpt-oss): gate clamped above at ``swiglu_limit``, up clamped
    to [-limit, limit], glu = gate * sigmoid(1.702 * gate), out = (up + 1) *
    glu."""
    return quant.glu(gate, up, *glu_kind(cfg))


def _expert_scales(lp: dict) -> tuple | None:
    """(gate, up, down) per-(expert, column) scales of int8 experts."""
    if "we_gate_scale" not in lp:
        return None
    return (lp["we_gate_scale"], lp["we_up_scale"], lp["we_down_scale"])


def shared_expert_ffn(ht: torch.Tensor, lp: dict, hq: quant.QRows | None = None) -> torch.Tensor:
    """DeepSeek's always-on shared expert, a dense SwiGLU MLP. int8: its
    gate and up read the rows ``hq`` quantized once, and ``glu_quant``
    quantizes the gated unit for down."""
    if hq is None:
        return pdot(F.silu(pdot(ht, lp, "ws_gate")) * pdot(ht, lp, "ws_up"), lp, "ws_down")
    xq, scale, _ = quant.glu_quant(qpdot(hq, lp, "ws_gate"), qpdot(hq, lp, "ws_up"))
    return qpdot(quant.QRows(xq, scale, hq.dtype), lp, "ws_down")


def moe_block_grouped(h: torch.Tensor, lp: dict, cfg: ModelConfig,
                      hq: quant.QRows | None = None) -> torch.Tensor:
    """MoE FFN on ``[B, Q, H]``: route, run each routed row through its
    expert by grouped GEMM, combine in f32, add the shared expert. int8
    experts (and an int8 shared expert) read ``hq``, h's rows quantized by
    the post norm's fused form."""
    B, Q, H = h.shape
    ht = h.reshape(B * Q, H)
    weights, ids = router_topk(
        ht, lp["router"], cfg.num_experts_per_tok, cfg, lp.get("router_bias")
    )
    out = moe_apply_grouped(
        ht, weights, ids, lp["we_gate"], lp["we_up"], lp["we_down"],
        scales=_expert_scales(lp), biases=_expert_biases(lp), cfg=cfg, hq=hq,
    ).to(h.dtype)
    if cfg.shared_expert_intermediate_size:
        out = out + shared_expert_ffn(ht, lp, hq)
    return out.reshape(B, Q, H)
