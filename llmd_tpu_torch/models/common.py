"""Shared model building blocks."""

from __future__ import annotations

import dataclasses
import math

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
                 plain ``Q > 1`` attention gathers no more table columns;
                 eager steps only (no step captured in a CUDA graph sets
                 it: a host value would be frozen into the graph)

    Flat (``token_rows`` set, the ``cu_q_lens`` step): the batch axis is
    the packed token stream of T tokens (live tokens first, then pads).

    token_ids:   [T, 1] input token ids (0 for pads)
    positions:   [T, 1] absolute position of each token (0 for pads)
    kv_lens:     [T] causal horizon per token: position + 1 (0 for pads)
    page_table:  [R, max_pages] compact per-row table of physical pages
    token_rows:  [T] token -> row of ``page_table``
    num_live:    [1] int32 number of live tokens (tokens [0, num_live)),
                 on the device, so that a step captured in a CUDA graph
                 at one T replays with any count
    flat_items:  [T, 2] the flat attention kernel's query tiles
                 (``ops.flat_work_items``), built once a step for every
                 layer; None lets each layer's kernel call build them

    Either layout, under the sliding-window ring (``CacheConfig.swa_ring``):

    swa_page_table: the ring-view table of the sliding layers, the shape
                 of ``page_table``: logical page l of a row maps to
                 ``ring[l % R]`` in the ring pool; None without the ring

    Either layout, with LoRA slots (``ModelConfig.num_lora_adapters``):

    lora_ids:    [B] int32 adapter slot of each row (0: the base model);
                 in the flat layout [T], each token's row's
    """

    token_ids: torch.Tensor
    positions: torch.Tensor
    kv_lens: torch.Tensor
    page_table: torch.Tensor
    token_rows: torch.Tensor | None = None
    num_live: torch.Tensor | None = None
    query_lens: torch.Tensor | None = None
    live_pages: int | None = None
    flat_items: torch.Tensor | None = None
    swa_page_table: torch.Tensor | None = None
    lora_ids: torch.Tensor | None = None

    @property
    def valid(self) -> torch.Tensor:  # [B, Q] bool, bucketed layout
        Q = self.token_ids.shape[1]
        cols = torch.arange(Q, device=self.token_ids.device)
        return cols[None, :] < self.query_lens[:, None]


def pdot(x: torch.Tensor, lp: dict, name: str) -> torch.Tensor:
    """``x @ lp[name]``, or the int8 product (``ops.quant.qdot``) where the
    tree carries ``<name>_scale``: the weight streams as int8 and
    multiplies through K6''s int8 branch."""
    scale = lp.get(name + "_scale")
    if scale is None:
        return x @ lp[name]
    from llmd_tpu_torch.ops.quant import qdot

    return qdot(x, lp[name], scale)


def qpdot(rows, lp: dict, name: str) -> torch.Tensor:
    """``lp[name]``'s int8 product on rows already quantized (``rows``: an
    ``ops.quant.QRows``, from a fused form, one quantization for every
    product that reads the same rows): K6''s int8 branch, ``[M, N]`` in
    ``rows.dtype``."""
    from llmd_tpu_torch.ops import grouped_gemm

    return grouped_gemm.matmul_q8(rows.xq, rows.scale, lp[name], lp[name + "_scale"], rows.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * weight


SUPPORTED_ROPE_TYPES = ("default", "linear", "llama3", "yarn")


def rope_type(scaling: dict | None) -> str:
    if not scaling:
        return "default"
    return scaling.get("rope_type") or scaling.get("type") or "default"


def _yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_sm_scale_mult(scaling: dict | None) -> float:
    """DeepSeek-style yarn splits the attention temperature: with
    ``mscale_all_dim`` set, cos/sin stay (nearly) unscaled and the softmax
    scale is multiplied by mscale² instead (HF ``DeepseekV3Attention``).
    1.0 for every other rope config."""
    if rope_type(scaling) != "yarn":
        return 1.0
    m_all = float(scaling.get("mscale_all_dim") or 0.0)
    if not m_all:
        return 1.0
    m = _yarn_mscale(float(scaling["factor"]), m_all)
    return m * m


def _inv_freq_and_factor(
    head_dim: int, theta: float, scaling: dict | None, device=None
) -> tuple[torch.Tensor, float]:
    """Inverse frequencies and the cos/sin post-factor of an HF
    ``rope_scaling``, as the JAX package computes them.

    linear: every frequency divided by ``factor``. llama3 (Llama-3.1+):
    low-frequency bands divided by ``factor``, high ones kept, a smooth
    interpolation between. yarn (gpt-oss, DeepSeek, long-context Qwen):
    NTK-by-parts interpolation with a linear ramp between the beta_fast and
    beta_slow correction dimensions, and an attention factor on cos/sin."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=device)
    inv_freq = 1.0 / (theta ** (idx / half))
    rt = rope_type(scaling)
    if rt == "default":
        return inv_freq, 1.0
    factor = float(scaling["factor"])
    if rt == "linear":
        return inv_freq / factor, 1.0
    if rt == "llama3":
        low = float(scaling["low_freq_factor"])
        high = float(scaling["high_freq_factor"])
        orig = float(scaling["original_max_position_embeddings"])
        wavelen = 2.0 * math.pi / inv_freq
        scaled = torch.where(wavelen > orig / low, inv_freq / factor, inv_freq)
        smooth = (orig / wavelen - low) / (high - low)
        smoothed = (1.0 - smooth) / factor * inv_freq + smooth * inv_freq
        is_medium = (wavelen >= orig / high) & (wavelen <= orig / low)
        return torch.where(is_medium, smoothed, scaled), 1.0
    if rt == "yarn":
        orig = float(scaling.get("original_max_position_embeddings") or 0.0) or None
        if orig is None:
            raise ValueError("yarn rope_scaling needs original_max_position_embeddings")
        attention_factor = scaling.get("attention_factor")
        if attention_factor is None:
            mscale = scaling.get("mscale")
            m_all = scaling.get("mscale_all_dim")
            if mscale and m_all:
                attention_factor = _yarn_mscale(factor, float(mscale)) / _yarn_mscale(
                    factor, float(m_all)
                )
            else:
                attention_factor = _yarn_mscale(factor)
        beta_fast = float(scaling.get("beta_fast") or 32)
        beta_slow = float(scaling.get("beta_slow") or 1)

        def correction_dim(rot: float) -> float:
            return (head_dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(theta))

        low = max(math.floor(correction_dim(beta_fast)), 0)
        high = min(math.ceil(correction_dim(beta_slow)), head_dim - 1)
        ramp = ((idx - low) / max(high - low, 1e-3)).clamp(0.0, 1.0)
        inv_freq = inv_freq / factor * ramp + inv_freq * (1.0 - ramp)
        return inv_freq, float(attention_factor)
    raise NotImplementedError(f"rope_scaling type {rt!r} not supported")


def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float,
    scaling: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embedding: [..., head_dim // 2], f32, with
    the ``rope_scaling`` of ``_inv_freq_and_factor``."""
    inv_freq, factor = _inv_freq_and_factor(head_dim, theta, scaling, positions.device)
    angles = positions.float()[..., None] * inv_freq
    cos, sin = torch.cos(angles), torch.sin(angles)
    if factor != 1.0:
        cos, sin = cos * factor, sin * factor
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate [T, Q, N, D] with tables [T, Q, half] (HF split-half layout)."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)
