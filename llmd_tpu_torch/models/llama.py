"""Llama-class decoder (dense, MoE, MLA) on the flat or the bucketed step
layout.

The port of ``llmd_tpu/models/llama.py``: stacked ``[L, ...]`` weights with
``x @ W`` projections (the JAX leaf names, so a parameter tree carries over
by copy), fused or unfused q|k|v and gate|up, optional QKV and o biases,
attention sinks, per-layer sliding windows (``cfg.layer_windows``), Qwen3
QK-norm and tied or untied ``lm_head``. MoE layers run
``models.moe.moe_block_grouped`` (the grouped GEMM kernel); MLA layers run
``models.mla`` on a latent pool (bucketed layout only, as in JAX); a
DeepSeek-style dense prefix (``first_dense_layers``) has its own weights
under ``dense_layers``. Where JAX scans the layers, the port loops over
them in Python; each layer writes its K|V (or latent row) into the pool in
place and then attends over it, through the entries of
``llmd_tpu_torch.ops``: the flat pair on the packed ``[T, 1]`` stream, the
bucketed pair on ``[B, Q]`` rows (the decode kernels at ``Q == 1``). On the
flat step and at ``Q == 1`` a GQA layer's q|k|v biases, rotary embedding
and K|V write are one launch of the write kernel's fused form
(``ops.rope_write_kv_flat``, ``ops.rope_write_kv_decode``), which takes q,
k and v as views of the projection's output and returns the rotated q. The
large projections stay ``torch.matmul``, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from llmd_tpu_torch import ops
from llmd_tpu_torch.config import ModelConfig
from llmd_tpu_torch.models.common import StepInput, apply_rope, rms_norm, rope_tables
from llmd_tpu_torch.models.mla import mla_attention
from llmd_tpu_torch.models.moe import moe_block_grouped


def init_params(
    cfg: ModelConfig, generator: torch.Generator, device: str | torch.device
) -> dict:
    """Seeded random weights, drawn on ``device`` (``generator`` must live
    there too): drawing billions of normals on the host would take minutes.
    Same tree and scales as the JAX ``init_params`` (fan-in scaling, embed
    0.02, router ``H ** -0.5``, sinks 1.0, unit norms, zero biases); the
    values differ, as the generators do. Stacked leaves are drawn one layer
    at a time in the working dtype: one deepseek-v2-lite layer's
    ``we_gate`` is 369 MB."""
    dt = getattr(torch, cfg.dtype)
    H, D = cfg.hidden_size, cfg.head_dim
    Nq, K, L = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    Fi, V = cfg.intermediate_size, cfg.vocab_size

    def normal(shape, scale):
        return (
            torch.randn(shape, generator=generator, device=device, dtype=dt)
            .mul_(scale)
        )

    def layer_stack(n: int, moe: bool) -> dict:
        """n stacked layers: attention (MLA or GQA) + dense MLP or MoE."""

        def stacked(shape, scale=None):
            out = torch.empty((n, *shape), dtype=dt, device=device)
            for i in range(n):
                out[i] = normal(shape, shape[-2] ** -0.5 if scale is None else scale)
            return out

        def const(shape, value, dtype=dt):
            return torch.full((n, *shape), value, dtype=dtype, device=device)

        layers = {"input_norm": const((H,), 1.0), "post_norm": const((H,), 1.0)}
        if cfg.is_mla:
            nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
            rank = cfg.kv_lora_rank
            layers["wkv_a"] = stacked((H, rank + rope))
            layers["kv_norm"] = const((rank,), 1.0)
            layers["wkv_b"] = stacked((rank, Nq * (nope + vd)))
            layers["wo"] = stacked((Nq * vd, H))
            if cfg.q_lora_rank > 0:
                layers["wq_a"] = stacked((H, cfg.q_lora_rank))
                layers["q_norm"] = const((cfg.q_lora_rank,), 1.0)
                layers["wq_b"] = stacked((cfg.q_lora_rank, Nq * (nope + rope)))
            else:
                layers["wq"] = stacked((H, Nq * (nope + rope)))
        else:
            layers["wq"] = stacked((H, Nq * D))
            layers["wk"] = stacked((H, K * D))
            layers["wv"] = stacked((H, K * D))
            layers["wo"] = stacked((Nq * D, H))
        if cfg.attention_bias:
            for name, width in (("bq", Nq * D), ("bk", K * D), ("bv", K * D)):
                layers[name] = const((width,), 0.0)
        if cfg.attention_out_bias:
            layers["bo"] = const((H,), 0.0)
        if cfg.attention_sinks:
            layers["sinks"] = stacked((Nq,), 1.0)
        if cfg.qk_norm:
            layers["attn_q_norm"] = const((D,), 1.0)
            layers["attn_k_norm"] = const((D,), 1.0)
        if moe:
            E, Fm = cfg.num_experts, cfg.moe_intermediate_size
            layers["router"] = stacked((H, E), H**-0.5)
            if cfg.router_scoring == "sigmoid" or cfg.router_logit_bias:
                # V3's selection-only correction bias (noaux_tc), or
                # gpt-oss's logit bias.
                layers["router_bias"] = const((E,), 0.0, torch.float32)
            layers["we_gate"] = stacked((E, H, Fm))
            layers["we_up"] = stacked((E, H, Fm))
            layers["we_down"] = stacked((E, Fm, H))
            if cfg.moe_activation == "swiglu_oss":
                layers["we_gate_b"] = const((E, Fm), 0.0)
                layers["we_up_b"] = const((E, Fm), 0.0)
                layers["we_down_b"] = const((E, H), 0.0)
            if cfg.shared_expert_intermediate_size:
                Fs = cfg.shared_expert_intermediate_size
                layers["ws_gate"] = stacked((H, Fs))
                layers["ws_up"] = stacked((H, Fs))
                layers["ws_down"] = stacked((Fs, H))
        else:
            layers["w_gate"] = stacked((H, Fi))
            layers["w_up"] = stacked((H, Fi))
            layers["w_down"] = stacked((Fi, H))
        return layers

    n_dense = cfg.first_dense_layers if cfg.is_moe else 0
    layers = layer_stack(L - n_dense, moe=cfg.is_moe)
    dense_layers = layer_stack(n_dense, moe=False) if n_dense else None
    params = {
        "embed": normal((V, H), 0.02),
        "layers": layers,
        "final_norm": torch.ones((H,), dtype=dt, device=device),
    }
    if dense_layers is not None:
        params["dense_layers"] = dense_layers
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((H, V), H**-0.5)
    return params


def fuse_projections(params: dict) -> dict:
    """q|k|v -> ``wqkv`` and gate|up -> ``w_gu`` in ``layers`` and
    ``dense_layers`` (the JAX runner's ``_fuse_projection_tree``): one
    matmul where there were three or two. Exact: each output column is the
    same dot product. The biases ``bq``, ``bk``, ``bv`` stay separate
    leaves, as in JAX. The ``sinks`` leaf becomes f32 once here, the type
    the attention kernels read, rather than on every attention call. The
    runner skips it for MLA, as JAX does."""
    out = dict(params)
    for key in ("layers", "dense_layers"):
        if key not in out:
            continue
        layers = dict(out[key])
        for names, fused in ((("wq", "wk", "wv"), "wqkv"), (("w_gate", "w_up"), "w_gu")):
            if all(n in layers for n in names):
                layers[fused] = torch.cat([layers.pop(n) for n in names], dim=-1)
        if "sinks" in layers:
            layers["sinks"] = layers["sinks"].float()
        out[key] = layers
    return out


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree: dict, device: str | torch.device = "cpu") -> dict:
    """The JAX parameter tree (leaves as numpy arrays, fused or unfused)
    as the port's tensors: the layouts are the same, so this is a copy."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = params_from_jax(leaf, device)
        else:
            out[name] = _to_torch(leaf).to(device)
    return out


def _mlp(h: torch.Tensor, lp: dict) -> torch.Tensor:
    if "w_gu" in lp:
        gu = h @ lp["w_gu"]
        Fi = gu.shape[-1] // 2
        return (F.silu(gu[..., :Fi]) * gu[..., Fi:]) @ lp["w_down"]
    return (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]


def _write_attend(inp: StepInput, page: int, cos: torch.Tensor, sin: torch.Tensor):
    """The layout's (write, attend) pair over what the step fixes for every
    layer. ``write(kv_cache, layer, q, k, v, bias)`` adds the q|k|v biases
    (``bias`` = (bq, bk, bv) or None), rotates q and k by the step's rope
    tables, stores k|v and returns the rotated q; the flat step and ``Q ==
    1`` rows do all of it in one launch of the write kernel's fused form,
    ``Q > 1`` rows in plain PyTorch (``apply_rope``, the plain scatter), as
    the JAX package leaves those to XLA. ``attend(q, kv_cache, layer,
    sm_scale, window, sinks)`` is the attention over the pool."""
    if inp.token_rows is not None:

        def write(kv_cache, layer, q, k, v, bias):
            return ops.rope_write_kv_flat(
                kv_cache, layer, q, k, v, cos, sin, inp.page_table, inp.token_rows,
                inp.positions, inp.num_live, bias,
            )

        def attend(q, kv_cache, layer, sm_scale, window, sinks):
            return ops.paged_attention_full_flat(
                q, kv_cache, layer, inp.token_rows, inp.page_table,
                inp.kv_lens, sm_scale, window, sinks, inp.flat_items,
            )

        return write, attend

    valid = inp.valid
    if inp.token_ids.shape[1] == 1:
        prep = ops.decode_write_prep(inp.page_table, inp.positions, valid, page)

        def write(kv_cache, layer, q, k, v, bias):
            return ops.rope_write_kv_decode(kv_cache, layer, q, k, v, cos, sin, prep, bias)

    else:

        def write(kv_cache, layer, q, k, v, bias):
            q, k, v = ops.add_qkv_bias(q, k, v, bias)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            ops.write_kv_pages_full(kv_cache, layer, k, v, inp.page_table, inp.positions, valid)
            return q

    def attend(q, kv_cache, layer, sm_scale, window, sinks):
        return ops.paged_attention_full(
            q, kv_cache, layer, inp.page_table, inp.kv_lens, inp.positions,
            sm_scale, inp.live_pages, window, sinks,
        )

    return write, attend


def forward_hidden(params: dict, kv_cache, inp: StepInput, cfg: ModelConfig):
    """Run the decoder stack over the step; returns (hidden, kv_cache),
    hidden ``[T, 1, H]`` for the flat layout and ``[B, Q, H]`` for the
    bucketed one (``inp.token_rows is None``). The pool (a tensor, or the
    int8 pair) is updated in place. A ``first_dense_layers`` prefix runs
    first with its own weights on pool planes ``[0, n)``; the other layers
    follow on the planes after them. Layer i attends within
    ``cfg.layer_windows[i]`` (0 = full) and with its ``sinks`` leaf."""
    B, Q = inp.token_ids.shape
    D, Nq, K = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    x = params["embed"][inp.token_ids]  # [B, Q, H]
    # MLA rotates only its rope sub-dimension.
    rope_dim = cfg.qk_rope_head_dim if cfg.is_mla else D
    cos, sin = rope_tables(inp.positions, rope_dim, cfg.rope_theta, cfg.rope_scaling)
    sm_scale = D**-0.5
    windows = cfg.layer_windows
    if cfg.is_mla:
        if inp.token_rows is not None:
            raise ValueError("MLA runs the bucketed layout only (no flat step)")
        if (cfg.rope_scaling or {}).get("mscale_all_dim"):
            raise NotImplementedError("yarn mscale in MLA's sm_scale is not ported")
        if isinstance(kv_cache, tuple):
            raise ValueError("an int8 pool is not supported for MLA models")
        prep = None
        if Q == 1:
            prep = ops.decode_write_prep(
                inp.page_table, inp.positions, inp.valid, kv_cache.shape[3]
            )
    else:
        page = (kv_cache[0] if isinstance(kv_cache, tuple) else kv_cache).shape[3]
        write, attend = _write_attend(inp, page, cos, sin)

    def layer(x, lp, plane: int, moe: bool):
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        if cfg.is_mla:
            attn_out, _ = mla_attention(h, lp, kv_cache, plane, inp, cfg, cos, sin, prep)
            x = x + attn_out
        else:
            if "wqkv" in lp:
                qkv = h @ lp["wqkv"]
                q = qkv[..., : Nq * D]
                k = qkv[..., Nq * D : (Nq + K) * D]
                v = qkv[..., (Nq + K) * D :]
            else:
                q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
            q = q.reshape(B, Q, Nq, D)
            k = k.reshape(B, Q, K, D)
            v = v.reshape(B, Q, K, D)
            bias = (lp["bq"], lp["bk"], lp["bv"]) if cfg.attention_bias else None
            if cfg.qk_norm:  # Qwen3: per-head RMS norm (after any bias) before RoPE
                q, k, v = ops.add_qkv_bias(q, k, v, bias)
                bias = None
                q = rms_norm(q, lp["attn_q_norm"], cfg.rms_norm_eps)
                k = rms_norm(k, lp["attn_k_norm"], cfg.rms_norm_eps)
            q = write(kv_cache, plane, q, k, v, bias)
            attn = attend(q, kv_cache, plane, sm_scale, windows[plane], lp.get("sinks"))
            out = attn.reshape(B, Q, Nq * D) @ lp["wo"]
            if "bo" in lp:
                out = out + lp["bo"]
            x = x + out
        h2 = rms_norm(x, lp["post_norm"], cfg.rms_norm_eps)
        return x + (moe_block_grouped(h2, lp, cfg) if moe else _mlp(h2, lp))

    plane = 0
    for key, moe in (("dense_layers", False), ("layers", cfg.is_moe)):
        stack = params.get(key)
        if stack is None:
            continue
        for i in range(stack["input_norm"].shape[0]):
            x = layer(x, {name: w[i] for name, w in stack.items()}, plane, moe)
            plane += 1
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), kv_cache


def compute_logits(params: dict, hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Project hidden states [N, H] -> logits [N, V] (f32 for sampling)."""
    if cfg.tie_word_embeddings:
        return (hidden @ params["embed"].T).float()
    return (hidden @ params["lm_head"]).float()
