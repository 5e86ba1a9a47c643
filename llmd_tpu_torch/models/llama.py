"""Dense Llama-class decoder on the flat or the bucketed step layout.

The port of the dense branches of ``llmd_tpu/models/llama.py``: stacked
``[L, ...]`` weights with ``x @ W`` projections (the JAX leaf names, so a
parameter tree carries over by copy), fused or unfused q|k|v and gate|up,
optional QKV bias, Qwen3 QK-norm and tied or untied ``lm_head``. Where JAX
scans the layers, the port loops over them in Python; each layer writes its
K|V into the pool in place and then attends over it, through the entries
of ``llmd_tpu_torch.ops``: the flat pair on the packed ``[T, 1]`` stream,
the bucketed pair on ``[B, Q]`` rows (the decode kernels at ``Q == 1``). The
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


def init_params(
    cfg: ModelConfig, generator: torch.Generator, device: str | torch.device
) -> dict:
    """Seeded random weights, drawn on ``device`` (``generator`` must live
    there too): drawing 8B normals on the host would take minutes. Same
    tree and scales as the JAX ``init_params`` (fan-in scaling, embed 0.02,
    unit norms, zero biases); the values differ, as the generators do."""
    dt = getattr(torch, cfg.dtype)
    H, D = cfg.hidden_size, cfg.head_dim
    Nq, K, L = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    Fi, V = cfg.intermediate_size, cfg.vocab_size

    def normal(shape, scale):
        return (
            torch.randn(shape, generator=generator, device=device, dtype=dt)
            .mul_(scale)
        )

    def stacked(shape):
        # One layer at a time keeps the transient draw small.
        out = torch.empty((L, *shape), dtype=dt, device=device)
        for i in range(L):
            out[i] = normal(shape, shape[-2] ** -0.5)
        return out

    layers = {
        "input_norm": torch.ones((L, H), dtype=dt, device=device),
        "post_norm": torch.ones((L, H), dtype=dt, device=device),
        "wq": stacked((H, Nq * D)),
        "wk": stacked((H, K * D)),
        "wv": stacked((H, K * D)),
        "wo": stacked((Nq * D, H)),
        "w_gate": stacked((H, Fi)),
        "w_up": stacked((H, Fi)),
        "w_down": stacked((Fi, H)),
    }
    if cfg.attention_bias:
        for name, n in (("bq", Nq * D), ("bk", K * D), ("bv", K * D)):
            layers[name] = torch.zeros((L, n), dtype=dt, device=device)
    if cfg.qk_norm:
        layers["attn_q_norm"] = torch.ones((L, D), dtype=dt, device=device)
        layers["attn_k_norm"] = torch.ones((L, D), dtype=dt, device=device)
    params = {
        "embed": normal((V, H), 0.02),
        "layers": layers,
        "final_norm": torch.ones((H,), dtype=dt, device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((H, V), H**-0.5)
    return params


def fuse_projections(params: dict) -> dict:
    """q|k|v -> ``wqkv`` and gate|up -> ``w_gu`` (the JAX runner's
    ``_fuse_projection_tree``): one matmul where there were three or two.
    Exact: each output column is the same dot product."""
    layers = dict(params["layers"])
    for names, out in ((("wq", "wk", "wv"), "wqkv"), (("w_gate", "w_up"), "w_gu")):
        if all(n in layers for n in names):
            layers[out] = torch.cat([layers.pop(n) for n in names], dim=-1)
    return {**params, "layers": layers}


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


def _write_attend(inp: StepInput, page: int):
    """The layout's (write, attend) pair: ``write(kv_cache, layer, k, v)``
    and ``attend(q, kv_cache, layer, sm_scale)``, over what the step fixes
    for every layer."""
    if inp.token_rows is not None:

        def write(kv_cache, layer, k, v):
            return ops.write_kv_pages_full_flat(
                kv_cache, layer, k, v, inp.page_table, inp.token_rows,
                inp.positions, inp.num_live,
            )

        def attend(q, kv_cache, layer, sm_scale):
            return ops.paged_attention_full_flat(
                q, kv_cache, layer, inp.token_rows, inp.page_table,
                inp.kv_lens, sm_scale,
            )

        return write, attend

    valid = inp.valid
    prep = None
    if inp.token_ids.shape[1] == 1:
        prep = ops.decode_write_prep(inp.page_table, inp.positions, valid, page)

    def write(kv_cache, layer, k, v):
        return ops.write_kv_pages_full(
            kv_cache, layer, k, v, inp.page_table, inp.positions, valid, prep
        )

    def attend(q, kv_cache, layer, sm_scale):
        return ops.paged_attention_full(
            q, kv_cache, layer, inp.page_table, inp.kv_lens, inp.positions,
            sm_scale, inp.live_pages,
        )

    return write, attend


def forward_hidden(
    params: dict, kv_cache: torch.Tensor, inp: StepInput, cfg: ModelConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the decoder stack over the step; returns (hidden, kv_cache),
    hidden ``[T, 1, H]`` for the flat layout and ``[B, Q, H]`` for the
    bucketed one (``inp.token_rows is None``). The pool is updated in
    place."""
    B, Q = inp.token_ids.shape
    D, Nq, K = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    x = params["embed"][inp.token_ids]  # [B, Q, H]
    cos, sin = rope_tables(inp.positions, D, cfg.rope_theta)
    sm_scale = D**-0.5
    write, attend = _write_attend(inp, kv_cache.shape[3])
    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = {name: w[i] for name, w in layers.items()}
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        if "wqkv" in lp:
            qkv = h @ lp["wqkv"]
            q = qkv[..., : Nq * D]
            k = qkv[..., Nq * D : (Nq + K) * D]
            v = qkv[..., (Nq + K) * D :]
        else:
            q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
        if cfg.attention_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = q.reshape(B, Q, Nq, D)
        k = k.reshape(B, Q, K, D)
        if cfg.qk_norm:  # Qwen3: per-head RMS norm before RoPE
            q = rms_norm(q, lp["attn_q_norm"], cfg.rms_norm_eps)
            k = rms_norm(k, lp["attn_k_norm"], cfg.rms_norm_eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        v = v.reshape(B, Q, K, D)
        kv_cache = write(kv_cache, i, k, v)
        attn = attend(q, kv_cache, i, sm_scale)
        x = x + attn.reshape(B, Q, Nq * D) @ lp["wo"]
        h2 = rms_norm(x, lp["post_norm"], cfg.rms_norm_eps)
        x = x + _mlp(h2, lp)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), kv_cache


def compute_logits(params: dict, hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Project hidden states [N, H] -> logits [N, V] (f32 for sampling)."""
    if cfg.tie_word_embeddings:
        return (hidden @ params["embed"].T).float()
    return (hidden @ params["lm_head"]).float()
