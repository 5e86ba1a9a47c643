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

int8 weights (``cfg.quantization == "int8"``, ``ops/quant.py``): the
``QUANT_NAMES`` leaves are int8, stored K-major (``[..., out, in]``, the
layout s8 ``wgmma`` reads; the float leaves and JAX's int8 ones are
``[..., in, out]``), with a ``<name>_scale`` f32 sibling, and
every projection takes the int8 product (K6''s int8 branch) where the
scale is there; a tied head stays ``embed.T`` in the float dtype, as in
JAX. Rows that come out of a norm or a gated unit are quantized by the
kernel that makes them: each norm takes the residual add pending before it
(a layer hands its MLP or MoE output to the next layer's input norm, the
attention output and ``bo`` to its post norm) in one
``ops.quant.add_rms_norm_quant``, whose quantized rows every product that
reads them shares (``qpdot``), and the gated unit before a down product is
``ops.quant.glu_quant``. The attention output's rows (``wo``) and the final
norm's (``lm_head``) keep ``pdot``: ``quantize_rows`` then the product.
Float trees run the plain adds and norms, as before.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from llmd_tpu_torch import ops
from llmd_tpu_torch.config import ModelConfig
from llmd_tpu_torch.models.common import StepInput, apply_rope, pdot, qpdot, rms_norm, rope_tables
from llmd_tpu_torch.models.mla import mla_attention
from llmd_tpu_torch.models.moe import moe_block_grouped
from llmd_tpu_torch.ops import quant
from llmd_tpu_torch.ops.quant import QUANT_NAMES, quantize_weight_into


def init_params(
    cfg: ModelConfig, generator: torch.Generator, device: str | torch.device,
    fused: bool = False,
) -> dict:
    """Seeded random weights, drawn on ``device`` (``generator`` must live
    there too): drawing billions of normals on the host would take minutes.
    Same tree and scales as the JAX ``init_params`` (fan-in scaling, embed
    0.02, router ``H ** -0.5``, sinks 1.0, unit norms, zero biases); the
    values differ, as the generators do. Stacked leaves are drawn one layer
    at a time in the working dtype: one deepseek-v2-lite layer's
    ``we_gate`` is 369 MB. ``fused`` draws q|k|v and gate|up straight into
    the column blocks of ``wqkv`` and ``w_gu`` (``fuse_projections``'s
    tree, the same values in the same draw order), so that no unfused
    stacked leaf is ever held beside its fused copy; MLA trees stay
    unfused, as the runner leaves them. With ``cfg.quantization ==
    "int8"`` every ``QUANT_NAMES`` leaf is quantized one layer at a time as
    it is drawn (``ops.quant.quantize_weight_into``, column blocks of a
    fused leaf apart) into a K-major int8 leaf (``[..., out, in]``): the
    tree is ``quantize_param_tree`` of the float draw, bit for bit, and the
    float tree is never whole on the device."""
    fused = fused and not cfg.is_mla
    q8 = cfg.quantization == "int8"
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

        def stacked(shape, scale=None, out=None, scales=None):
            """n layers of draws into ``out`` ([n, *shape]); with ``scales``
            (f32) each layer's draw is quantized into int8 ``out``."""
            if out is None:
                out = torch.empty((n, *shape), dtype=dt, device=device)
            for i in range(n):
                w = normal(shape, shape[-2] ** -0.5 if scale is None else scale)
                if scales is None:
                    out[i] = w
                else:
                    quantize_weight_into(w, out[i], scales[i])
            return out

        def empty(shape, name):
            """(leaf, scales or None) to draw ``name`` [n, *shape] into;
            under int8 the leaf is K-major, [n, *shape[:-2], out, in]."""
            if not (q8 and name in QUANT_NAMES):
                return torch.empty((n, *shape), dtype=dt, device=device), None
            kn = (*shape[:-2], shape[-1], shape[-2])
            return (torch.empty((n, *kn), dtype=torch.int8, device=device),
                    torch.empty((n, *shape[:-2], shape[-1]), dtype=torch.float32, device=device))

        def weight(name, shape):
            """The leaf ``name`` (and its scales under int8)."""
            out, scales = empty(shape, name)
            stacked(shape, out=out, scales=scales)
            return {name: out} if scales is None else {name: out, name + "_scale": scales}

        def stacked_columns(shapes, fused_name):
            """Leaves of ``shapes`` ([in, out_j] each), drawn in order:
            apart, or as column blocks of one ``fused_name`` leaf (row
            blocks of a K-major int8 one)."""
            if not fused:
                return {k: v for name, shape in shapes for k, v in weight(name, shape).items()}
            width = sum(shape[-1] for _, shape in shapes)
            out, scales = empty((shapes[0][1][0], width), shapes[0][0])
            c = 0
            for _, shape in shapes:
                cols = slice(c, c + shape[-1])
                if scales is None:
                    stacked(shape, out=out[..., cols])
                else:
                    stacked(shape, out=out[..., cols, :], scales=scales[..., cols])
                c += shape[-1]
            return {fused_name: out} if scales is None else {fused_name: out, fused_name + "_scale": scales}

        def const(shape, value, dtype=dt):
            return torch.full((n, *shape), value, dtype=dtype, device=device)

        layers = {"input_norm": const((H,), 1.0), "post_norm": const((H,), 1.0)}
        if cfg.is_mla:
            nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
            rank = cfg.kv_lora_rank
            layers.update(weight("wkv_a", (H, rank + rope)))
            layers["kv_norm"] = const((rank,), 1.0)
            layers["wkv_b"] = stacked((rank, Nq * (nope + vd)))
            layers.update(weight("wo", (Nq * vd, H)))
            if cfg.q_lora_rank > 0:
                layers.update(weight("wq_a", (H, cfg.q_lora_rank)))
                layers["q_norm"] = const((cfg.q_lora_rank,), 1.0)
                layers.update(weight("wq_b", (cfg.q_lora_rank, Nq * (nope + rope))))
            else:
                layers.update(weight("wq", (H, Nq * (nope + rope))))
        else:
            layers.update(stacked_columns(
                [("wq", (H, Nq * D)), ("wk", (H, K * D)), ("wv", (H, K * D))], "wqkv"))
            layers.update(weight("wo", (Nq * D, H)))
        if cfg.attention_bias:
            for name, width in (("bq", Nq * D), ("bk", K * D), ("bv", K * D)):
                layers[name] = const((width,), 0.0)
        if cfg.attention_out_bias:
            layers["bo"] = const((H,), 0.0)
        if cfg.attention_sinks:
            layers["sinks"] = stacked((Nq,), 1.0)
            if fused:
                layers["sinks"] = layers["sinks"].float()
        if cfg.qk_norm:
            layers["attn_q_norm"] = const((D,), 1.0)
            layers["attn_k_norm"] = const((D,), 1.0)
        if cfg.num_lora_adapters and not cfg.is_mla:
            layers.update(lora_slots(cfg, n, device, dt, draw=lambda shape: stacked(shape, H**-0.5)))
        if moe:
            E, Fm = cfg.num_experts, cfg.moe_intermediate_size
            layers["router"] = stacked((H, E), H**-0.5)
            if cfg.router_scoring == "sigmoid" or cfg.router_logit_bias:
                # V3's selection-only correction bias (noaux_tc), or
                # gpt-oss's logit bias.
                layers["router_bias"] = const((E,), 0.0, torch.float32)
            layers.update(weight("we_gate", (E, H, Fm)))
            layers.update(weight("we_up", (E, H, Fm)))
            layers.update(weight("we_down", (E, Fm, H)))
            if cfg.moe_activation == "swiglu_oss":
                layers["we_gate_b"] = const((E, Fm), 0.0)
                layers["we_up_b"] = const((E, Fm), 0.0)
                layers["we_down_b"] = const((E, H), 0.0)
            if cfg.shared_expert_intermediate_size:
                Fs = cfg.shared_expert_intermediate_size
                layers.update(weight("ws_gate", (H, Fs)))
                layers.update(weight("ws_up", (H, Fs)))
                layers.update(weight("ws_down", (Fs, H)))
        else:
            layers.update(stacked_columns([("w_gate", (H, Fi)), ("w_up", (H, Fi))], "w_gu"))
            layers.update(weight("w_down", (Fi, H)))
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
        head = normal((H, V), H**-0.5)
        if q8:
            params["lm_head"] = torch.empty((V, H), dtype=torch.int8, device=device)
            params["lm_head_scale"] = torch.empty((V,), dtype=torch.float32, device=device)
            quantize_weight_into(head, params["lm_head"], params["lm_head_scale"])
        else:
            params["lm_head"] = head
    return params


def lora_slots(cfg: ModelConfig, n: int, device, dtype, draw=None) -> dict:
    """The adapter slots of n layers (JAX ``llama.py:92-103``): ``la_q``,
    ``la_v`` [n, A + 1, H, r] and ``lb_q`` [n, A + 1, r, Nq * D], ``lb_v``
    [n, A + 1, r, K * D] on the q and v projections. Slot 0 is the base
    model (zeros); B starts at zero, so every slot serves the base model
    until ``set_lora_weights`` installs an adapter. ``draw(shape)`` draws
    A (random init); without it A is zero too (a loaded checkpoint's
    slots, as the JAX loader makes them). Float leaves: int8 trees leave
    them in the model's dtype."""
    A1, r = cfg.num_lora_adapters + 1, cfg.lora_rank
    H, D, Nq, K = cfg.hidden_size, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    out = {}
    for name in ("la_q", "la_v"):
        a = draw((A1, H, r)) if draw is not None else torch.zeros(
            (n, A1, H, r), dtype=dtype, device=device)
        a[:, 0] = 0
        out[name] = a
    out["lb_q"] = torch.zeros((n, A1, r, Nq * D), dtype=dtype, device=device)
    out["lb_v"] = torch.zeros((n, A1, r, K * D), dtype=dtype, device=device)
    return out


def lora_delta(h: torch.Tensor, lp: dict, ids: torch.Tensor, which: str) -> torch.Tensor:
    """The adapter term ``(h @ A) @ B`` of the q or v projection (``which``)
    for each row's slot ``ids`` (JAX's gathered ``einsum``s). Computed as
    two products over every slot at once, a row's A and B picked by a
    one-hot of its slot: ``[M, H] @ [H, S r]`` and ``[M, S r] @ [S r,
    N]``, with no per-row copy of a slot's weights; the other slots add
    exact zeros. Plain PyTorch, as JAX leaves it to XLA. ``h`` [..., H],
    ``ids`` the slot of each of h's rows (h's leading shape); returns
    [..., N]."""
    a, b = lp["la_" + which], lp["lb_" + which]  # [S, H, r], [S, r, N]
    S, H, r = a.shape
    lead = h.shape[:-1]
    xa = (h.reshape(-1, H) @ a.permute(1, 0, 2).reshape(H, S * r)).reshape(-1, S, r)
    onehot = ids.reshape(-1, 1) == torch.arange(S, device=ids.device)
    xa = torch.where(onehot[:, :, None], xa, torch.zeros((), dtype=xa.dtype, device=xa.device))
    return (xa.reshape(-1, S * r) @ b.reshape(S * r, -1)).reshape(*lead, -1)


def fuse_projections(params: dict) -> dict:
    """q|k|v -> ``wqkv`` and gate|up -> ``w_gu`` in ``layers`` and
    ``dense_layers`` (the JAX runner's ``_fuse_projection_tree``): one
    matmul where there were three or two. Exact: each output column is the
    same dot product; int8 leaves (K-major: joined as row blocks) carry
    their per-column scales along (``wqkv_scale``, ``w_gu_scale``), so the
    fused int8 product equals the separate ones bit for bit. The biases
    ``bq``, ``bk``, ``bv`` stay separate leaves, as in JAX. The ``sinks``
    leaf becomes f32 once here, the type the attention kernels read, rather
    than on every attention call. The runner skips it for MLA, as JAX
    does."""
    out = dict(params)
    for key in ("layers", "dense_layers"):
        if key not in out:
            continue
        layers = dict(out[key])
        for names, fused in ((("wq", "wk", "wv"), "wqkv"), (("w_gate", "w_up"), "w_gu")):
            if all(n in layers for n in names):
                parts = [layers.pop(n) for n in names]
                layers[fused] = torch.cat(parts, dim=-2 if parts[0].dtype == torch.int8 else -1)
                if all(f"{n}_scale" in layers for n in names):
                    layers[f"{fused}_scale"] = torch.cat(
                        [layers.pop(f"{n}_scale") for n in names], dim=-1)
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
    """The JAX parameter tree (leaves as numpy arrays, fused or unfused,
    float or int8 with their scales) as the port's tensors: a copy, but for
    the int8 leaves beside a ``<name>_scale``, which JAX keeps ``[..., in,
    out]`` and the port K-major, so they are transposed."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = params_from_jax(leaf, device)
        else:
            t = _to_torch(leaf)
            if t.dtype == torch.int8 and name + "_scale" in tree:
                t = t.mT.contiguous()
            out[name] = t.to(device)
    return out


def _mlp(h: torch.Tensor | None, lp: dict, hq: quant.QRows | None = None) -> torch.Tensor:
    """The dense SwiGLU MLP on h, or on its rows quantized (``hq``, int8
    trees: gate and up share them, ``glu_quant`` quantizes the gated unit
    for down; returns ``[M, H]``)."""
    if hq is not None:
        if "w_gu" in lp:
            xq, scale, _ = quant.glu_quant(qpdot(hq, lp, "w_gu"))
        else:
            xq, scale, _ = quant.glu_quant(qpdot(hq, lp, "w_gate"), qpdot(hq, lp, "w_up"))
        return qpdot(hq._replace(xq=xq, scale=scale), lp, "w_down")
    if "w_gu" in lp:
        gu = pdot(h, lp, "w_gu")
        Fi = gu.shape[-1] // 2
        return pdot(F.silu(gu[..., :Fi]) * gu[..., Fi:], lp, "w_down")
    return pdot(F.silu(pdot(h, lp, "w_gate")) * pdot(h, lp, "w_up"), lp, "w_down")


def _write_attend(
    inp: StepInput, page_table: torch.Tensor, page: int, cos: torch.Tensor, sin: torch.Tensor
):
    """The layout's (write, attend) pair over what the step fixes for every
    layer of one pool, addressed through ``page_table`` (the step's main
    table, or the ring-view table of the sliding layers' ring pool).
    ``write(kv_cache, layer, q, k, v, bias)`` adds the q|k|v biases
    (``bias`` = (bq, bk, bv) or None), rotates q and k by the step's rope
    tables, stores k|v and returns the rotated q; the flat step and ``Q ==
    1`` rows do all of it in one launch of the write kernel's fused form,
    ``Q > 1`` rows in plain PyTorch (``apply_rope``, the plain scatter), as
    the JAX package leaves those to XLA. ``attend(q, kv_cache, layer,
    sm_scale, window, sinks)`` is the attention over the pool."""
    if inp.token_rows is not None:

        def write(kv_cache, layer, q, k, v, bias):
            return ops.rope_write_kv_flat(
                kv_cache, layer, q, k, v, cos, sin, page_table, inp.token_rows,
                inp.positions, inp.num_live, bias,
            )

        def attend(q, kv_cache, layer, sm_scale, window, sinks):
            return ops.paged_attention_full_flat(
                q, kv_cache, layer, inp.token_rows, page_table,
                inp.kv_lens, sm_scale, window, sinks, inp.flat_items,
            )

        return write, attend

    valid = inp.valid
    if inp.token_ids.shape[1] == 1:
        prep = ops.decode_write_prep(page_table, inp.positions, valid, page)

        def write(kv_cache, layer, q, k, v, bias):
            return ops.rope_write_kv_decode(kv_cache, layer, q, k, v, cos, sin, prep, bias)

    else:

        def write(kv_cache, layer, q, k, v, bias):
            q, k, v = ops.add_qkv_bias(q, k, v, bias)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            ops.write_kv_pages_full(kv_cache, layer, k, v, page_table, inp.positions, valid)
            return q

    def attend(q, kv_cache, layer, sm_scale, window, sinks):
        return ops.paged_attention_full(
            q, kv_cache, layer, page_table, inp.kv_lens, inp.positions,
            sm_scale, inp.live_pages, window, sinks,
        )

    return write, attend


def forward_hidden(params: dict, kv_cache, inp: StepInput, cfg: ModelConfig, kv_swa=None):
    """Run the decoder stack over the step; returns (hidden, kv_cache), or
    (hidden, kv_cache, kv_swa) when ``kv_swa`` is given; hidden ``[T, 1,
    H]`` for the flat layout and ``[B, Q, H]`` for the bucketed one
    (``inp.token_rows is None``). The pools (a tensor, or the int8 pair)
    are updated in place. A ``first_dense_layers`` prefix runs first with
    its own weights; layer i attends within ``cfg.layer_windows[i]`` (0 =
    full) and with its ``sinks`` leaf. Without ``kv_swa`` layer i is
    plane i of ``kv_cache``. ``kv_swa`` is the sliding-window ring pool
    (``CacheConfig.swa_ring``): the sliding layers are its planes, counted
    within their group, addressed through ``inp.swa_page_table``, and the
    full layers are ``kv_cache``'s planes, counted likewise, through
    ``inp.page_table``. The kernels are the same: a window never reads a
    logical page older than itself, and those are the ring slots that have
    been overwritten."""
    B, Q = inp.token_ids.shape
    D, Nq, K = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    # MLA rotates only its rope sub-dimension.
    rope_dim = cfg.qk_rope_head_dim if cfg.is_mla else D
    cos, sin = rope_tables(inp.positions, rope_dim, cfg.rope_theta, cfg.rope_scaling)
    sm_scale = D**-0.5
    windows = cfg.layer_windows
    if cfg.is_mla:
        if inp.token_rows is not None:
            raise ValueError("MLA runs the bucketed layout only (no flat step)")
        if isinstance(kv_cache, tuple):
            raise ValueError("an int8 pool is not supported for MLA models")
        valid = inp.valid  # the latent writes' pads, once a step
    # Each layer's pool group (0: kv_cache, 1: the ring pool) and plane in
    # it. The window stays keyed by the layer id, not the plane.
    kinds = [int(kv_swa is not None and w > 0) for w in windows]
    planes = [kinds[:i].count(kinds[i]) for i in range(len(kinds))]
    caches = (kv_cache, kv_swa)
    if not cfg.is_mla:
        page = (kv_cache[0] if isinstance(kv_cache, tuple) else kv_cache).shape[3]
        # One (write, attend) pair a pool group that has layers, each with
        # its own decode addressing: built once a step, not once a layer.
        tables = (inp.page_table, inp.swa_page_table)
        pairs = {g: _write_attend(inp, tables[g], page, cos, sin) for g in set(kinds)}

    eps = cfg.rms_norm_eps
    # LoRA rows: each row's adapter terms need the float h, which an int8
    # tree's fused norm then writes beside its quantized rows.
    lora = bool(cfg.num_lora_adapters) and not cfg.is_mla and inp.lora_ids is not None
    if lora:
        lora_rows = inp.lora_ids.reshape(-1, 1).expand(B, Q)  # the slot of each token

    def norm(x, delta, bias, weight, lp, first: str, want_h: bool = False):
        """The residual add pending before a norm (``x + (delta + bias)``;
        none where delta is None) and the norm: (x, h, hq). Where the
        product that reads h (``lp[first]``) is int8, one fused launch
        (``quant.add_rms_norm_quant``) gives hq, h's rows quantized, and h
        only ``want_h``; else the plain add and ``rms_norm``, hq None."""
        if first + "_scale" not in lp:
            if delta is not None:
                x = x + (delta if bias is None else delta + bias)
            return x, rms_norm(x, weight, eps), None
        H = x.shape[-1]
        xn, h, xq, scale = quant.add_rms_norm_quant(
            x.reshape(-1, H), None if delta is None else delta.reshape(-1, H), bias, weight, eps, want_h)
        return (xn.reshape(x.shape), None if h is None else h.reshape(x.shape),
                quant.QRows(xq, scale, x.dtype))

    def layer(x, delta, lp, i: int, moe: bool):
        """One decoder layer on x with the previous layer's output ``delta``
        still to add (None at the first): returns (x, its own output)."""
        kv, plane = caches[kinds[i]], planes[i]
        if cfg.is_mla:
            first = "wq_a" if cfg.q_lora_rank > 0 else "wq"
        else:
            first = "wqkv" if "wqkv" in lp else "wq"
        x, h, hq = norm(x, delta, None, lp["input_norm"], lp, first, want_h=lora)
        bo = None
        if cfg.is_mla:
            attn_out, _ = mla_attention(h, lp, kv, plane, inp, cfg, cos, sin, valid, hq)
        else:

            def proj(name):
                return pdot(h, lp, name) if hq is None else qpdot(hq, lp, name).reshape(B, Q, -1)

            if "wqkv" in lp:
                qkv = proj("wqkv")
                q = qkv[..., : Nq * D]
                k = qkv[..., Nq * D : (Nq + K) * D]
                v = qkv[..., (Nq + K) * D :]
            else:
                q, k, v = proj("wq"), proj("wk"), proj("wv")
            q = q.reshape(B, Q, Nq, D)
            k = k.reshape(B, Q, K, D)
            v = v.reshape(B, Q, K, D)
            bias = (lp["bq"], lp["bk"], lp["bv"]) if cfg.attention_bias else None
            if lora:
                # The adapters' terms after the bias and before the QK norm
                # and the rope, in JAX's order of additions: the bias is
                # added here, not inside the fused write.
                q, k, v = ops.add_qkv_bias(q, k, v, bias)
                bias = None
                q = q + lora_delta(h, lp, lora_rows, "q").reshape(q.shape)
                v = v + lora_delta(h, lp, lora_rows, "v").reshape(v.shape)
            if cfg.qk_norm:  # Qwen3: per-head RMS norm (after any bias) before RoPE
                q, k, v = ops.add_qkv_bias(q, k, v, bias)
                bias = None
                q = rms_norm(q, lp["attn_q_norm"], eps)
                k = rms_norm(k, lp["attn_k_norm"], eps)
            write, attend = pairs[kinds[i]]
            q = write(kv, plane, q, k, v, bias)
            attn = attend(q, kv, plane, sm_scale, windows[i], lp.get("sinks"))
            attn_out = pdot(attn.reshape(B, Q, Nq * D), lp, "wo")
            bo = lp.get("bo")
        mlp_first = "we_gate" if moe else "w_gu" if "w_gu" in lp else "w_gate"
        x, h2, hq2 = norm(x, attn_out, bo, lp["post_norm"], lp, mlp_first, want_h=moe)
        out = moe_block_grouped(h2, lp, cfg, hq2) if moe else _mlp(h2, lp, hq2)
        return x, out.reshape(x.shape)

    i = 0
    x, delta = params["embed"][inp.token_ids], None  # [B, Q, H]
    for key, moe in (("dense_layers", False), ("layers", cfg.is_moe)):
        stack = params.get(key)
        if stack is None:
            continue
        for j in range(stack["input_norm"].shape[0]):
            x, delta = layer(x, delta, {name: w[j] for name, w in stack.items()}, i, moe)
            i += 1
    hidden = rms_norm(x + delta, params["final_norm"], eps)
    return (hidden, kv_cache) if kv_swa is None else (hidden, kv_cache, kv_swa)


def compute_logits(params: dict, hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Project hidden states [N, H] -> logits [N, V] (f32 for sampling)."""
    if cfg.tie_word_embeddings:
        return (hidden @ params["embed"].T).float()
    return pdot(hidden, params, "lm_head").float()
