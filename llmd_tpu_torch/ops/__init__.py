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
version, and no geometry gate: JAX's TPU gate sends head_dim 64 to XLA for
a lane constraint the card does not have, so gpt-oss attention runs on the
kernels here.

The pool is one tensor, or for ``CacheConfig.dtype="int8"`` the pair
``(data int8, scales f32)`` of ``ops/quant_kv.py`` (``_split_cache``, as in
JAX). The attention entries take the layer's sliding ``window`` (0 = full)
and per-head ``sinks``; an int8 pool's scales ride along to the kernels,
whose writes quantize the float K|V rows themselves.

MLA and MoE: ``mla_paged_attention_full`` follows the JAX rule as well
(``Q == 1`` → the latent decode kernel, ``Q > 1`` → the plain dense form of
``ops.mla_attention``), and ``grouped_matmul`` is the MoE experts' grouped
GEMM (``grouped_matmul_pair``: gate and up in one launch). The latent rows
are written by ``rope_write_latent_full``, K4''s latent form: ``kv_norm``,
both ropes, the padding, the store and q_eff's assembly in one launch a
layer at every Q (each token's page and slot from the page table and
positions), where JAX runs XLA around the store.

int8 weights (``ModelConfig.quantization="int8"``, ``ops/quant.py``): every
int8 product runs K6''s int8 branch (``matmul_q8`` for a dense product,
``grouped_matmul_q8`` and ``grouped_matmul_q8_pair`` for the experts) on
rows that ``quantize_rows`` quantized, or that the kernel making them
quantized: ``add_rms_norm_quant`` (residual add, RMSNorm, quantization)
and ``glu_quant`` (gated unit, quantization).

GQA layers write through the fused entries: ``rope_write_kv_flat`` (the
flat step) and ``rope_write_kv_decode`` (``Q == 1`` rows) add the q|k|v
biases, apply the rotary embedding to q and k, store k|v and return the
rotated q, in one launch of K2's or K4's fused form a layer. ``Q > 1``
bucketed rows keep ``apply_rope`` and ``write_kv_pages_full``'s plain
scatter, as the JAX package keeps XLA there.
"""

from __future__ import annotations

import collections

import torch

from llmd_tpu_torch.ops.grouped_gemm import (
    grouped_matmul,
    grouped_matmul_pair,
    grouped_matmul_pair_plain,
    grouped_matmul_plain,
    grouped_matmul_q8,
    grouped_matmul_q8_pair,
    grouped_matmul_q8_pair_plain,
    grouped_matmul_q8_plain,
    matmul_q8,
    matmul_q8_plain,
)
from llmd_tpu_torch.ops.kv_write import (
    add_qkv_bias,
    rope_write_kv_decode_full,
    rope_write_kv_decode_plain,
    rope_write_kv_flat_full,
    rope_write_kv_flat_plain,
    rope_write_latent_full,
    rope_write_latent_plain,
    write_branch,
    write_kv_pages_decode,
    write_kv_pages_decode_full,
    write_kv_pages_decode_plain,
    write_kv_pages_flat_full,
    write_kv_pages_flat_plain,
)
from llmd_tpu_torch.ops.mla_attention import mla_paged_attention_xla
from llmd_tpu_torch.ops.mla_decode import (
    mla_decode_paged_attention_full,
    mla_decode_paged_attention_plain,
)
from llmd_tpu_torch.ops.paged_attention import (
    paged_attention_xla,
    paged_attention_xla_blocked,
    scatter_kv_scales,
    scatter_kv_scales_flat,
    write_kv_pages,
)
from llmd_tpu_torch.ops.quant import (
    add_rms_norm_quant,
    add_rms_norm_quant_plain,
    glu_quant,
    glu_quant_plain,
    quantize_rows,
    quantize_rows_plain,
)
from llmd_tpu_torch.ops.quant_kv import (
    dequantize_pages,
    quantize_kv_rows,
    quantize_pages,
)
from llmd_tpu_torch.ops.ragged_paged_attention import (
    decode_paged_attention,
    decode_paged_attention_full,
    decode_paged_attention_plain,
    flat_paged_attention_full,
    flat_paged_attention_plain,
    flat_work_items,
)

# The kernel wrappers of the engine's paths; each counts its launches.
KERNELS = (
    write_kv_pages_flat_full,
    flat_paged_attention_full,
    write_kv_pages_decode_full,
    decode_paged_attention_full,
    mla_decode_paged_attention_full,
    grouped_matmul,
    grouped_matmul_pair,
    quantize_rows,
    matmul_q8,
    grouped_matmul_q8,
    grouped_matmul_q8_pair,
    add_rms_norm_quant,
    glu_quant,
)

# Above this many gathered positions the dense attention's [B, Q, .., S]
# score tensor dominates memory: switch to the blocked online-softmax form.
_DENSE_XLA_MAX_S = 4096


# The wrappers whose kernels carry the window, sink and int8 branches;
# each counts its launches per combination of branches too
# (``branch_launches``, keyed as ``ragged_paged_attention.branch_key``).
BRANCHED = (
    write_kv_pages_flat_full,
    flat_paged_attention_full,
    write_kv_pages_decode_full,
    decode_paged_attention_full,
)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn in BRANCHED:
        fn.branch_launches.clear()


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


def branch_launch_counts() -> dict[str, int]:
    """Launches per kernel and combination of branches taken, as
    ``"<wrapper>[<branches>]"`` (e.g. ``flat_paged_attention_full
    [int8+window+sinks]``, ``write_kv_pages_decode_full[plain]``); only
    combinations that launched appear."""
    return {
        f"{fn.__name__}[{key}]": n
        for fn in BRANCHED
        for key, n in sorted(fn.branch_launches.items())
        if n
    }


def launch_state() -> dict:
    """Every kernel wrapper's (launches, branch launches), to take back
    (``set_launch_state``), to diff (``launch_delta``) or to add
    (``add_launches``): a CUDA graph's replay runs the launches counted
    while it was captured, and nothing calls the wrappers then."""
    return {
        fn: (fn.launches, collections.Counter(getattr(fn, "branch_launches", ())))
        for fn in KERNELS
    }


def set_launch_state(state: dict) -> None:
    for fn, (n, branches) in state.items():
        fn.launches = n
        if fn in BRANCHED:
            fn.branch_launches.clear()
            fn.branch_launches.update(branches)


def launch_delta(after: dict, before: dict) -> dict:
    return {fn: (after[fn][0] - before[fn][0], after[fn][1] - before[fn][1])
            for fn in KERNELS}


def add_launches(delta: dict) -> None:
    for fn, (n, branches) in delta.items():
        fn.launches += n
        if fn in BRANCHED:
            fn.branch_launches.update(branches)


def _split_cache(kv_cache):
    """(data, scales) of a pool: an int8 pool travels as the pair (data
    int8, scales f32, ``ops/quant_kv.py``), a float pool as one tensor with
    scales None."""
    if isinstance(kv_cache, tuple):
        return kv_cache
    return kv_cache, None


def _sinks(sinks):
    """The kernels' f32 ``[H]`` sinks. The runner's parameters already hold
    them in f32 (``llama.fuse_projections``), so there this launches
    nothing."""
    return None if sinks is None else sinks.float().contiguous()


def write_kv_pages_full_flat(
    kv_cache_full: torch.Tensor,
    layer: int,
    k: torch.Tensor,  # [T, 1, K, D]
    v: torch.Tensor,  # [T, 1, K, D]
    page_table: torch.Tensor,  # [R, max_pages] compact per-row table
    rows: torch.Tensor,  # [T] token -> row
    positions: torch.Tensor,  # [T, 1]
    num_live: torch.Tensor,  # [1] i32 live tokens; the rest of the stream is padding
):
    """Flattened-token layer-indexed KV write, in place; returns the pool.
    An int8 pool takes the float rows and quantizes them in the kernel."""
    data, scales = _split_cache(kv_cache_full)
    if scales is None:
        k, v = k.to(data.dtype), v.to(data.dtype)
    write_kv_pages_flat_full(
        data, layer, k.contiguous(), v.contiguous(), page_table, rows,
        positions.reshape(-1), num_live, scales,
    )
    return kv_cache_full


def _by_row(x: torch.Tensor) -> torch.Tensor:
    """[B, Q, heads, D] -> [B Q, heads, D], a view where the input is one."""
    return x.reshape(-1, *x.shape[-2:])


def rope_write_kv_flat(
    kv_cache_full,
    layer: int,
    q: torch.Tensor,  # [T, 1, Nq, D]
    k: torch.Tensor,  # [T, 1, K, D]
    v: torch.Tensor,  # [T, 1, K, D]
    cos: torch.Tensor,  # [T, 1, D/2] f32 (rope_tables)
    sin: torch.Tensor,
    page_table: torch.Tensor,  # [R, max_pages] compact per-row table
    rows: torch.Tensor,  # [T] token -> row
    positions: torch.Tensor,  # [T, 1]
    num_live: torch.Tensor,  # [1] i32 live tokens; the rest of the stream is padding
    bias: tuple | None = None,  # (bq [Nq D], bk [K D], bv [K D])
) -> torch.Tensor:
    """The flat step's q|k|v bias, rotary embedding and layer-indexed KV
    write in one launch (K2's fused form). q, k and v may be views of the
    projection's output: only each token's [heads, D] block need be
    contiguous. Stores the live tokens' rotated k|v in place (an int8 pool
    quantizes them) and returns every token's rotated q, [T, 1, Nq, D]."""
    data, scales = _split_cache(kv_cache_full)
    T = q.shape[0]
    out = rope_write_kv_flat_full(
        data, layer, _by_row(q), _by_row(k), _by_row(v), cos.reshape(T, -1),
        sin.reshape(T, -1), page_table, rows, positions.reshape(-1), num_live, bias, scales,
    )
    return out.reshape(q.shape)


def paged_attention_full_flat(
    q: torch.Tensor,  # [T, 1, H, D]
    kv_cache_full: torch.Tensor,
    layer: int,
    rows: torch.Tensor,
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,  # [T] per token: position + 1
    sm_scale: float | None = None,
    window: int = 0,
    sinks: torch.Tensor | None = None,  # [H]
    items: torch.Tensor | None = None,  # [T, 2] flat_work_items
) -> torch.Tensor:
    """Flattened-token layer-indexed attention over the pool, with the
    layer's sliding ``window`` (0 = full) and ``sinks``; ``items`` is the
    step's query tiles (``flat_work_items``), built once for all layers."""
    data, scales = _split_cache(kv_cache_full)
    return flat_paged_attention_full(
        q.contiguous(), data, layer, rows, page_table, kv_lens, sm_scale,
        window, _sinks(sinks), scales, items,
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


def rope_write_kv_decode(
    kv_cache_full,
    layer: int,
    q: torch.Tensor,  # [B, 1, Nq, D]
    k: torch.Tensor,  # [B, 1, K, D]
    v: torch.Tensor,  # [B, 1, K, D]
    cos: torch.Tensor,  # [B, 1, D/2] f32 (rope_tables)
    sin: torch.Tensor,
    prep: tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # decode_write_prep
    bias: tuple | None = None,  # (bq [Nq D], bk [K D], bv [K D])
) -> torch.Tensor:
    """One-token-per-row (``Q == 1``) q|k|v bias, rotary embedding and
    layer-indexed KV write in one launch (K4's fused form), at the
    addressing ``prep`` (``decode_write_prep``). q, k and v may be views of
    the projection's output. Stores the live rows' rotated k|v in place (an
    int8 pool quantizes them) and returns every row's rotated q,
    [B, 1, Nq, D]."""
    data, scales = _split_cache(kv_cache_full)
    B = q.shape[0]
    out = rope_write_kv_decode_full(
        data, layer, _by_row(q), _by_row(k), _by_row(v), cos.reshape(B, -1),
        sin.reshape(B, -1), *prep, bias, scales,
    )
    return out.reshape(q.shape)


def write_kv_pages_full(
    kv_cache_full: torch.Tensor,
    layer: int,
    k: torch.Tensor,  # [B, Q, K, D]
    v: torch.Tensor,  # [B, Q, K, D]
    page_table: torch.Tensor,  # [B, max_pages]
    positions: torch.Tensor,  # [B, Q]
    valid: torch.Tensor,  # [B, Q] bool
    prep: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
):
    """Bucketed layer-indexed KV write, in place; returns the pool.
    ``Q == 1``: the decode write kernel; ``Q > 1``: the plain scatter, for
    an int8 pool after ``quantize_kv_rows`` and with the scales' own
    scatter."""
    data, scales = _split_cache(kv_cache_full)
    B, Q, K, D = k.shape
    if Q != 1:
        if scales is not None:
            k, v, srow = quantize_kv_rows(k, v)
            scatter_kv_scales(scales[layer], srow, page_table, positions, valid)
        write_kv_pages(data[layer], k, v, page_table, positions, valid)
        return kv_cache_full
    if prep is None:
        prep = decode_write_prep(page_table, positions, valid, data.shape[3])
    kv_new = torch.cat([k, v], dim=-1).reshape(B, K, 2 * D)
    if scales is None:
        kv_new = kv_new.to(data.dtype)
    write_kv_pages_decode_full(data, kv_new, layer, *prep, scales=scales)
    return kv_cache_full


def paged_attention_full(
    q: torch.Tensor,  # [B, Q, H, D]
    kv_cache_full: torch.Tensor,
    layer: int,
    page_table: torch.Tensor,  # [B, max_pages]
    kv_lens: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B, Q]
    sm_scale: float | None = None,
    live_pages: int | None = None,
    window: int = 0,
    sinks: torch.Tensor | None = None,  # [H]
) -> torch.Tensor:
    """Bucketed layer-indexed attention over the pool, with the layer's
    sliding ``window`` (0 = full) and ``sinks``. ``Q == 1``: the decode
    attention kernel; ``Q > 1``: the plain dense or blocked form.
    ``live_pages`` (the batch's largest live page count, known on the host)
    lets the plain forms gather that many table columns instead of all:
    the columns beyond hold no live position, so the result is the same."""
    data, scales = _split_cache(kv_cache_full)
    if q.shape[1] == 1:
        return decode_paged_attention_full(
            q.contiguous(), data, layer, page_table, kv_lens, sm_scale, window,
            _sinks(sinks), scales,
        )
    sl = data[layer]
    # The form follows the table's full width, as in the JAX package, so
    # both packages run the same arithmetic on the same configuration.
    blocked = page_table.shape[1] * sl.shape[2] > _DENSE_XLA_MAX_S
    if live_pages is not None:
        page_table = page_table[:, :live_pages]
    attend = paged_attention_xla_blocked if blocked else paged_attention_xla
    return attend(
        q, sl, page_table, kv_lens, positions, sm_scale, window=window,
        sinks=sinks, scales=None if scales is None else scales[layer],
    )


def mla_paged_attention_full(
    q_eff: torch.Tensor,  # [B, Q, H, Dl]
    latent_cache_full: torch.Tensor,  # [L, pages, 1, page, Dl]
    layer: int,
    page_table: torch.Tensor,  # [B, max_pages]
    kv_lens: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B, Q]
    rank: int,
    sm_scale: float,
    live_pages: int | None = None,
) -> torch.Tensor:
    """Layer-indexed MLA latent attention; returns ``[B, Q, H, rank]``.
    ``Q == 1``: the latent decode kernel; ``Q > 1``: the plain dense form,
    over the first ``live_pages`` table columns where the caller knows that
    bound (the columns beyond hold no live position: the same result)."""
    if q_eff.shape[1] == 1:
        return mla_decode_paged_attention_full(
            q_eff.contiguous(), latent_cache_full, layer, page_table, kv_lens,
            rank, sm_scale,
        )
    if live_pages is not None:
        page_table = page_table[:, :live_pages]
    return mla_paged_attention_xla(
        q_eff, latent_cache_full[layer], page_table, kv_lens, positions, rank, sm_scale
    )


__all__ = [
    "BRANCHED",
    "KERNELS",
    "add_launches",
    "add_rms_norm_quant",
    "add_rms_norm_quant_plain",
    "add_qkv_bias",
    "branch_launch_counts",
    "dequantize_pages",
    "quantize_kv_rows",
    "quantize_pages",
    "quantize_rows",
    "quantize_rows_plain",
    "scatter_kv_scales",
    "scatter_kv_scales_flat",
    "decode_paged_attention",
    "decode_paged_attention_full",
    "decode_paged_attention_plain",
    "decode_write_prep",
    "flat_paged_attention_full",
    "flat_paged_attention_plain",
    "flat_work_items",
    "glu_quant",
    "glu_quant_plain",
    "grouped_matmul",
    "grouped_matmul_pair",
    "grouped_matmul_pair_plain",
    "grouped_matmul_plain",
    "grouped_matmul_q8",
    "grouped_matmul_q8_pair",
    "grouped_matmul_q8_pair_plain",
    "grouped_matmul_q8_plain",
    "launch_counts",
    "launch_delta",
    "launch_state",
    "matmul_q8",
    "matmul_q8_plain",
    "mla_decode_paged_attention_full",
    "mla_decode_paged_attention_plain",
    "mla_paged_attention_full",
    "mla_paged_attention_xla",
    "paged_attention_full",
    "paged_attention_full_flat",
    "paged_attention_xla",
    "paged_attention_xla_blocked",
    "reset_launch_counts",
    "rope_write_kv_decode",
    "rope_write_kv_decode_full",
    "rope_write_kv_decode_plain",
    "rope_write_kv_flat",
    "rope_write_kv_flat_full",
    "rope_write_kv_flat_plain",
    "rope_write_latent_full",
    "rope_write_latent_plain",
    "set_launch_state",
    "write_branch",
    "write_kv_pages",
    "write_kv_pages_decode",
    "write_kv_pages_decode_full",
    "write_kv_pages_decode_plain",
    "write_kv_pages_flat_full",
    "write_kv_pages_flat_plain",
    "write_kv_pages_full",
    "write_kv_pages_full_flat",
]
