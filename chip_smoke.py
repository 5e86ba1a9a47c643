#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``llmd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``llmd_tpu_torch/ops/csrc`` and drives
its main paths at the full width of llama-3-8b and of deepseek-v2-lite
(random weights from a seed):

1. ``device``  the card's name, and its name and power limit from nvidia-smi.
2. ``build``   nvcc of every kernel source, all started together.
3. ``kernels`` each kernel at llama-3-8b shapes (bf16, 32-layer pool)
               against its plain PyTorch version on the same inputs, and
               timed beside its bound, the plain version and one PyTorch
               library call computing the same function: the flat pair on
               one mixed flat step (3 prefill chunks + 32 decode rows), the
               decode pair on one decode step (batch bucket 64: 48 live
               rows at 1k-4k context, 16 pad rows).
4. ``forward`` one mixed flat step and one bucketed decode step (Q = 1, 64
               rows) of the 32-layer model through the kernels and through
               the plain versions on the card, both held to an f32 run.
5. ``engine``  ``LLMEngine`` serving 8 greedy requests (chunked prefill and
               a prefix-cache hit included), three times: on the flat step
               (the flat pair must launch layers x steps times each); as
               the split engine with fused decode windows of 8 (the decode
               pair must launch layers x the windows' iterations, the flat
               pair not at all); and on the flat step with windows of 8
               (the flat pair layers x flat steps, the decode pair layers x
               the windows' iterations). Every step must read back once.
6. ``layouts`` the tiny f32 model on the card: the flat step, the split
               engine with windows, the flat step with windows and the
               bucketed unified step give identical greedy and seeded
               streams.
7. ``moe_mla_kernels`` the grouped GEMM at deepseek-v2-lite's expert
               shapes (a 48-row decode step and a 1024-token prefill step)
               and qwen3-30b-a3b's, and the latent decode attention (batch
               bucket 64: 48 live rows at 1k-4k context, 16 pad rows, a
               27-layer latent pool), each against its plain version and
               timed beside its bound, the plain version and a library call.
8. ``forward`` (deepseek-v2-lite) a bucketed prefill forward and a Q = 1
               decode forward of the 27-layer model through the kernels and
               the plain versions; f32 reference on the first 4 layers.
9. ``engine``  (deepseek-v2-lite) ``LLMEngine`` serving 8 greedy requests
               on the default engine (the bucketed unified step: MLA has no
               flat step) and as the split engine with windows of 8; launch
               counts from a log of every forward's Q, one readback a step,
               window dispatches under ``set_sync_debug_mode("error")``.
10. ``serve``  ``python -m llmd_tpu_torch.serve`` answering three
               ``/v1/completions`` requests (one streamed), then a second
               server with ``--no-unified-step --decode-window 4`` whose
               streamed completion carries one chunk per token and the
               unstreamed completion's text, then a deepseek-v2-lite server.

Each phase prints one JSON line. Any failure raises and exits non-zero
without printing a result. On success the line before the last is the
kernel table and the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of ``llmd_tpu``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import socket
import statistics
import subprocess
import sys
import time
import urllib.request

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# Published H100 SXM peaks (NVIDIA data sheet; at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
MODEL = "llama-3-8b"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase(name: str, info: dict):
    t0 = time.perf_counter()
    yield info
    emit({"phase": name, "seconds": round(time.perf_counter() - t0, 3), **info})


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` single-call times from CUDA events, after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# Attention in bf16: the kernel and its plain version both reduce in f32 and
# round the output to bf16 once. Their f32 values agree to 1e-5 (the sums
# run in another order), so the rounded outputs may land one bf16 ulp apart,
# and an ulp is at most 2^-7 of the value: |got - want| must stay within
# BF16_ATOL + BF16_ULP * |want|. At the decode step's outputs (about 0.03)
# that is 2.6e-4, a hundredth of the values, so a dropped position shows.
BF16_ATOL, BF16_ULP = 2e-5, 2.0**-7


def outside_one_ulp(got: torch.Tensor, want: torch.Tensor) -> tuple[float, bool]:
    """(max abs error, whether any output is further than one bf16 ulp from
    the plain version's or is not finite)."""
    diff = (got.float() - want.float()).abs()
    bad = (diff > BF16_ATOL + BF16_ULP * want.float().abs()).any().item()
    return diff.max().item(), bad or not torch.isfinite(got).all().item()


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mixed_step(cfg, page, max_pages, prefills, decode_ctx, gen, dev):
    """A packed flat step: prefill chunks (prefix, chunk) then one-token
    decode rows at context lengths ``decode_ctx``; every row gets its own
    physical pages (a random permutation of the pool). Returns the
    per-token tensors, the page table and the pool size in pages."""
    rows_spec = [(p0, w) for p0, w in prefills] + [(c - 1, 1) for c in decode_ctx]
    need = [-(-(p0 + w) // page) for p0, w in rows_spec]
    num_pages = sum(need) + 8
    perm = torch.randperm(num_pages, generator=gen, device="cpu").to(torch.int32)
    page_table = torch.zeros((len(rows_spec), max_pages), dtype=torch.int32)
    rows, positions, off = [], [], 0
    for r, ((p0, w), n) in enumerate(zip(rows_spec, need)):
        page_table[r, :n] = perm[off : off + n]
        off += n
        rows += [r] * w
        positions += list(range(p0, p0 + w))
    total = len(rows)
    T = -(-total // 16) * 16
    rows += [len(rows_spec) - 1] * (T - total)
    positions += [0] * (T - total)
    rows_t = torch.tensor(rows, dtype=torch.int32, device=dev)
    pos_t = torch.tensor(positions, dtype=torch.int32, device=dev)
    live = torch.arange(T, device=dev) < total
    kv_lens = torch.where(live, pos_t + 1, 0).to(torch.int32)
    return {
        "rows": rows_t, "positions": pos_t, "kv_lens": kv_lens,
        "page_table": page_table.to(dev), "total": total, "T": T,
        "num_pages": num_pages, "rows_spec": rows_spec,
    }


def kernels_phase(info: dict) -> dict:
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(MODEL)
    dev, dt = torch.device("cuda"), torch.bfloat16
    L, K, H, D, page = cfg.num_layers, cfg.num_kv_heads, cfg.num_heads, cfg.head_dim, 16
    max_pages = -(-cfg.max_model_len // page)
    gen = torch.Generator().manual_seed(1234)
    # 3 prefill chunks of 128-512 tokens at prefixes 0-2k, 32 decode rows
    # at contexts 1k-4k: T = 928 live tokens of a 1024-token budget.
    decode_ctx = torch.randint(1024, 4097, (32,), generator=gen).tolist()
    s = mixed_step(cfg, page, max_pages, [(0, 512), (1024, 256), (2000, 128)],
                   decode_ctx, gen, dev)
    T, total = s["T"], s["total"]
    layer = L // 2
    g = torch.Generator(device=dev).manual_seed(99)
    pool = torch.randn((L, s["num_pages"], K, page, 2 * D), generator=g, device=dev, dtype=dt)
    q = torch.randn((T, 1, H, D), generator=g, device=dev, dtype=dt)
    k = torch.randn((T, 1, K, D), generator=g, device=dev, dtype=dt)
    v = torch.randn((T, 1, K, D), generator=g, device=dev, dtype=dt)
    es = pool.element_size()
    info.update(T=T, live_tokens=total, pool_pages=s["num_pages"], layers=L)
    out = []

    # --- K2': flat KV write. The pool bytes must equal the plain version's
    # exactly: both are pure copies of the same bf16 values.
    ref = pool.clone()
    args = (layer, k, v, s["page_table"], s["rows"], s["positions"], total)
    ops.write_kv_pages_flat_full(pool, *args)
    ops.write_kv_pages_flat_plain(ref, *args)
    torch.cuda.synchronize()
    if not torch.equal(pool, ref):
        raise AssertionError("flat_kv_write: pool bytes differ from the plain version")
    err = (pool[layer].float() - ref[layer].float()).abs().max().item()
    del ref
    pos_l = s["positions"][:total].long()
    phys = s["page_table"][s["rows"][:total].long(), pos_l // page].long()
    slot = pos_l % page
    heads = torch.arange(K, device=dev)
    kv_live = torch.cat([k[:total, 0], v[:total, 0]], dim=-1)
    layer_view = pool[layer]
    nbytes = 2 * (2 * total * K * D * es) + 3 * 4 * total  # k|v in, pool out, indices
    b_ms, b_by = bound(nbytes, 0.0)
    out.append({
        "name": "flat_kv_write", "route": "cuda",
        "source": "llmd_tpu_torch/ops/csrc/flat_kv_write.cu",
        "replaces": "llmd_tpu/ops/kv_write.py:212",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.write_kv_pages_flat_full(pool, *args)),
        "plain_ms": cuda_ms(lambda: ops.write_kv_pages_flat_plain(pool, *args)),
        "bound_ms": b_ms, "bound_by": b_by,
        # one index_put_ with the (page, head, slot) indices precomputed
        "library_ms": cuda_ms(lambda: layer_view.index_put_(
            (phys[:, None], heads[None, :], slot[:, None]), kv_live)),
    })

    # --- K1': flat paged attention, within one bf16 ulp of the plain
    # version (outside_one_ulp).
    aargs = (q, pool, layer, s["rows"], s["page_table"], s["kv_lens"])
    got = ops.flat_paged_attention_full(*aargs)
    want = ops.flat_paged_attention_plain(*aargs)
    torch.cuda.synchronize()
    err, bad = outside_one_ulp(got, want)
    if bad:
        raise AssertionError(f"flat_paged_attention: max abs err {err} vs plain")
    # Bound: every row's distinct live K|V read once, q read, out written;
    # operations: QK and PV, 2 flops per multiply-add, per live token.
    ctx = [p0 + w for p0, w in s["rows_spec"]]
    kv_bytes = sum(ctx) * K * 2 * D * es
    qo_bytes = 2 * total * H * D * es
    flops = 4.0 * H * D * s["kv_lens"].sum().item()
    b_ms, b_by = bound(kv_bytes + qo_bytes, flops)
    lib_ms = _sdpa_yardstick(q, pool, layer, s, page)
    out.append({
        "name": "flat_paged_attention", "route": "cuda",
        "source": "llmd_tpu_torch/ops/csrc/flat_paged_attention.cu",
        "replaces": "llmd_tpu/ops/ragged_paged_attention.py:344",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.flat_paged_attention_full(*aargs)),
        "plain_ms": cuda_ms(lambda: ops.flat_paged_attention_plain(*aargs), reps=20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
    })
    for e in out:
        info[e["name"]] = {key: e[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
    return {e["name"]: e for e in out}


def decode_batch(cfg, page, lo, hi, gen, dev) -> dict:
    """One decode step (one token per row) of the batch bucket 64: 48 live
    rows at contexts drawn from [lo, hi], each writing its last position,
    then 16 pad rows (kv_len = 0, valid = 0, a garbage physical page).
    Every live row gets its own physical pages."""
    B, n_live = 64, 48
    ctx = torch.randint(lo, hi + 1, (n_live,), generator=gen).tolist()
    need = [-(-c // page) for c in ctx]
    num_pages = sum(need) + 8
    perm = torch.randperm(num_pages, generator=gen).to(torch.int32)
    page_table = torch.zeros((B, -(-cfg.max_model_len // page)), dtype=torch.int32)
    off = 0
    for r, n in enumerate(need):
        page_table[r, :n] = perm[off : off + n]
        off += n
    kv_lens = torch.tensor(ctx + [0] * (B - n_live), dtype=torch.int32)
    pos = (kv_lens - 1).clamp(min=0)
    phys = page_table[torch.arange(B), (pos // page).long()].clone()
    phys[n_live:] = 2**30  # pad rows: never dereferenced
    return {
        "B": B, "n_live": n_live, "ctx": ctx, "num_pages": num_pages,
        "live_pages": max(need),
        "page_table": page_table.to(dev), "kv_lens": kv_lens.to(dev),
        "positions": pos[:, None].to(dev), "phys": phys.to(dev),
        "offset": (pos % page).to(dev), "valid": (kv_lens > 0).to(torch.int32).to(dev),
    }


def decode_kernels_phase(info: dict) -> dict:
    """K3' and K4' on one decode step of the batch bucket 64: 48 live rows
    at contexts spread over 1,024-4,096 tokens, then 16 pad rows
    (valid = 0, kv_len = 0, a garbage physical page)."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(MODEL)
    dev, dt = torch.device("cuda"), torch.bfloat16
    L, K, H, D, page = cfg.num_layers, cfg.num_kv_heads, cfg.num_heads, cfg.head_dim, 16
    d = decode_batch(cfg, page, 1024, 4096, torch.Generator().manual_seed(4321), dev)
    B, n_live, ctx, num_pages = d["B"], d["n_live"], d["ctx"], d["num_pages"]
    page_table, kv_lens = d["page_table"], d["kv_lens"]
    phys, offset, valid = d["phys"], d["offset"], d["valid"]
    layer = L // 2
    g = torch.Generator(device=dev).manual_seed(77)
    pool = torch.randn((L, num_pages, K, page, 2 * D), generator=g, device=dev, dtype=dt)
    q = torch.randn((B, 1, H, D), generator=g, device=dev, dtype=dt)
    kv_new = torch.randn((B, K, 2 * D), generator=g, device=dev, dtype=dt)
    es = pool.element_size()
    live_pages = d["live_pages"]
    info.update(batch=B, live_rows=n_live, context_tokens=sum(ctx), pool_pages=num_pages,
                pool_gib=pool.numel() * es / 2**30, layers=L)
    out = []

    # --- K4': decode KV write. Both are pure copies of the same bf16
    # values, so the pool bytes must equal the plain version's exactly;
    # that also shows the pad rows' garbage targets were left alone.
    ref = pool.clone()
    wargs = (kv_new, layer, phys, offset, valid)
    ops.write_kv_pages_decode_full(pool, *wargs)
    ops.write_kv_pages_decode_plain(ref, *wargs)
    torch.cuda.synchronize()
    if not torch.equal(pool, ref):
        raise AssertionError("decode_kv_write: pool bytes differ from the plain version")
    err = (pool[layer].float() - ref[layer].float()).abs().max().item()
    del ref
    heads = torch.arange(K, device=dev)
    lp, lo = phys[:n_live].long(), offset[:n_live].long()
    kv_live = kv_new[:n_live]
    layer_view = pool[layer]
    nbytes = 2 * (n_live * K * 2 * D * es) + 3 * 4 * B  # kv in, pool out, indices
    b_ms, b_by = bound(nbytes, 0.0)
    out.append({
        "name": "decode_kv_write", "route": "cuda",
        "source": "llmd_tpu_torch/ops/csrc/decode_kv_write.cu",
        "replaces": "llmd_tpu/ops/kv_write.py:298",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.write_kv_pages_decode_full(pool, *wargs)),
        "plain_ms": cuda_ms(lambda: ops.write_kv_pages_decode_plain(pool, *wargs)),
        "bound_ms": b_ms, "bound_by": b_by,
        # one index_put_ with the live rows' (page, head, slot) precomputed
        "library_ms": cuda_ms(lambda: layer_view.index_put_(
            (lp[:, None], heads[None, :], lo[:, None]), kv_live)),
    })

    # --- K3': decode paged attention, within one bf16 ulp of the plain
    # version (outside_one_ulp). Pad rows are exactly zero.
    aargs = (q, pool, layer, page_table, kv_lens)
    got = ops.decode_paged_attention_full(*aargs)
    want = ops.decode_paged_attention_plain(*aargs, live_pages=live_pages)
    torch.cuda.synchronize()
    err, bad = outside_one_ulp(got, want)
    if bad:
        raise AssertionError(f"decode_paged_attention: max abs err {err} vs plain")
    if got[n_live:].any():
        raise AssertionError("decode_paged_attention: a pad row is not zero")
    del want
    # Bound: every live row's K|V read once, q read, out written;
    # operations: QK and PV, 2 flops per multiply-add.
    kv_bytes = sum(ctx) * K * 2 * D * es
    qo_bytes = 2 * B * H * D * es
    b_ms, b_by = bound(kv_bytes + qo_bytes, 4.0 * H * D * sum(ctx))
    spec = {"rows_spec": [(c - 1, 1) for c in ctx], "page_table": page_table}
    lib_ms = _sdpa_yardstick(q[:n_live], pool, layer, spec, page)
    out.append({
        "name": "decode_paged_attention", "route": "cuda",
        "source": "llmd_tpu_torch/ops/csrc/decode_paged_attention.cu",
        "replaces": "llmd_tpu/ops/ragged_paged_attention.py:463",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.decode_paged_attention_full(*aargs)),
        "plain_ms": cuda_ms(
            lambda: ops.decode_paged_attention_plain(*aargs, live_pages=live_pages), reps=10),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
    })
    for e in out:
        info[e["name"]] = {key: e[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
    return {e["name"]: e for e in out}


def _sdpa_yardstick(q, pool, layer, s, page) -> float:
    """Time of one ``scaled_dot_product_attention`` call on the same step,
    with each row's live context gathered to a dense, padded layout
    beforehand (the gather is not timed)."""
    import torch.nn.functional as F

    T, _, H, D = q.shape
    K = pool.shape[2]
    spec = s["rows_spec"]
    R = len(spec)
    qmax = max(w for _, w in spec)
    smax = max(p0 + w for p0, w in spec)
    dev = q.device
    Qd = torch.zeros((R, H, qmax, D), dtype=q.dtype, device=dev)
    Kd = torch.zeros((R, K, smax, D), dtype=q.dtype, device=dev)
    Vd = torch.zeros_like(Kd)
    mask = torch.zeros((R, 1, qmax, smax), dtype=torch.bool, device=dev)
    mask[..., 0] = True  # pad query slots: keep one key so no row is empty
    t = 0
    for r, (p0, w) in enumerate(spec):
        n = p0 + w
        pages = s["page_table"][r, : -(-n // page)].long()
        kv = pool[layer, pages].permute(1, 0, 2, 3).reshape(K, -1, 2 * D)[:, :n]
        Kd[r, :, :n] = kv[..., :D]
        Vd[r, :, :n] = kv[..., D:]
        Qd[r, :, :w] = q[t : t + w, 0].transpose(0, 1)
        mask[r, 0, :w, :n] = (
            torch.arange(n, device=dev)[None, :]
            <= torch.arange(p0, p0 + w, device=dev)[:, None]
        )
        t += w
    G = H // K
    Kd = Kd.repeat_interleave(G, dim=1)
    Vd = Vd.repeat_interleave(G, dim=1)
    return cuda_ms(lambda: F.scaled_dot_product_attention(Qd, Kd, Vd, attn_mask=mask))


@contextlib.contextmanager
def plain_ops(live_pages: int | None = None):
    """Route the model's flat ops, decode kernels, latent decode attention
    and grouped GEMM to their plain versions (the reference runs of the
    forward phases), restoring the kernels after. ``live_pages`` bounds the
    plain decode attentions' gathers."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.ops import grouped_gemm

    saved = (ops.write_kv_pages_full_flat, ops.paged_attention_full_flat,
             ops.write_kv_pages_decode_full, ops.decode_paged_attention_full,
             ops.mla_decode_paged_attention_full, grouped_gemm.grouped_matmul)

    def write(kv_cache, layer, k, v, page_table, rows, positions, total):
        return ops.write_kv_pages_flat_plain(
            kv_cache, layer, k, v, page_table, rows, positions.reshape(-1), total
        )

    def attend(q, kv_cache, layer, rows, page_table, kv_lens, sm_scale=None):
        return ops.flat_paged_attention_plain(
            q, kv_cache, layer, rows, page_table, kv_lens, sm_scale
        )

    def decode_attend(q, kv_cache, layer, page_table, kv_lens, sm_scale=None):
        return ops.decode_paged_attention_plain(
            q, kv_cache, layer, page_table, kv_lens, sm_scale, live_pages
        )

    def latent_attend(q_eff, cache, layer, page_table, kv_lens, rank, sm_scale):
        return ops.mla_decode_paged_attention_plain(
            q_eff, cache, layer, page_table, kv_lens, rank, sm_scale, live_pages
        )

    ops.write_kv_pages_full_flat, ops.paged_attention_full_flat = write, attend
    ops.write_kv_pages_decode_full = ops.write_kv_pages_decode_plain
    ops.decode_paged_attention_full = decode_attend
    ops.mla_decode_paged_attention_full = latent_attend
    grouped_gemm.grouped_matmul = ops.grouped_matmul_plain
    try:
        yield
    finally:
        (ops.write_kv_pages_full_flat, ops.paged_attention_full_flat,
         ops.write_kv_pages_decode_full, ops.decode_paged_attention_full,
         ops.mla_decode_paged_attention_full, grouped_gemm.grouped_matmul) = saved


def forward_phase(info: dict, params: dict) -> None:
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.common import StepInput
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(MODEL)
    dev, page = torch.device("cuda"), 16
    gen = torch.Generator().manual_seed(7)
    g = torch.Generator(device=dev).manual_seed(5)
    L = cfg.num_layers

    # The mixed flat step.
    decode_ctx = torch.randint(200, 1001, (16,), generator=gen).tolist()
    s = mixed_step(cfg, page, -(-cfg.max_model_len // page),
                   [(0, 300), (600, 200)], decode_ctx, gen, dev)
    live = torch.arange(s["T"], device=dev) < s["total"]
    ids = torch.randint(0, cfg.vocab_size, (s["T"],), generator=g, device=dev)
    flat_inp = StepInput(
        token_ids=torch.where(live, ids, 0)[:, None],
        positions=s["positions"][:, None],
        kv_lens=s["kv_lens"],
        page_table=s["page_table"],
        token_rows=s["rows"],
        num_live=s["total"],
    )
    # The bucketed decode step (Q = 1), at contexts of 128-640 tokens.
    d = decode_batch(cfg, page, 128, 640, gen, dev)
    ids = torch.randint(0, cfg.vocab_size, (d["B"], 1), generator=g, device=dev)
    decode_inp = StepInput(
        token_ids=torch.where(d["valid"][:, None] > 0, ids, 0),
        positions=d["positions"], kv_lens=d["kv_lens"],
        page_table=d["page_table"], query_lens=d["valid"],
    )
    steps = {
        # name: (input, pool pages, live rows of the hidden state, the
        # wrappers that must launch once a layer, plain gather bound)
        "flat": (flat_inp, s["num_pages"], s["total"],
                 ("write_kv_pages_flat_full", "flat_paged_attention_full"), None),
        "decode": (decode_inp, d["num_pages"], d["n_live"],
                   ("write_kv_pages_decode_full", "decode_paged_attention_full"),
                   d["live_pages"]),
    }
    # The same weights upcast: the f32 reference both bf16 runs are
    # measured from.
    params32 = _tree_map(params, lambda w: w.float())

    def rel(a: torch.Tensor, b: torch.Tensor) -> float:
        return ((a - b).norm() / b.norm()).item()

    for name, (inp, num_pages, n_live, wrappers, live_pages) in steps.items():
        shape = (L, num_pages, cfg.num_kv_heads, page, 2 * cfg.head_dim)
        pool = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)

        def run(p: dict, work: torch.Tensor, plain: bool):
            """One forward that writes into ``work`` (a fresh copy of the
            pool); returns the live hidden states in f32 and layer 0 of
            the written pool."""
            ctx = plain_ops(live_pages) if plain else contextlib.nullcontext()
            with torch.inference_mode(), ctx:
                h, _ = llama.forward_hidden(p, work, inp, cfg)
            return h.reshape(-1, h.shape[-1])[:n_live].float(), work[0].clone()

        ops.reset_launch_counts()
        h_k, pool0_k = run(params, pool.clone(), plain=False)
        counts = ops.launch_counts()
        h_p, pool0_p = run(params, pool.clone(), plain=True)
        h_k32, _ = run(params32, pool.float(), plain=False)
        h_ref, _ = run(params32, pool.float(), plain=True)
        with torch.inference_mode():
            # Whole-step times in bf16 (a step rewrites the same K|V, so
            # the pool keeps its contents), CUDA events.
            fwd_ms = cuda_ms(lambda: llama.forward_hidden(params, pool, inp, cfg), reps=3, warmup=1)
            with plain_ops(live_pages):
                fwd_plain_ms = cuda_ms(
                    lambda: llama.forward_hidden(params, pool, inp, cfg), reps=3, warmup=1
                )
        torch.cuda.synchronize()
        want = {fn: (L if fn in wrappers else 0) for fn in counts}
        if counts != want:
            raise AssertionError(f"{name} forward launched {counts}, want {want}")
        r = {
            "live_rows": n_live, "rows": inp.token_ids.shape[0], "layers": L,
            "f32_rel_err": rel(h_k32, h_ref), "bf16_rel_err": rel(h_k, h_p),
            "bf16_kernels_vs_f32": rel(h_k, h_ref), "bf16_plain_vs_f32": rel(h_p, h_ref),
            "layer0_pool_equal": bool(torch.equal(pool0_k, pool0_p)),
            "step_ms": fwd_ms, "step_plain_ms": fwd_plain_ms,
        }
        info[name] = r
        if not all(torch.isfinite(h).all() for h in (h_k, h_p, h_k32, h_ref)):
            raise AssertionError(f"{name} forward: non-finite hidden states")
        # Layer 0 writes K|V computed from the same inputs on both paths:
        # the kernel's pool bytes must equal the plain version's.
        if not r["layer0_pool_equal"]:
            raise AssertionError(f"{name} forward: layer-0 pool bytes differ between the paths")
        # f32: the two paths differ only in the attention's summation order
        # (about 1e-6 relative per layer), amplified through 32 random layers.
        if r["f32_rel_err"] > 1e-3:
            raise AssertionError(f"{name} forward: f32 relative error {r['f32_rel_err']} (limit 1e-3)")
        # bf16: a one-ulp difference in an attention output grows through 32
        # layers of bf16 matmuls, so the two bf16 runs are not compared with
        # each other; instead the kernels' run may be no further from the f32
        # run than 1.5 times the plain run's distance.
        if r["bf16_kernels_vs_f32"] > 1.5 * r["bf16_plain_vs_f32"]:
            raise AssertionError(
                f"{name} forward: bf16 kernels {r['bf16_kernels_vs_f32']} from f32, "
                f"plain {r['bf16_plain_vs_f32']} (limit 1.5x)"
            )
        del pool, pool0_k, pool0_p, h_k, h_p, h_k32, h_ref
        torch.cuda.empty_cache()
    del params32


def _tree_map(tree: dict, fn) -> dict:
    return {k: _tree_map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@contextlib.contextmanager
def counting_readbacks():
    """Count the device->host copies (``Tensor.cpu``) made inside."""
    calls = []
    orig = torch.Tensor.cpu

    def cpu(self, *args, **kwargs):
        calls.append(tuple(self.shape))
        return orig(self, *args, **kwargs)

    torch.Tensor.cpu = cpu
    try:
        yield calls
    finally:
        torch.Tensor.cpu = orig


ENGINE_LAYOUTS = {
    "flat step": {},
    "split engine, decode_window 8": dict(unified_step=False, decode_window=8),
    "flat step, decode_window 8": dict(decode_window=8),
}


def engine_phase(info: dict, params: dict) -> dict:
    """``LLMEngine`` at full width serving 8 greedy requests in the step
    layout ``info["layout"]`` names: on the flat step; as the split engine
    with fused decode windows of 8; or on the flat step with windows of 8
    (steps that hold a prefill run flat, pure-decode steps run as windows).
    Returns the launch counts of the run."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from llmd_tpu_torch.engine import LLMEngine, SamplingParams
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(MODEL)
    layout = ENGINE_LAYOUTS[info["layout"]]
    windowed = "decode_window" in layout
    config = EngineConfig(
        model=cfg,
        cache=CacheConfig(page_size=16, num_blocks=2048, dtype="bfloat16"),
        scheduler=SchedulerConfig(max_num_seqs=64, max_num_batched_tokens=1024, **layout),
        seed=0,
    )
    eng = LLMEngine(config, params=params, device="cuda")
    k_steps: list[int] = []  # iterations of each decode window dispatched
    dispatch = eng.runner.dispatch_staged_decode

    def logged(staged):
        k_steps.append(staged.k)
        return dispatch(staged)

    eng.runner.dispatch_staged_decode = logged
    gen = torch.Generator().manual_seed(11)
    # 1500 > max_num_batched_tokens: that prompt prefills in chunks.
    lengths = [16, 100, 300, 700, 1500, 64, 900]
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist() for n in lengths]
    sp = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True)
    ops.reset_launch_counts()
    tokens: dict[str, list[int]] = {}
    ttft: dict[str, float] = {}
    last: dict[str, float] = {}
    cached: dict[str, int] = {}
    t0 = time.perf_counter()
    # The 8th request repeats the 700-token prompt after the first wave has
    # committed its pages: its prefill starts from a prefix-cache hit.
    step_log: list[tuple[int, float]] = []  # (live tokens, host ms) per step
    window_ms: list[float] = []  # host ms per token of each pure decode-window step
    with counting_readbacks() as readbacks:
        for wave in (prompts, [prompts[3]]):
            tw = time.perf_counter()
            for p in wave:
                tokens[eng.add_request(p, sp)] = []
            while eng.has_work():
                live0, ts = eng.runner.live_tokens_total, time.perf_counter()
                windows0, dispatches0 = len(k_steps), eng.stats.step_dispatches_total
                # step() ends in the step's one device->host copy, so the
                # host clock spans the device work.
                for out in eng.step():
                    tokens[out.request_id] += out.new_token_ids
                    ttft.setdefault(out.request_id, time.perf_counter() - tw)
                    last[out.request_id] = time.perf_counter() - tw
                    cached[out.request_id] = out.num_cached_tokens
                ms = (time.perf_counter() - ts) * 1e3
                step_log.append((eng.runner.live_tokens_total - live0, ms))
                if len(k_steps) > windows0 and eng.stats.step_dispatches_total == dispatches0 + 1:
                    window_ms.append(ms / k_steps[-1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats
    steps = st.engine_steps_total
    counts = ops.launch_counts()
    rids = list(tokens)
    # Time per output token of a request: from its first token to its last.
    tpot = [(last[r] - ttft[r]) / (len(tokens[r]) - 1) for r in rids]
    info.update(
        requests=len(rids), steps=steps, wall_s=wall,
        output_tok_per_s=sum(len(t) for t in tokens.values()) / wall,
        ttft_median_s=statistics.median(ttft.values()), ttft_max_s=max(ttft.values()),
        tpot_median_ms=statistics.median(tpot) * 1e3,
        prefix_cached_tokens=cached[rids[-1]], repeat_matches_first=tokens[rids[-1]] == tokens[rids[3]],
        step_dispatches=st.step_dispatches_total, decode_dispatches=st.decode_dispatches_total,
        unified_steps=st.unified_steps_total, readbacks=len(readbacks),
        launches=counts,
    )
    if any(len(t) != 32 for t in tokens.values()):
        raise AssertionError(f"not every request produced 32 tokens: {[len(t) for t in tokens.values()]}")
    if cached[rids[-1]] <= 0:
        raise AssertionError("the repeated prompt did not hit the prefix cache")
    if len(readbacks) != steps:
        raise AssertionError(f"{len(readbacks)} device->host copies in {steps} steps")
    L = cfg.num_layers
    # The flat pair runs once a layer in every flat step, the decode pair
    # once a layer in every iteration of every decode window.
    flat_steps = st.unified_steps_total if eng.runner.flat else 0
    want = {"write_kv_pages_flat_full": L * flat_steps,
            "flat_paged_attention_full": L * flat_steps,
            "write_kv_pages_decode_full": L * sum(k_steps),
            "decode_paged_attention_full": L * sum(k_steps),
            "mla_decode_paged_attention_full": 0, "grouped_matmul": 0}
    if windowed:
        info.update(decode_windows=len(k_steps), window_iterations=sum(k_steps),
                    windows_of_8=k_steps.count(8),
                    decode_ms_per_token_median=statistics.median(window_ms))
        if 8 not in k_steps:
            raise AssertionError(f"no decode window ran 8 iterations: {k_steps}")
        if eng.runner.flat:
            # Every step is one flat program or one decode window.
            if flat_steps == 0 or flat_steps + len(k_steps) != steps:
                raise AssertionError(f"{flat_steps} flat steps + {len(k_steps)} windows in {steps} steps")
        elif len(k_steps) != st.decode_dispatches_total:
            raise AssertionError(f"{len(k_steps)} windows, {st.decode_dispatches_total} decode dispatches")
    else:
        decode_ms = [ms for n, ms in step_log if n <= len(prompts)]
        info.update(
            decode_steps=len(decode_ms), decode_step_ms_median=statistics.median(decode_ms),
            prefill_steps=[[n, ms] for n, ms in step_log if n > len(prompts)],
        )
        if flat_steps != steps or k_steps:
            raise AssertionError(f"{flat_steps} flat steps, {len(k_steps)} windows in {steps} steps")
    if counts != want:
        raise AssertionError(f"launch counts {counts}, want {want}")
    del eng
    return counts


def layouts_phase(info: dict) -> None:
    """The tiny f32 model on the card: every step layout gives the flat
    step's streams, greedy and seeded (temperature 0.8)."""
    from llmd_tpu_torch.config import (
        CacheConfig, EngineConfig, SchedulerConfig, tiny_model_config,
    )
    from llmd_tpu_torch.engine import LLMEngine, SamplingParams
    from llmd_tpu_torch.models import llama

    model = tiny_model_config(head_dim=64, num_layers=3)
    params = llama.init_params(model, torch.Generator(device="cuda").manual_seed(1), "cuda")
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, 256, (n,), generator=gen).tolist() for n in (5, 40, 17, 70)]
    samplings = {
        "greedy": SamplingParams(temperature=0.0, max_tokens=20, ignore_eos=True),
        "seeded": SamplingParams(temperature=0.8, max_tokens=20, ignore_eos=True, seed=7),
    }
    layouts = {
        "flat": {},
        "split_window": dict(unified_step=False, decode_window=8),
        "flat_window": dict(decode_window=8),
        "bucketed": dict(ragged_qlens=False),
    }
    streams = {}
    for name, layout in layouts.items():
        config = EngineConfig(
            model=model,
            cache=CacheConfig(page_size=8, num_blocks=64, dtype="float32"),
            scheduler=SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=32, **layout),
        )
        eng = LLMEngine(config, params=params, device="cuda")
        streams[name] = {
            kind: list(eng.generate(prompts, sp).values()) for kind, sp in samplings.items()
        }
        info[name] = {"steps": eng.stats.engine_steps_total,
                      "unified_steps": eng.stats.unified_steps_total,
                      "decode_dispatches": eng.stats.decode_dispatches_total}
    for name in layouts:
        for kind in samplings:
            if streams[name][kind] != streams["flat"][kind]:
                raise AssertionError(f"{kind} streams of the {name} engine differ from the flat engine's")
    if streams["flat"]["greedy"] == streams["flat"]["seeded"]:
        raise AssertionError("the seeded noise never changed a token")
    info["streams_equal"] = True


def _post(url: str, body: dict) -> tuple[int, bytes]:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read()


def serve_phase(info: dict, layout_args: list[str], model: str = MODEL) -> None:
    """Start the server for ``model`` (with ``layout_args`` appended to its
    command line) and complete a few requests. Every server streams one
    completion and must deliver one chunk per token and the text of the
    same completion unstreamed; a server in its default layout also
    answers two plain requests, one with a 600-token prompt."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    log_path = os.path.join(REPO, "build", "chip_smoke_serve.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "llmd_tpu_torch.serve", "--model", model,
             "--host", "127.0.0.1", "--port", str(port), *layout_args],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
        )
        try:
            t0 = time.perf_counter()
            while True:
                if proc.poll() is not None:
                    raise RuntimeError(f"server exited with {proc.returncode}; see {log_path}")
                try:
                    with urllib.request.urlopen(base + "/health", timeout=5) as r:
                        if r.status == 200:
                            break
                except OSError:
                    pass
                if time.perf_counter() - t0 > 600:
                    raise TimeoutError("server did not become healthy in 600 s")
                time.sleep(1.0)
            info["startup_s"] = time.perf_counter() - t0
            usages = []
            bodies = [{"prompt": "Stream this.", "max_tokens": 16}]
            if not layout_args:
                bodies += [
                    {"prompt": f"The port serves {model}.", "max_tokens": 16},
                    {"prompt": [3 + i % 250 for i in range(600)], "max_tokens": 16},
                ]
            for body in bodies:
                status, raw = _post(base + "/v1/completions",
                                    {**body, "temperature": 0.0, "ignore_eos": True})
                if status != 200:
                    raise AssertionError(f"/v1/completions returned {status}")
                reply = json.loads(raw)
                usages.append(reply["usage"]["completion_tokens"])
                if body is bodies[0]:
                    unstreamed = reply["choices"][0]["text"]
            status, raw = _post(base + "/v1/completions", {
                **bodies[0], "temperature": 0.0, "ignore_eos": True, "stream": True,
            })
            frames = [
                json.loads(line[6:]) for line in raw.decode().splitlines()
                if line.startswith("data: {")
            ]
            if status != 200 or "usage" not in frames[-1]:
                raise AssertionError(f"streamed completion failed: {status}")
            usages.append(frames[-1]["usage"]["completion_tokens"])
            info["completion_tokens"] = usages
            info["stream_chunks"] = len(frames) - 1
            if set(usages) != {16}:
                raise AssertionError(f"completion_tokens {usages}, want 16 each")
            # One chunk per token, then the final frame; in order, the
            # chunks spell the unstreamed completion (the 12-token prompt
            # fills no page, so the repeat starts from no cached prefix and
            # runs the same steps).
            if len(frames) - 1 != 16:
                raise AssertionError(f"{len(frames) - 1} token chunks for 16 tokens")
            streamed = "".join(f["choices"][0]["text"] for f in frames)
            if streamed != unstreamed:
                raise AssertionError("the streamed text differs from the unstreamed completion's")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

DS_MODEL = "deepseek-v2-lite"


def routed_group_sizes(tokens: int, experts: int, k: int, gen) -> torch.Tensor:
    """Group sizes of ``tokens`` tokens each routed to ``k`` distinct
    experts drawn uniformly: what a router with random weights gives."""
    ids = torch.rand((tokens, experts), generator=gen).argsort(dim=1)[:, :k]
    return torch.bincount(ids.reshape(-1), minlength=experts).to(torch.int32)


def _grouped_library_ms(x, w, gs) -> tuple[float, str]:
    """Time of one PyTorch call computing the grouped product:
    ``torch._grouped_mm`` where this torch has it and takes these inputs,
    else a host loop of per-expert ``torch.matmul`` (offsets read back
    before timing). Returns (ms, which call)."""
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    if hasattr(torch, "_grouped_mm"):
        try:
            torch._grouped_mm(x, w, offs=offs)
            torch.cuda.synchronize()
            return cuda_ms(lambda: torch._grouped_mm(x, w, offs=offs)), "torch._grouped_mm"
        except (RuntimeError, TypeError) as e:
            print(f"torch._grouped_mm refused these inputs: {str(e)[:120]}", file=sys.stderr)
    ends = [0] + offs.tolist()
    out = torch.empty((x.shape[0], w.shape[2]), dtype=x.dtype, device=x.device)

    def loop():
        for g in range(w.shape[0]):
            if ends[g + 1] > ends[g]:
                torch.matmul(x[ends[g] : ends[g + 1]], w[g], out=out[ends[g] : ends[g + 1]])

    return cuda_ms(loop), "per-expert torch.matmul loop"


def moe_mla_kernels_phase(info: dict) -> dict:
    """K6' at deepseek-v2-lite's expert shapes (a 48-row decode step and a
    1024-token prefill step, the gate and the down call) and at
    qwen3-30b-a3b's (one layer's 128 experts, top-8, decode step); K5' on
    one decode step of the batch bucket 64 (48 live rows at 1k-4k context,
    16 pad rows) over a 27-layer latent pool. Each is held to its plain
    version within one bf16 ulp and timed beside its bound, the plain
    version and one library call."""
    import torch.nn.functional as F

    from llmd_tpu_torch import ops
    from llmd_tpu_torch.models.registry import get_model_config

    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(2024)
    g = torch.Generator(device=dev).manual_seed(31)
    ds, qw = get_model_config(DS_MODEL), get_model_config("qwen3-30b-a3b")
    H, Fm = ds.hidden_size, ds.moe_intermediate_size
    cases = {
        # name: (tokens, experts, top-k, K, N)
        "deepseek-v2-lite decode 48 rows, gate": (48, ds.num_experts, ds.num_experts_per_tok, H, Fm),
        "deepseek-v2-lite decode 48 rows, down": (48, ds.num_experts, ds.num_experts_per_tok, Fm, H),
        "deepseek-v2-lite prefill 1024 tokens, gate": (1024, ds.num_experts, ds.num_experts_per_tok, H, Fm),
        "deepseek-v2-lite prefill 1024 tokens, down": (1024, ds.num_experts, ds.num_experts_per_tok, Fm, H),
        "qwen3-30b-a3b decode 48 rows, gate": (
            48, qw.num_experts, qw.num_experts_per_tok, qw.hidden_size, qw.moe_intermediate_size),
    }
    gemm = {}
    for name, (T, E, k, K, N) in cases.items():
        gs = routed_group_sizes(T, E, k, gen).to(dev)
        M = T * k
        x = torch.randn((M, K), generator=g, device=dev, dtype=dt)
        w = torch.randn((E, K, N), generator=g, device=dev, dtype=dt).mul_(K**-0.5)
        got = ops.grouped_matmul(x, w, gs)
        want = ops.grouped_matmul_plain(x, w, gs)
        torch.cuda.synchronize()
        err, bad = outside_one_ulp(got, want)
        if bad:
            raise AssertionError(f"grouped_gemm {name}: max abs err {err} vs plain")
        live = int((gs > 0).sum().item())
        # Bound: x read, the routed experts' weights read once, out written;
        # 2 flops per multiply-add of the routed rows.
        nbytes = (M * K + live * K * N + M * N) * x.element_size() + 4 * E
        b_ms, b_by = bound(nbytes, 2.0 * M * K * N)
        lib_ms, lib = _grouped_library_ms(x, w, gs)
        gemm[name] = {
            "M": M, "experts": E, "live_experts": live, "K": K, "N": N,
            "max_abs_err": err,
            "ms": cuda_ms(lambda: ops.grouped_matmul(x, w, gs)),
            "plain_ms": cuda_ms(lambda: ops.grouped_matmul_plain(x, w, gs), reps=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "library_call": lib,
        }
        del x, w, got, want
        torch.cuda.empty_cache()
    info["grouped_gemm"] = gemm

    # --- K5': latent decode attention over a 27-layer latent pool.
    L, Hq, Dl, rank, page = ds.num_layers, ds.num_heads, ds.kv_cache_entry_dim, ds.kv_lora_rank, 16
    d = decode_batch(ds, page, 1024, 4096, gen, dev)
    B, n_live, ctx = d["B"], d["n_live"], d["ctx"]
    pool = torch.randn((L, d["num_pages"], 1, page, Dl), generator=g, device=dev, dtype=dt)
    q = torch.randn((B, 1, Hq, Dl), generator=g, device=dev, dtype=dt)
    scale = (ds.qk_nope_head_dim + ds.qk_rope_head_dim) ** -0.5
    layer = L // 2
    aargs = (q, pool, layer, d["page_table"], d["kv_lens"], rank, scale)
    got = ops.mla_decode_paged_attention_full(*aargs)
    want = ops.mla_decode_paged_attention_plain(*aargs, live_pages=d["live_pages"])
    torch.cuda.synchronize()
    err, bad = outside_one_ulp(got, want)
    if bad:
        raise AssertionError(f"mla_decode_attention: max abs err {err} vs plain")
    if got[n_live:].any():
        raise AssertionError("mla_decode_attention: a pad row is not zero")
    del want
    es = pool.element_size()
    # Bound: each live row's latent rows read once, q read, out written;
    # operations: scores over Dl and values over rank, per head and position.
    nbytes = (sum(ctx) * Dl + B * Hq * Dl + B * Hq * rank) * es
    b_ms, b_by = bound(nbytes, 2.0 * Hq * (Dl + rank) * sum(ctx))
    # Library yardstick: SDPA on each row's live latent rows gathered to a
    # dense, padded [B, 1, S, Dl] key (the one latent head shared by every
    # query head) and its rank slice as the value; the gather is not timed.
    smax = max(ctx)
    keys = torch.zeros((n_live, 1, smax, Dl), dtype=dt, device=dev)
    for r, n in enumerate(ctx):
        pages = d["page_table"][r, : -(-n // page)].long()
        keys[r, 0, :n] = pool[layer, pages].reshape(-1, Dl)[:n]
    mask = (torch.arange(smax, device=dev)[None, :] < d["kv_lens"][:n_live, None])[:, None, None, :]
    qd = q[:n_live].transpose(1, 2)  # [n, H, 1, Dl]
    vals = keys[..., :rank]
    try:
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, keys, vals, attn_mask=mask, scale=scale, enable_gqa=True))
        lib = "scaled_dot_product_attention (enable_gqa)"
    except (RuntimeError, TypeError):
        kx, vx = keys.expand(-1, Hq, -1, -1), vals.expand(-1, Hq, -1, -1)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qd, kx, vx, attn_mask=mask, scale=scale))
        lib = "scaled_dot_product_attention (heads expanded)"
    latent = {
        "batch": B, "live_rows": n_live, "context_tokens": sum(ctx), "layers": L,
        "pool_gib": pool.numel() * es / 2**30, "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.mla_decode_paged_attention_full(*aargs)),
        "plain_ms": cuda_ms(
            lambda: ops.mla_decode_paged_attention_plain(*aargs, live_pages=d["live_pages"]), reps=10),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "library_call": lib,
    }
    info["mla_decode_attention"] = latent
    del pool, keys
    torch.cuda.empty_cache()
    row = gemm["deepseek-v2-lite decode 48 rows, gate"]
    keys_ = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "grouped_gemm": {
            "name": "grouped_gemm", "route": "cuda",
            "source": "llmd_tpu_torch/ops/csrc/grouped_gemm.cu",
            "replaces": "llmd_tpu/ops/grouped_gemm.py:43",
            **{k: row[k] for k in keys_},
        },
        "mla_decode_attention": {
            "name": "mla_decode_attention", "route": "cuda",
            "source": "llmd_tpu_torch/ops/csrc/mla_decode_attention.cu",
            "replaces": "llmd_tpu/ops/mla_decode.py:143",
            **{k: latent[k] for k in keys_},
        },
    }


def bucketed_rows(cfg, page, rows, gen, dev) -> dict:
    """A bucketed [B, Q] prefill step of (start, width) rows, each row on
    its own physical pages (a random permutation of the pool)."""
    B, Q = len(rows), max(w for _, w in rows)
    need = [-(-(p0 + w) // page) for p0, w in rows]
    num_pages = sum(need) + 8
    perm = torch.randperm(num_pages, generator=gen).to(torch.int32)
    page_table = torch.zeros((B, -(-cfg.max_model_len // page)), dtype=torch.int32)
    tokens = torch.zeros((B, Q), dtype=torch.int64)
    positions = torch.zeros((B, Q), dtype=torch.int32)
    off = 0
    for r, ((p0, w), n) in enumerate(zip(rows, need)):
        page_table[r, :n] = perm[off : off + n]
        off += n
        tokens[r, :w] = torch.randint(0, cfg.vocab_size, (w,), generator=gen)
        positions[r, :w] = torch.arange(p0, p0 + w)
        positions[r, w:] = p0 + w - 1
    qlens = torch.tensor([w for _, w in rows], dtype=torch.int32)
    kv_lens = torch.tensor([p0 + w for p0, w in rows], dtype=torch.int32)
    return {
        "tokens": tokens.to(dev), "positions": positions.to(dev), "query_lens": qlens.to(dev),
        "kv_lens": kv_lens.to(dev), "page_table": page_table.to(dev),
        "num_pages": num_pages, "live_pages": max(need),
        "live": (torch.arange(Q)[None, :] < qlens[:, None]).reshape(-1).to(dev),
    }


def cut_layers(params: dict, n: int, dtype) -> dict:
    """The first ``n`` layers of a model (its dense prefix first), cast to
    ``dtype``: the f32 reference of a model too large to upcast whole."""
    out = {k: v.to(dtype) for k, v in params.items() if not isinstance(v, dict)}
    dense = params.get("dense_layers", {})
    n_dense = next(iter(dense.values())).shape[0] if dense else 0
    if dense:
        out["dense_layers"] = {k: v[: min(n, n_dense)].to(dtype) for k, v in dense.items()}
    out["layers"] = {k: v[: n - n_dense].to(dtype) for k, v in params["layers"].items()}
    return out


def ds_forward_phase(info: dict, params: dict) -> None:
    """deepseek-v2-lite at full width: one bucketed prefill forward (Q > 1:
    plain latent attention, K6' in every MoE layer) and one Q = 1 decode
    forward (K4', K5' and K6') of the 27-layer model, through the kernels
    and through the plain versions. An f32 copy of 27 layers (63 GB) does
    not fit beside the bf16 weights, so the f32 reference runs the first 4
    layers (the dense layer and 3 MoE layers) at full width."""
    import dataclasses

    from llmd_tpu_torch import ops
    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.common import StepInput
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(DS_MODEL)
    dev, page, L = torch.device("cuda"), 16, cfg.num_layers
    n_moe = L - cfg.first_dense_layers
    gen = torch.Generator().manual_seed(17)
    g = torch.Generator(device=dev).manual_seed(19)
    p = bucketed_rows(cfg, page, [(0, 256), (512, 200), (0, 128), (1000, 40)], gen, dev)
    prefill = StepInput(token_ids=p["tokens"], positions=p["positions"], kv_lens=p["kv_lens"],
                        page_table=p["page_table"], query_lens=p["query_lens"],
                        live_pages=p["live_pages"])
    d = decode_batch(cfg, page, 128, 640, gen, dev)
    ids = torch.randint(0, cfg.vocab_size, (d["B"], 1), generator=g, device=dev)
    decode = StepInput(token_ids=torch.where(d["valid"][:, None] > 0, ids, 0),
                       positions=d["positions"], kv_lens=d["kv_lens"],
                       page_table=d["page_table"], query_lens=d["valid"])
    steps = {
        # name: (input, pool pages, live slots of the hidden state, launches
        # per forward by wrapper, plain gather bound)
        "prefill": (prefill, p["num_pages"], p["live"],
                    {"grouped_matmul": 3 * n_moe}, p["live_pages"]),
        "decode": (decode, d["num_pages"], torch.arange(d["B"], device=dev) < d["n_live"],
                   {"grouped_matmul": 3 * n_moe, "write_kv_pages_decode_full": L,
                    "mla_decode_paged_attention_full": L}, d["live_pages"]),
    }
    cut = 4
    cfg4 = dataclasses.replace(cfg, num_layers=cut)
    params4 = cut_layers(params, cut, torch.bfloat16)
    params4_32 = cut_layers(params, cut, torch.float32)

    def rel(a: torch.Tensor, b: torch.Tensor) -> float:
        return ((a - b).norm() / b.norm()).item()

    for name, (inp, num_pages, live, per_forward, live_pages) in steps.items():
        shape = (L, num_pages, 1, page, cfg.kv_cache_entry_dim)
        pool = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)

        def run(prm, c, work, plain):
            ctx = plain_ops(live_pages) if plain else contextlib.nullcontext()
            with torch.inference_mode(), ctx:
                h, _ = llama.forward_hidden(prm, work, inp, c)
            return h.reshape(-1, h.shape[-1])[live].float()

        ops.reset_launch_counts()
        h_k = run(params, cfg, pool.clone(), plain=False)
        counts = ops.launch_counts()
        h_p = run(params, cfg, pool.clone(), plain=True)
        want = {fn: per_forward.get(fn, 0) for fn in counts}
        if counts != want:
            raise AssertionError(f"{name} forward launched {counts}, want {want}")
        h4_k = run(params4, cfg4, pool[:cut].clone(), plain=False)
        h4_p = run(params4, cfg4, pool[:cut].clone(), plain=True)
        h4_k32 = run(params4_32, cfg4, pool[:cut].float(), plain=False)
        h4_ref = run(params4_32, cfg4, pool[:cut].float(), plain=True)
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: llama.forward_hidden(params, pool, inp, cfg), reps=3, warmup=1)
            with plain_ops(live_pages):
                fwd_plain_ms = cuda_ms(
                    lambda: llama.forward_hidden(params, pool, inp, cfg), reps=1, warmup=1)
        torch.cuda.synchronize()
        r = {
            "rows": inp.token_ids.shape[0], "Q": inp.token_ids.shape[1],
            "live_tokens": int(live.sum().item()), "layers": L, "launches": counts,
            "bf16_rel_err_27_layers": rel(h_k, h_p),
            "f32_rel_err_4_layers": rel(h4_k32, h4_ref),
            "bf16_kernels_vs_f32_4_layers": rel(h4_k, h4_ref),
            "bf16_plain_vs_f32_4_layers": rel(h4_p, h4_ref),
            "step_ms": fwd_ms, "step_plain_ms": fwd_plain_ms,
        }
        info[name] = r
        if not all(torch.isfinite(h).all() for h in (h_k, h_p, h4_k, h4_p, h4_k32, h4_ref)):
            raise AssertionError(f"deepseek {name} forward: non-finite hidden states")
        # f32: the paths differ in summation order only (attention, the
        # expert products, the combine), about 1e-6 relative per layer.
        if r["f32_rel_err_4_layers"] > 1e-3:
            raise AssertionError(f"deepseek {name} forward: f32 relative error {r['f32_rel_err_4_layers']}")
        # bf16: the kernels' run may be no further from the f32 run than 1.5
        # times the plain run's distance (a one-ulp difference grows through
        # the layers, so the two bf16 runs are not held to each other).
        if r["bf16_kernels_vs_f32_4_layers"] > 1.5 * r["bf16_plain_vs_f32_4_layers"]:
            raise AssertionError(
                f"deepseek {name} forward: bf16 kernels {r['bf16_kernels_vs_f32_4_layers']} from f32, "
                f"plain {r['bf16_plain_vs_f32_4_layers']} (limit 1.5x)")
        del pool, h_k, h_p, h4_k, h4_p, h4_k32, h4_ref
        torch.cuda.empty_cache()
    del params4, params4_32
    torch.cuda.empty_cache()


DS_LAYOUTS = {
    "default (bucketed unified step)": {},
    "split engine, decode_window 8": dict(unified_step=False, decode_window=8),
}


def ds_engine_phase(info: dict, params: dict) -> dict:
    """``LLMEngine`` serving deepseek-v2-lite (8 greedy requests, chunked
    prefill and a prefix-cache hit) in the layout ``info["layout"]`` names.
    MLA has no flat step, so the default engine runs the bucketed unified
    step. Every forward is logged with its Q: K6' must launch 3 x 26 times
    a forward, K4' and K5' 27 times a Q = 1 forward (each window iteration
    is one), the GQA kernels never. Each step reads back once, and every
    decode-window dispatch runs under ``torch.cuda.set_sync_debug_mode
    ("error")``, so a hidden device sync fails the run. Returns the launch
    counts."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from llmd_tpu_torch.engine import LLMEngine, SamplingParams
    from llmd_tpu_torch.engine import runner as runner_mod
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(DS_MODEL)
    layout = DS_LAYOUTS[info["layout"]]
    config = EngineConfig(
        model=cfg,
        cache=CacheConfig(page_size=16, num_blocks=2048, dtype="bfloat16"),
        scheduler=SchedulerConfig(max_num_seqs=64, max_num_batched_tokens=1024, **layout),
        seed=0,
    )
    eng = LLMEngine(config, params=params, device="cuda")
    if eng.runner.flat:
        raise AssertionError("an MLA engine took the flat step")
    forwards: list[int] = []  # Q of every forward
    k_steps: list[int] = []
    forward = runner_mod.llama.forward_hidden
    dispatch = eng.runner.dispatch_staged_decode

    def logged_forward(params, kv_cache, inp, c):
        forwards.append(inp.token_ids.shape[1])
        return forward(params, kv_cache, inp, c)

    def strict_dispatch(staged):
        k_steps.append(staged.k)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(staged)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    runner_mod.llama.forward_hidden = logged_forward
    eng.runner.dispatch_staged_decode = strict_dispatch
    gen = torch.Generator().manual_seed(11)
    lengths = [16, 100, 300, 700, 1500, 64, 900]
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist() for n in lengths]
    sp = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True)
    tokens: dict[str, list[int]] = {}
    ttft: dict[str, float] = {}
    last: dict[str, float] = {}
    cached: dict[str, int] = {}
    window_ms: list[float] = []  # host ms per token of each step that is one decode window
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with counting_readbacks() as readbacks:
            for wave in (prompts, [prompts[3]]):
                tw = time.perf_counter()
                for p in wave:
                    tokens[eng.add_request(p, sp)] = []
                while eng.has_work():
                    ts, windows0 = time.perf_counter(), len(k_steps)
                    dispatches0 = eng.stats.step_dispatches_total
                    for out in eng.step():
                        tokens[out.request_id] += out.new_token_ids
                        ttft.setdefault(out.request_id, time.perf_counter() - tw)
                        last[out.request_id] = time.perf_counter() - tw
                        cached[out.request_id] = out.num_cached_tokens
                    if len(k_steps) > windows0 and eng.stats.step_dispatches_total == dispatches0 + 1:
                        window_ms.append((time.perf_counter() - ts) * 1e3 / k_steps[-1])
        torch.cuda.synchronize()
    finally:
        runner_mod.llama.forward_hidden = forward
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = eng.stats
    rids = list(tokens)
    tpot = [(last[r] - ttft[r]) / (len(tokens[r]) - 1) for r in rids]
    decode_forwards = forwards.count(1)
    info.update(
        requests=len(rids), steps=st.engine_steps_total, wall_s=wall,
        output_tok_per_s=sum(len(t) for t in tokens.values()) / wall,
        ttft_median_s=statistics.median(ttft.values()), ttft_max_s=max(ttft.values()),
        tpot_median_ms=statistics.median(tpot) * 1e3,
        prefix_cached_tokens=cached[rids[-1]],
        step_dispatches=st.step_dispatches_total, decode_dispatches=st.decode_dispatches_total,
        unified_steps=st.unified_steps_total, readbacks=len(readbacks),
        forwards=len(forwards), q1_forwards=decode_forwards, decode_windows=len(k_steps),
        window_iterations=sum(k_steps), decode_ms_per_token_median=statistics.median(window_ms),
        launches=counts,
    )
    if any(len(t) != 32 for t in tokens.values()):
        raise AssertionError(f"not every request produced 32 tokens: {[len(t) for t in tokens.values()]}")
    if cached[rids[-1]] <= 0:
        raise AssertionError("the repeated prompt did not hit the prefix cache")
    if len(readbacks) != st.engine_steps_total:
        raise AssertionError(f"{len(readbacks)} device->host copies in {st.engine_steps_total} steps")
    L, n_moe = cfg.num_layers, cfg.num_layers - cfg.first_dense_layers
    want = {"write_kv_pages_flat_full": 0, "flat_paged_attention_full": 0,
            "write_kv_pages_decode_full": L * decode_forwards,
            "decode_paged_attention_full": 0,
            "mla_decode_paged_attention_full": L * decode_forwards,
            "grouped_matmul": 3 * n_moe * len(forwards)}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, want {want}")
    if "decode_window" in layout and 8 not in k_steps:
        raise AssertionError(f"no decode window ran 8 iterations: {k_steps}")
    if not layout and st.unified_steps_total == 0:
        raise AssertionError("the default MLA engine ran no bucketed unified step")
    del eng
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from llmd_tpu_torch.ops import _build
    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.registry import get_model_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    with phase("device", {"kind": kind, "count": torch.cuda.device_count()}) as info:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
        info["nvidia_smi"] = smi
        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
    print(smi, flush=True)
    with phase("build", {}) as info:
        info["built"] = _build.build_all()
    with phase("kernels", {}) as info:
        table = kernels_phase(info)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("decode_kernels", {}) as info:
        table.update(decode_kernels_phase(info))
    gc.collect()
    torch.cuda.empty_cache()
    with phase("forward", {}) as info:
        cfg = get_model_config(MODEL)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = llama.fuse_projections(llama.init_params(cfg, gen, "cuda"))
        forward_phase(info, params)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("engine", {"layout": "flat step"}) as info:
        flat_counts = engine_phase(info, params)
    with phase("engine", {"layout": "split engine, decode_window 8"}) as info:
        window_counts = engine_phase(info, params)
    with phase("engine", {"layout": "flat step, decode_window 8"}) as info:
        engine_phase(info, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with phase("layouts", {}) as info:
        layouts_phase(info)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("moe_mla_kernels", {}) as info:
        table.update(moe_mla_kernels_phase(info))
    gc.collect()
    torch.cuda.empty_cache()
    with phase("forward", {"model": DS_MODEL}) as info:
        ds_cfg = get_model_config(DS_MODEL)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = llama.init_params(ds_cfg, gen, "cuda")
        ds_forward_phase(info, params)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("engine", {"model": DS_MODEL, "layout": "default (bucketed unified step)"}) as info:
        ds_counts = ds_engine_phase(info, params)
    with phase("engine", {"model": DS_MODEL, "layout": "split engine, decode_window 8"}) as info:
        ds_engine_phase(info, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with phase("serve", {"layout": "flat step"}) as info:
        serve_phase(info, [])
    with phase("serve", {"layout": "split engine, decode_window 4"}) as info:
        serve_phase(info, ["--no-unified-step", "--decode-window", "4"])
    with phase("serve", {"model": DS_MODEL, "layout": "default (bucketed unified step)"}) as info:
        serve_phase(info, [], DS_MODEL)
    # Each kernel's launches come from the engine run that is its main path.
    emit({"kernels": [
        {**table[name], "launches": counts[fn]}
        for name, fn, counts in (
            ("flat_kv_write", "write_kv_pages_flat_full", flat_counts),
            ("flat_paged_attention", "flat_paged_attention_full", flat_counts),
            ("decode_kv_write", "write_kv_pages_decode_full", window_counts),
            ("decode_paged_attention", "decode_paged_attention_full", window_counts),
            ("mla_decode_attention", "mla_decode_paged_attention_full", ds_counts),
            ("grouped_gemm", "grouped_matmul", ds_counts),
        )
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
