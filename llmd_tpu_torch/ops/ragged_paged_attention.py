"""Paged attention kernels for one-token queries: the flat step's and decode's.

``flat_paged_attention_full`` launches the CUDA kernel
``csrc/flat_paged_attention.cu``, which replaces the TPU kernel
``llmd_tpu/ops/ragged_paged_attention.py:_decode_kernel`` in its
row-lookup form (entry ``flat_paged_attention_full``). Each packed token t
attends with its H query heads over positions ``[win_start, kv_lens[t])``
of row ``rows[t]``'s pages (``kv_len = position + 1`` is the causal mask
within a row; ``win_start = max(kv_len - window, 0)`` on a sliding layer,
else 0), G = H / K query heads per KV head, online softmax in f32.

``decode_paged_attention_full`` (and ``decode_paged_attention`` on a
single-layer pool) launches ``csrc/decode_paged_attention.cu``, which
replaces the same TPU kernel without row lookup (``_decode_call``): row b of
the decode batch attends with its one query token over positions
``[win_start, kv_lens[b])`` of its own table row; a pad row (``kv_len`` 0)
gets zeros. Both kernels share their device code
(``csrc/paged_attention.cuh``), as the TPU entries share ``_decode_kernel``,
with all of its branches: the sliding ``window``, the per-head attention
``sinks`` (one key without a value) and the int8 pool (``scales``,
``ops/quant_kv.py``), each as the TPU kernel computes it. Each wrapper
counts its launches, and per combination of branches taken
(``branch_launches``, keyed by ``branch_key``).

In bf16/f16 a block attends a query tile (up to ``tile_tokens(G)``
consecutive tokens of one row, ``flat_work_items``; a decode row is a tile
of one) over a span of the row's live pages on the tensor cores; the
wrappers pick the span count (``spans_for``) from sizes the host knows and
allocate the merge's f32 scratch. ``span_pages``, ``span_partials_plain``
and ``merge_spans_plain`` are that decomposition in plain PyTorch, for the
tests. f32 runs a per-warp kernel on the CUDA cores with no spans. The
kernel sources say what bounds each kernel and what the design does.

``flat_paged_attention_plain`` and ``decode_paged_attention_plain`` are the
plain PyTorch versions: they gather each row's live context once and run a
masked softmax over it in f32, the sinks as one extra value-less key, an
int8 pool's scales folded as the kernel folds them. The wrappers take them
for CPU tensors only.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from llmd_tpu_torch.ops import _build
from llmd_tpu_torch.ops.mla_decode import _sm_count

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128, 256)
_MAX_PAGE = 32
# A query tile holds at most this many (token, head) rows: Tq = 64 // G.
_TILE_ROWS = 64
# Spans per row: enough blocks for about this many per SM, at most _MAX_SPANS,
# and no span shorter than _MIN_SPAN_PAGES pages of the longest live run.
_BLOCKS_PER_SM, _MAX_SPANS, _MIN_SPAN_PAGES = 4, 16, 16
_lib = None
_decode_lib = None


def _decode_kernel():
    global _decode_lib
    if _decode_lib is None:
        lib = _build.load("decode_paged_attention")
        lib.decode_paged_attention.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.decode_paged_attention.restype = ctypes.c_int
        _decode_lib = lib
    return _decode_lib.decode_paged_attention


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("flat_paged_attention")
        lib.flat_paged_attention.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 13
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.flat_paged_attention.restype = ctypes.c_int
        _lib = lib
    return _lib.flat_paged_attention


def tile_tokens(group: int) -> int:
    """Tq: the tokens of one query tile, so that Tq * G rows fill about one
    64-row tile (16 for G = 4, 8 for G = 8)."""
    return max(1, _TILE_ROWS // group)


def flat_grid(num_tokens: int, num_rows: int, group: int) -> int:
    """Blocks along the flat kernel's tile axis: the most tiles a step of
    ``num_tokens`` tokens over ``num_rows`` table rows can have when each
    row's tokens are contiguous (each row adds at most one partial tile).
    Host sizes only; with rows that are not contiguous a block walks more
    than one tile."""
    return max(1, min(num_tokens, -(-num_tokens // tile_tokens(group)) + num_rows))


def spans_for(blocks: int, live_pages: int, sm_count: int) -> int:
    """How many spans a row's pages are cut into: enough blocks for about
    ``_BLOCKS_PER_SM`` per SM over ``blocks`` (tiles x KV heads), at most
    ``_MAX_SPANS``, and none shorter than ``_MIN_SPAN_PAGES`` of the
    ``live_pages`` a row can attend (``live_pages_bound``)."""
    return max(1, min(_MAX_SPANS, -(-live_pages // _MIN_SPAN_PAGES),
                      -(-_BLOCKS_PER_SM * sm_count // max(blocks, 1))))


def live_pages_bound(max_pages: int, page: int, window: int) -> int:
    """The most pages one query attends, from host sizes: the table's
    width, or a sliding window's pages."""
    return max_pages if window <= 0 else min(max_pages, window // page + 2)


def flat_work_items(token_rows: torch.Tensor, kv_lens: torch.Tensor, group: int) -> torch.Tensor:
    """The flat kernel's query tiles, ``[T, 2]`` int32 (first token, tokens),
    compacted (entries past the last tile hold 0 tokens). A run of live
    tokens of one row is cut into tiles of ``tile_tokens(group)`` from its
    first token; pads (kv_len 0) are in no tile. Built on the tensors'
    device with nothing read back, once per step: every layer uses it."""
    T = token_rows.shape[0]
    dev = token_rows.device
    t = torch.arange(T, device=dev)
    live = kv_lens > 0
    rows = token_rows.long()
    prev_live = torch.cat([live.new_zeros(1), live[:-1]])
    prev_row = torch.cat([rows.new_full((1,), -1), rows[:-1]])
    run_start = torch.cummax(torch.where(live & (~prev_live | (rows != prev_row)), t, 0), 0).values
    starts = live & ((t - run_start) % tile_tokens(group) == 0)
    tile = torch.cumsum(starts, 0) - 1  # each live token's tile
    items = torch.zeros((T + 1, 2), dtype=torch.int32, device=dev)  # row T: a dump
    items[:, 0].scatter_(0, torch.where(starts, tile, T), t.int())
    items[:, 1].scatter_add_(0, torch.where(live, tile, T), torch.ones_like(t, dtype=torch.int32))
    return items[:T]


def span_pages(lo: int, hi: int, page: int, spans: int) -> list[tuple[int, int]]:
    """The kernels' cut of live positions ``[lo, hi)`` into ``spans``
    contiguous runs of whole pages: (first page, end page) per span, the
    trailing ones possibly empty."""
    pb, pe = lo // page, -(-hi // page)
    per = -(-(pe - pb) // spans)
    out = []
    for s in range(spans):
        b = min(pe, pb + s * per)
        out.append((b, min(pe, b + per)))
    return out


def span_partials_plain(q, kv_cache, layer, token_rows, page_table, kv_lens, items, spans,
                        sm_scale=None, window=0, scales=None):
    """The kernels' per-span work in plain PyTorch (f32): for each tile
    (``items``: first token, tokens) and span of the tile's live pages, each
    token's and head's softmax partial (m, l, acc) over the span's positions
    in its own ``[win_start, kv_len)``. Returns m, l ``[S, T, H]`` and acc
    ``[S, T, H, D]``; a token in no tile keeps m = -inf, l = 0, acc = 0."""
    T, _, H, D = q.shape
    _, _, K, page, _ = kv_cache.shape
    G = H // K
    if sm_scale is None:
        sm_scale = D**-0.5
    m = torch.full((spans, T, H), float("-inf"))
    l = torch.zeros((spans, T, H))
    acc = torch.zeros((spans, T, H, D))
    lens = kv_lens.tolist()
    starts = _window_starts(kv_lens, window).tolist()
    for t0, n in items.tolist():
        if n <= 0:
            break
        toks = range(t0, t0 + n)
        ranges = [(starts[t], lens[t]) for t in toks if lens[t] > starts[t]]
        lo = min((a for a, _ in ranges), default=0)
        hi = max((b for _, b in ranges), default=0)
        row = int(token_rows[t0])
        for s, (pb, pe) in enumerate(span_pages(lo, hi, page, spans)):
            if pe <= pb:
                continue
            pages = page_table[row, pb:pe].long()
            kv = kv_cache[layer, pages].permute(0, 2, 1, 3).reshape(-1, K, 2 * D).float()
            pos = torch.arange(pb * page, pe * page)
            if scales is not None:
                sc = scales[layer, pages].permute(0, 2, 1, 3).reshape(-1, K, 2).float()
            for t in toks:
                live = (pos >= starts[t]) & (pos < lens[t])  # [S]
                qf = q[t, 0].float().reshape(K, G, D)
                x = torch.einsum("kgd,skd->kgs", qf, torch.where(live[:, None, None], kv[..., :D], 0.0))
                x = x * sm_scale
                v = torch.where(live[:, None, None], kv[..., D:], 0.0)
                if scales is not None:
                    x = x * torch.where(live[:, None], sc[..., 0], 0.0).t()[:, None, :]
                x = x.masked_fill(~live[None, None, :], float("-inf"))
                mt = x.amax(dim=-1)  # [K, G]
                p = torch.exp(x - torch.where(torch.isfinite(mt), mt, 0.0)[..., None])
                w = p
                if scales is not None:
                    w = p * torch.where(live[:, None], sc[..., 1], 0.0).t()[:, None, :]
                m[s, t] = mt.reshape(H)
                l[s, t] = p.sum(dim=-1).reshape(H)
                acc[s, t] = torch.einsum("kgs,skd->kgd", w, v).reshape(H, D)
    return m, l, acc


def merge_spans_plain(m, l, acc, kv_lens, sinks=None):
    """The kernels' merge in plain PyTorch: fold each token's span partials
    (``span_partials_plain``), add the sinks' value-less key and normalise;
    ``[T, 1, H, D]`` f32, pad tokens (kv_len 0) zero."""
    M = m.amax(dim=0)  # [T, H]
    w = torch.where(m == float("-inf"), 0.0, torch.exp(m - torch.where(torch.isfinite(M), M, 0.0)))
    L = (w * l).sum(dim=0)
    out = (w[..., None] * acc).sum(dim=0)
    if sinks is not None:
        sk = sinks.float()[None, :]
        m2 = torch.maximum(M, sk)
        alpha = torch.where(M == float("-inf"), 0.0, torch.exp(M - m2))
        L = L * alpha + torch.where(sk == float("-inf"), 0.0, torch.exp(sk - m2))
        out = out * alpha[..., None]
    out = out / torch.where(L == 0.0, 1.0, L)[..., None]
    return torch.where((kv_lens > 0)[:, None, None], out, 0.0)[:, None]


def _window_starts(kv_lens: torch.Tensor, window: int) -> torch.Tensor:
    """First attended position of each query (its kv_len - 1 is its own
    position): ``max(kv_len - window, 0)`` for a sliding window, else 0."""
    if window > 0:
        return (kv_lens.long() - window).clamp(min=0)
    return torch.zeros_like(kv_lens, dtype=torch.long)


def _softmax_rows(s, live, sinks2d):
    """Masked softmax numerators over the last axis of scores ``s`` [.., K,
    G, S] with ``live`` broadcast to it, and the denominator: the sum of
    the live numerators plus, with sinks ([K, G] f32), the sink's own
    ``exp(sink - m)`` (a key without a value). A row with no live key and
    no sink gets a zero numerator and denominator 1."""
    s = s.masked_fill(~live, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    if sinks2d is not None:
        m = torch.maximum(m, sinks2d[..., None])
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if sinks2d is not None:
        l = l + torch.exp(sinks2d[..., None] - m)
    return p, torch.where(l == 0.0, 1.0, l)


def flat_paged_attention_plain(
    q: torch.Tensor,  # [T, 1, H, D]
    kv_cache: torch.Tensor,  # [L, num_pages, K, page, 2D]
    layer: int,
    rows: torch.Tensor,  # [T] token -> row of page_table
    page_table: torch.Tensor,  # [R, max_pages]
    kv_lens: torch.Tensor,  # [T] position + 1 (0 for pads)
    sm_scale: float | None = None,
    window: int = 0,
    sinks: torch.Tensor | None = None,  # [H]
    scales: torch.Tensor | None = None,  # [L, num_pages, K, page, 2]
) -> torch.Tensor:
    """Plain PyTorch version: per row, gather the live context once and run
    a masked softmax for the row's tokens, all in f32. Tokens with
    ``kv_len == 0`` (pads) get zeros. A token attends positions
    ``[win_start, kv_len)``; sinks add one value-less key per head; an int8
    pool folds its scales as the kernel does: the score is
    ``(q . k_i8) * ks`` and the value weight ``p * vs``, zeroed off the live
    positions."""
    T, _, H, D = q.shape
    _, _, K, page, D2 = kv_cache.shape
    G = H // K
    if sm_scale is None:
        sm_scale = D**-0.5
    lens = kv_lens.tolist()
    starts = _window_starts(kv_lens, window)
    sinks2d = None if sinks is None else sinks.float().reshape(K, G)
    by_row: dict[int, list[int]] = {}
    for t, (r, n) in enumerate(zip(rows.tolist(), lens)):
        if n > 0:
            by_row.setdefault(r, []).append(t)
    qf = q[:, 0].float().reshape(T, K, G, D)
    out = torch.zeros(T, K, G, D, dtype=torch.float32, device=q.device)
    for r, toks in by_row.items():
        idx = torch.tensor(toks, device=q.device)
        n = max(lens[t] for t in toks)
        pages = page_table[r, : -(-n // page)].long()
        kv = kv_cache[layer, pages].permute(0, 2, 1, 3).reshape(-1, K, D2)[:n].float()
        s = torch.einsum("tkgd,skd->tkgs", qf[idx], kv[..., :D]) * sm_scale
        pos = torch.arange(n, device=q.device)[None, :]
        live = (pos < kv_lens[idx, None]) & (pos >= starts[idx, None])  # [t, n]
        live = live[:, None, None, :]
        if scales is not None:
            sc = scales[layer, pages].permute(0, 2, 1, 3).reshape(-1, K, 2)[:n].float()
            s = s * sc[:, :, 0].t()[None, :, None, :]
        p, l = _softmax_rows(s, live, sinks2d)
        if scales is not None:
            p = torch.where(live, p * sc[:, :, 1].t()[None, :, None, :], 0.0)
        out[idx] = torch.einsum("tkgs,skd->tkgd", p, kv[..., D:]) / l
    return out.reshape(T, 1, H, D).to(q.dtype)


def _check_common(q, kv_cache, layer, index_tensors, sinks, scales):
    """What both kernels require of q, the pool, the sinks, the int8
    pool's scales and their int32 index tensors (``index_tensors``: (name,
    tensor) pairs)."""
    T, Q, H, D = q.shape
    L, P, K, page, D2 = kv_cache.shape
    if Q != 1 or D2 != 2 * D or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not fit pool {tuple(kv_cache.shape)}")
    if D not in _HEAD_DIMS or H // K > 32 or page > _MAX_PAGE:
        raise ValueError(
            f"kernel takes head_dim in {_HEAD_DIMS}, <= 32 query heads per "
            f"KV head and page <= {_MAX_PAGE}; got D={D}, G={H // K}, page={page}"
        )
    # q is the working dtype; the pool holds it too, or int8 with scales.
    if q.dtype not in _DTYPE_CODES or kv_cache.dtype not in (q.dtype, torch.int8):
        raise ValueError(f"q {q.dtype} and pool {kv_cache.dtype}: the pool must hold "
                         "q's float dtype or int8")
    if (kv_cache.dtype == torch.int8) != (scales is not None):
        raise ValueError("an int8 pool needs its scales, and only an int8 pool takes them")
    if scales is not None and (
        scales.shape != (L, P, K, page, 2) or scales.dtype != torch.float32
    ):
        raise ValueError(f"scales must be f32 [L, P, K, page, 2], got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if sinks is not None and (sinks.shape != (H,) or sinks.dtype != torch.float32):
        raise ValueError(f"sinks must be f32 [H] = [{H}], got {sinks.dtype} {tuple(sinks.shape)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    extra = [(n, t) for n, t in (("sinks", sinks), ("scales", scales)) if t is not None]
    for name, t in (("q", q), ("kv_cache", kv_cache), *index_tensors, *extra):
        if t.device != kv_cache.device:
            raise ValueError(f"{name} is on {t.device}, the pool on {kv_cache.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in index_tensors:
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.data_ptr() % 16 or kv_cache.data_ptr() % 16:
        raise ValueError("q and the pool must be 16-byte aligned")
    if scales is not None and scales.data_ptr() % 8:
        raise ValueError("scales must be 8-byte aligned")


def _check(q, kv_cache, layer, rows, page_table, kv_lens, sinks, scales, items):
    T = q.shape[0]
    if rows.shape != (T,) or kv_lens.shape != (T,) or page_table.dim() != 2:
        raise ValueError("rows/kv_lens must be [T] and page_table [R, max_pages]")
    if items is not None and items.shape != (T, 2):
        raise ValueError(f"items must be [T, 2] = [{T}, 2] (flat_work_items), got {tuple(items.shape)}")
    index = (("rows", rows), ("page_table", page_table), ("kv_lens", kv_lens))
    if items is not None:
        index += (("items", items),)
    _check_common(q, kv_cache, layer, index, sinks, scales)


def _check_decode(q, kv_cache, layer, page_table, kv_lens, sinks, scales):
    B = q.shape[0]
    if kv_lens.shape != (B,) or page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError("kv_lens must be [B] and page_table [B, max_pages]")
    _check_common(q, kv_cache, layer, (
        ("page_table", page_table), ("kv_lens", kv_lens)), sinks, scales)


def branch_key(window: int, sinks, scales) -> str:
    """The kernel branches a launch takes, as ``"int8+window+sinks"``
    (each part only when taken), or ``"plain"``."""
    taken = [name for name, on in (("int8", scales is not None), ("window", window > 0),
                                   ("sinks", sinks is not None)) if on]
    return "+".join(taken) or "plain"


def _count(fn, window: int, sinks, scales) -> None:
    """One launch of ``fn``'s kernel, counted under the branches it took."""
    fn.launches += 1
    fn.branch_launches[branch_key(window, sinks, scales)] += 1


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _span_scratch(spans: int, T: int, H: int, D: int, device):
    """The merge's f32 scratch, (acc [S, T, H, D], (m, l) [S, T, H, 2]), or
    none for one span."""
    if spans == 1:
        return None, None
    return (torch.empty((spans, T, H, D), dtype=torch.float32, device=device),
            torch.empty((spans, T, H, 2), dtype=torch.float32, device=device))


def flat_paged_attention_full(
    q: torch.Tensor,
    kv_cache: torch.Tensor,
    layer: int,
    rows: torch.Tensor,
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,
    sm_scale: float | None = None,
    window: int = 0,
    sinks: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
    items: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention of the packed ``[T, 1, H, D]`` query stream over
    ``kv_cache[layer]``; returns ``[T, 1, H, D]`` in q's dtype. ``window``
    > 0 is the layer's sliding window, ``sinks`` ([H] f32) its attention
    sinks, ``scales`` the int8 pool's ``[L, P, K, page, 2]`` scales.
    ``items`` is the step's ``flat_work_items(rows, kv_lens, H // K)``,
    which a caller that attends many layers builds once; without it the
    wrapper builds it.

    CUDA tensors launch the kernel on the current stream; CPU tensors take
    the plain version."""
    if kv_cache.device.type == "cpu":
        return flat_paged_attention_plain(
            q, kv_cache, layer, rows, page_table, kv_lens, sm_scale, window,
            sinks, scales,
        )
    if kv_cache.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_cache.device}")
    _check(q, kv_cache, layer, rows, page_table, kv_lens, sinks, scales, items)
    T, _, H, D = q.shape
    L, P, K, page, _ = kv_cache.shape
    G = H // K
    out = torch.empty_like(q)
    if T == 0:
        return out
    grid_x, spans, part_acc, part_ml = 0, 1, None, None
    if q.dtype != torch.float32:  # the tensor-core kernel: tiles and spans
        if items is None:
            items = flat_work_items(rows, kv_lens, G)
        grid_x = flat_grid(T, page_table.shape[0], G)
        spans = spans_for(grid_x * K, live_pages_bound(page_table.shape[1], page, window),
                          _sm_count(q.device.index or 0))
        part_acc, part_ml = _span_scratch(spans, T, H, D, q.device)
    err = _kernel()(
        out.data_ptr(), _ptr(part_acc), _ptr(part_ml), q.data_ptr(),
        kv_cache.data_ptr(), _ptr(scales), _ptr(sinks),
        None if q.dtype == torch.float32 else items.data_ptr(), rows.data_ptr(),
        page_table.data_ptr(), kv_lens.data_ptr(), T, grid_x, spans, layer, P,
        K, page, page_table.shape[1], G, D, _DTYPE_CODES[q.dtype],
        int(scales is not None), max(int(window), 0),
        D**-0.5 if sm_scale is None else sm_scale,
        torch.cuda.current_stream(kv_cache.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flat_paged_attention launch failed: CUDA error {err}")
    _count(flat_paged_attention_full, window, sinks, scales)
    return out


flat_paged_attention_full.launches = 0
flat_paged_attention_full.branch_launches = collections.Counter()


def decode_paged_attention_plain(
    q: torch.Tensor,  # [B, 1, H, D]
    kv_cache: torch.Tensor,  # [L, num_pages, K, page, 2D]
    layer: int,
    page_table: torch.Tensor,  # [B, max_pages]
    kv_lens: torch.Tensor,  # [B] (0 for a pad row)
    sm_scale: float | None = None,
    live_pages: int | None = None,
    window: int = 0,
    sinks: torch.Tensor | None = None,  # [H]
    scales: torch.Tensor | None = None,  # [L, num_pages, K, page, 2]
) -> torch.Tensor:
    """Plain PyTorch version: gather every row's pages once and run a
    masked softmax over positions ``[win_start, kv_len)`` in f32, with the
    sinks as value-less keys and an int8 pool's scales folded as in
    ``flat_paged_attention_plain``. Pad rows get zeros. Positions off the
    live range are masked out of the scores and zeroed in the values, so
    uninitialised pool memory never enters a sum. It reads nothing back to
    the host; ``live_pages`` (the batch's largest live page count, where
    the caller knows it on the host) bounds the gather, which otherwise
    spans the table's width."""
    B, _, H, D = q.shape
    _, _, K, page, D2 = kv_cache.shape
    G = H // K
    if sm_scale is None:
        sm_scale = D**-0.5
    pages = page_table[:, :live_pages].long()
    S = pages.shape[1] * page
    kv = kv_cache[layer][pages]  # [B, n, K, page, 2D]
    kv = kv.permute(0, 1, 3, 2, 4).reshape(B, S, K, D2).float()
    pos = torch.arange(S, device=q.device)[None, :]
    live = (pos < kv_lens[:, None]) & (pos >= _window_starts(kv_lens, window)[:, None])
    qf = q[:, 0].float().reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qf, kv[..., :D]) * sm_scale
    mask = live[:, None, None, :]
    if scales is not None:
        sc = scales[layer][pages].permute(0, 1, 3, 2, 4).reshape(B, S, K, 2).float()
        s = s * sc[..., 0].transpose(1, 2)[:, :, None, :]
    p, l = _softmax_rows(s, mask, None if sinks is None else sinks.float().reshape(K, G))
    if scales is not None:
        p = torch.where(mask, p * sc[..., 1].transpose(1, 2)[:, :, None, :], 0.0)
    v = torch.where(live[:, :, None, None], kv[..., D:], 0.0)
    o = torch.einsum("bkgs,bskd->bkgd", p, v) / l
    return o.reshape(B, 1, H, D).to(q.dtype)


def decode_paged_attention_full(
    q: torch.Tensor,
    kv_cache: torch.Tensor,
    layer: int,
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,
    sm_scale: float | None = None,
    window: int = 0,
    sinks: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention of the decode batch's ``[B, 1, H, D]`` queries over
    ``kv_cache[layer]``, row b over its own table row; returns
    ``[B, 1, H, D]`` in q's dtype. ``window``, ``sinks`` and ``scales`` as
    in ``flat_paged_attention_full``.

    CUDA tensors launch the kernel on the current stream; CPU tensors take
    the plain version."""
    if kv_cache.device.type == "cpu":
        return decode_paged_attention_plain(
            q, kv_cache, layer, page_table, kv_lens, sm_scale, None, window,
            sinks, scales,
        )
    if kv_cache.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_cache.device}")
    _check_decode(q, kv_cache, layer, page_table, kv_lens, sinks, scales)
    B, _, H, D = q.shape
    _, P, K, page, _ = kv_cache.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    spans, part_acc, part_ml = 1, None, None
    if q.dtype != torch.float32:
        spans = spans_for(B * K, live_pages_bound(page_table.shape[1], page, window),
                          _sm_count(q.device.index or 0))
        part_acc, part_ml = _span_scratch(spans, B, H, D, q.device)
    err = _decode_kernel()(
        out.data_ptr(), _ptr(part_acc), _ptr(part_ml), q.data_ptr(),
        kv_cache.data_ptr(), _ptr(scales), _ptr(sinks), page_table.data_ptr(),
        kv_lens.data_ptr(), B, spans, layer, P, K, page, page_table.shape[1],
        H // K, D, _DTYPE_CODES[q.dtype], int(scales is not None),
        max(int(window), 0),
        D**-0.5 if sm_scale is None else sm_scale,
        torch.cuda.current_stream(kv_cache.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"decode_paged_attention launch failed: CUDA error {err}")
    _count(decode_paged_attention_full, window, sinks, scales)
    return out


decode_paged_attention_full.launches = 0
decode_paged_attention_full.branch_launches = collections.Counter()


def decode_paged_attention(
    q: torch.Tensor,
    kv_cache: torch.Tensor,  # [num_pages, K, page, 2D]: one layer's pool
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """The single-layer entry: the same kernel on the ``[1, ...]`` view.
    It keeps the JAX package's name for callers that hold one layer's
    pool; the model's forward calls the ``_full`` entry."""
    return decode_paged_attention_full(
        q, kv_cache[None], 0, page_table, kv_lens, sm_scale
    )
