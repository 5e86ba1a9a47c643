"""Paged attention kernels for one-token queries: the flat step's and decode's.

``flat_paged_attention_full`` launches the CUDA kernel
``csrc/flat_paged_attention.cu``, which replaces the TPU kernel
``llmd_tpu/ops/ragged_paged_attention.py:_decode_kernel`` in its
row-lookup form (entry ``flat_paged_attention_full``), plain form: no
sliding window, sinks or int8 pool. Each packed token t attends with its H
query heads over positions ``[0, kv_lens[t])`` of row ``rows[t]``'s pages
(``kv_len = position + 1`` is the causal mask within a row), G = H / K
query heads per KV head, online softmax in f32. It is bound by bytes: the
live K|V pages it reads. See the kernel source for its design.

``decode_paged_attention_full`` (and ``decode_paged_attention`` on a
single-layer pool) launches ``csrc/decode_paged_attention.cu``, which
replaces the same TPU kernel without row lookup (``_decode_call``): row b of
the decode batch attends with its one query token over positions
``[0, kv_lens[b])`` of its own table row; a pad row (``kv_len`` 0) gets
zeros. It is bound by bytes too. Its ``(B, K)`` grid is small for the card
(64 blocks at 8 rows) and each block walks its row's pages in series; the
kernel source says what the redesign would do. Both kernels share their
device code (``csrc/paged_attention.cuh``), as the TPU entries share
``_decode_kernel``.

``flat_paged_attention_plain`` and ``decode_paged_attention_plain`` are the
plain PyTorch versions: they gather each row's live context once and run a
masked softmax over it in f32. The wrappers take them for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from llmd_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128, 256)
_MAX_PAGE = 32
_MAX_SMEM = 48 * 1024
_lib = None
_decode_lib = None


def _decode_kernel():
    global _decode_lib
    if _decode_lib is None:
        lib = _build.load("decode_paged_attention")
        lib.decode_paged_attention.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
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
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.flat_paged_attention.restype = ctypes.c_int
        _lib = lib
    return _lib.flat_paged_attention


def flat_paged_attention_plain(
    q: torch.Tensor,  # [T, 1, H, D]
    kv_cache: torch.Tensor,  # [L, num_pages, K, page, 2D]
    layer: int,
    rows: torch.Tensor,  # [T] token -> row of page_table
    page_table: torch.Tensor,  # [R, max_pages]
    kv_lens: torch.Tensor,  # [T] position + 1 (0 for pads)
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: per row, gather the live context once and run
    a masked softmax for the row's tokens, all in f32. Tokens with
    ``kv_len == 0`` (pads) get zeros."""
    T, _, H, D = q.shape
    _, _, K, page, D2 = kv_cache.shape
    G = H // K
    if sm_scale is None:
        sm_scale = D**-0.5
    lens = kv_lens.tolist()
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
        kv = kv_cache[layer, pages].permute(0, 2, 1, 3).reshape(-1, K, D2)[:n]
        kv = kv.float()
        s = torch.einsum("tkgd,skd->tkgs", qf[idx], kv[..., :D]) * sm_scale
        live = torch.arange(n, device=q.device)[None, :] < kv_lens[idx, None]
        s = s.masked_fill(~live[:, None, None, :], float("-inf"))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = torch.einsum("tkgs,skd->tkgd", p, kv[..., D:])
        out[idx] = o / p.sum(dim=-1, keepdim=True)
    return out.reshape(T, 1, H, D).to(q.dtype)


def _check_common(q, kv_cache, layer, index_tensors):
    """What both kernels require of q, the pool and their int32 index
    tensors (``index_tensors``: (name, tensor) pairs)."""
    T, Q, H, D = q.shape
    L, P, K, page, D2 = kv_cache.shape
    if Q != 1 or D2 != 2 * D or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not fit pool {tuple(kv_cache.shape)}")
    if D not in _HEAD_DIMS or H // K > 32 or page > _MAX_PAGE:
        raise ValueError(
            f"kernel takes head_dim in {_HEAD_DIMS}, <= 32 query heads per "
            f"KV head and page <= {_MAX_PAGE}; got D={D}, G={H // K}, page={page}"
        )
    if q.dtype != kv_cache.dtype or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q {q.dtype} and pool {kv_cache.dtype} must share a float dtype")
    if page * D2 * kv_cache.element_size() > _MAX_SMEM:
        raise ValueError("one page of K|V exceeds the kernel's shared-memory tile")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    for name, t in (("q", q), ("kv_cache", kv_cache), *index_tensors):
        if t.device != kv_cache.device:
            raise ValueError(f"{name} is on {t.device}, the pool on {kv_cache.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in index_tensors:
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.data_ptr() % 16 or kv_cache.data_ptr() % 16:
        raise ValueError("q and the pool must be 16-byte aligned")


def _check(q, kv_cache, layer, rows, page_table, kv_lens):
    T = q.shape[0]
    if rows.shape != (T,) or kv_lens.shape != (T,) or page_table.dim() != 2:
        raise ValueError("rows/kv_lens must be [T] and page_table [R, max_pages]")
    _check_common(q, kv_cache, layer, (
        ("rows", rows), ("page_table", page_table), ("kv_lens", kv_lens)))


def _check_decode(q, kv_cache, layer, page_table, kv_lens):
    B = q.shape[0]
    if kv_lens.shape != (B,) or page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError("kv_lens must be [B] and page_table [B, max_pages]")
    _check_common(q, kv_cache, layer, (
        ("page_table", page_table), ("kv_lens", kv_lens)))


def flat_paged_attention_full(
    q: torch.Tensor,
    kv_cache: torch.Tensor,
    layer: int,
    rows: torch.Tensor,
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Attention of the packed ``[T, 1, H, D]`` query stream over
    ``kv_cache[layer]``; returns ``[T, 1, H, D]`` in q's dtype.

    CUDA tensors launch the kernel on the current stream; CPU tensors take
    the plain version."""
    if kv_cache.device.type == "cpu":
        return flat_paged_attention_plain(
            q, kv_cache, layer, rows, page_table, kv_lens, sm_scale
        )
    if kv_cache.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_cache.device}")
    _check(q, kv_cache, layer, rows, page_table, kv_lens)
    T, _, H, D = q.shape
    L, P, K, page, _ = kv_cache.shape
    out = torch.empty_like(q)
    if T == 0:
        return out
    err = _kernel()(
        out.data_ptr(), q.data_ptr(), kv_cache.data_ptr(), rows.data_ptr(),
        page_table.data_ptr(), kv_lens.data_ptr(), T, layer, P, K, page,
        page_table.shape[1], H // K, D, _DTYPE_CODES[q.dtype],
        D**-0.5 if sm_scale is None else sm_scale,
        torch.cuda.current_stream(kv_cache.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flat_paged_attention launch failed: CUDA error {err}")
    flat_paged_attention_full.launches += 1
    return out


flat_paged_attention_full.launches = 0


def decode_paged_attention_plain(
    q: torch.Tensor,  # [B, 1, H, D]
    kv_cache: torch.Tensor,  # [L, num_pages, K, page, 2D]
    layer: int,
    page_table: torch.Tensor,  # [B, max_pages]
    kv_lens: torch.Tensor,  # [B] (0 for a pad row)
    sm_scale: float | None = None,
    live_pages: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: gather every row's pages once and run a
    masked softmax over positions ``[0, kv_len)`` in f32. Pad rows get
    zeros. Positions past ``kv_len`` are masked out of the scores and
    zeroed in the values, so uninitialised pool memory never enters a sum.
    It reads nothing back to the host; ``live_pages`` (the batch's largest
    live page count, where the caller knows it on the host) bounds the
    gather, which otherwise spans the table's width."""
    B, _, H, D = q.shape
    _, _, K, page, D2 = kv_cache.shape
    G = H // K
    if sm_scale is None:
        sm_scale = D**-0.5
    pages = page_table[:, :live_pages].long()
    S = pages.shape[1] * page
    kv = kv_cache[layer][pages]  # [B, n, K, page, 2D]
    kv = kv.permute(0, 1, 3, 2, 4).reshape(B, S, K, D2).float()
    live = torch.arange(S, device=q.device)[None, :] < kv_lens[:, None]  # [B, S]
    qf = q[:, 0].float().reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qf, kv[..., :D]) * sm_scale
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)  # a pad row: every score -inf
    p = torch.exp(s - m)
    v = torch.where(live[:, :, None, None], kv[..., D:], 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p, v) / torch.where(l == 0.0, 1.0, l)
    return o.reshape(B, 1, H, D).to(q.dtype)


def decode_paged_attention_full(
    q: torch.Tensor,
    kv_cache: torch.Tensor,
    layer: int,
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Attention of the decode batch's ``[B, 1, H, D]`` queries over
    ``kv_cache[layer]``, row b over its own table row; returns
    ``[B, 1, H, D]`` in q's dtype.

    CUDA tensors launch the kernel on the current stream; CPU tensors take
    the plain version."""
    if kv_cache.device.type == "cpu":
        return decode_paged_attention_plain(
            q, kv_cache, layer, page_table, kv_lens, sm_scale
        )
    if kv_cache.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_cache.device}")
    _check_decode(q, kv_cache, layer, page_table, kv_lens)
    B, _, H, D = q.shape
    _, P, K, page, _ = kv_cache.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = _decode_kernel()(
        out.data_ptr(), q.data_ptr(), kv_cache.data_ptr(), page_table.data_ptr(),
        kv_lens.data_ptr(), B, layer, P, K, page, page_table.shape[1], H // K, D,
        _DTYPE_CODES[q.dtype], D**-0.5 if sm_scale is None else sm_scale,
        torch.cuda.current_stream(kv_cache.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"decode_paged_attention launch failed: CUDA error {err}")
    decode_paged_attention_full.launches += 1
    return out


decode_paged_attention_full.launches = 0


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
