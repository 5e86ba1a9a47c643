"""Flattened-token paged attention (the ``cu_q_lens`` step's attention).

``flat_paged_attention_full`` launches the CUDA kernel
``csrc/flat_paged_attention.cu``, which replaces the TPU kernel
``llmd_tpu/ops/ragged_paged_attention.py:_decode_kernel`` in its
row-lookup form (entry ``flat_paged_attention_full``), plain form: no
sliding window, sinks or int8 pool. Each packed token t attends with its H
query heads over positions ``[0, kv_lens[t])`` of row ``rows[t]``'s pages
(``kv_len = position + 1`` is the causal mask within a row), G = H / K
query heads per KV head, online softmax in f32. It is bound by bytes: the
live K|V pages it reads. See the kernel source for its design.

``flat_paged_attention_plain`` is the plain PyTorch version: it gathers
each row's live context once and runs a masked softmax over it. The
wrapper takes it for CPU tensors only.
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


def _check(q, kv_cache, rows, page_table, kv_lens):
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
    if rows.shape != (T,) or kv_lens.shape != (T,) or page_table.dim() != 2:
        raise ValueError("rows/kv_lens must be [T] and page_table [R, max_pages]")
    for name, t in (("q", q), ("kv_cache", kv_cache), ("rows", rows),
                    ("page_table", page_table), ("kv_lens", kv_lens)):
        if t.device != kv_cache.device:
            raise ValueError(f"{name} is on {t.device}, the pool on {kv_cache.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("rows", rows), ("page_table", page_table), ("kv_lens", kv_lens)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q.data_ptr() % 16 or kv_cache.data_ptr() % 16:
        raise ValueError("q and the pool must be 16-byte aligned")


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
    _check(q, kv_cache, rows, page_table, kv_lens)
    T, _, H, D = q.shape
    L, P, K, page, _ = kv_cache.shape
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
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
