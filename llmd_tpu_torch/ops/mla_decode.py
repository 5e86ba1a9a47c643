"""Latent (MLA) decode attention over the paged latent pool.

``mla_decode_paged_attention_full`` launches the CUDA kernel
``csrc/mla_decode_attention.cu``, which replaces the TPU kernel
``llmd_tpu/ops/mla_decode.py:_mla_decode_kernel`` (entry
``mla_decode_paged_attention_full``): row b of the decode batch attends with
its H absorbed query heads over positions ``[0, kv_lens[b])`` of the latent
pool ``[L, pages, 1, page, Dl]``; scores span the whole latent row, values
are its first ``rank`` components, softmax in f32; a pad row (``kv_len`` 0)
gets zeros. One latent tile serves all H heads: in bf16/f16 the heads are
the rows of tensor-core products, in head groups of 16 or 32
(``heads_per_block``; any H). It is bound by bytes: the live latent rows,
read once. Each row's pages are cut into spans (one block each per head
group, merged by a second pass) of one size for the batch, so that a decode
batch of a few dozen rows fills the card with blocks of equal work; the
wrapper passes the most spans a row may take and the blocks wanted per head
group (one an SM), and allocates the merge's scratch. See the kernel
source for its design.

``mla_decode_paged_attention_plain`` is the plain PyTorch version: one
masked gather of every row's pages, softmax in f32, positions past
``kv_len`` masked out of the scores and zeroed in the values. It reads
nothing back to the host. The wrapper takes it for CPU tensors only.
``mla_span_partials_plain`` and ``mla_merge_spans_plain`` are the kernel's
decomposition in plain PyTorch (head groups x spans, partials, the merge),
for the tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from llmd_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_DL, _MAX_RANK, _MAX_PAGE = 640, 512, 32
# Spans a row is cut into, at most (the grid's span dimension).
_MAX_SPANS = 16
_lib = None


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def spans_for(max_pages: int) -> int:
    """The most chunks a row is cut into (the grid's span dimension):
    ``_MAX_SPANS``, or one a page of the table if it is narrower. With one
    span a block writes its row's output, with more the merge does."""
    return max(1, min(_MAX_SPANS, max_pages))


def heads_per_block(H: int, dtype: torch.dtype) -> int:
    """The kernel's head group: bf16/f16 take 16 heads a block up to 16,
    else 32 (m16 fragments; the last group padded); f32 takes 32."""
    return 16 if H <= 16 and dtype != torch.float32 else 32


def span_chunk(kv_lens: torch.Tensor, page: int, spans: int, target: int) -> int:
    """Pages a span takes (the kernel's ``span_chunk``, read here on the
    host for the tests): the smallest chunk for which every row's chunks
    number at most ``target`` in all, and no fewer than the longest row's
    pages over ``spans``."""
    n = (kv_lens.long().clamp(min=0) + page - 1) // page
    total, longest = int(n.sum()), int(n.max()) if n.numel() else 0
    lo = max(1, -(-total // target), -(-longest // spans))
    hi = max(lo, longest)
    while lo < hi:
        mid = (lo + hi) // 2
        if int(((n + mid - 1) // mid).sum()) <= target:
            hi = mid
        else:
            lo = mid + 1
    return lo


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("mla_decode_attention")
        lib.mla_decode_attention.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.mla_decode_attention.restype = ctypes.c_int
        _lib = lib
    return _lib.mla_decode_attention


def mla_decode_paged_attention_plain(
    q_eff: torch.Tensor,  # [B, 1, H, Dl]
    latent_cache: torch.Tensor,  # [L, num_pages, 1, page, Dl]
    layer: int,
    page_table: torch.Tensor,  # [B, max_pages]
    kv_lens: torch.Tensor,  # [B] (0 for a pad row)
    rank: int,
    sm_scale: float,
    live_pages: int | None = None,
) -> torch.Tensor:  # [B, 1, H, rank]
    """Plain PyTorch version. ``live_pages`` (the batch's largest live page
    count, where the caller knows it on the host) bounds the gather, which
    otherwise spans the table's width."""
    B, _, H, Dl = q_eff.shape
    page = latent_cache.shape[3]
    pages = page_table[:, :live_pages].long()
    S = pages.shape[1] * page
    lat = latent_cache[layer][pages].reshape(B, S, Dl).float()
    live = torch.arange(S, device=q_eff.device)[None, :] < kv_lens[:, None]  # [B, S]
    s = torch.einsum("bhd,bsd->bhs", q_eff[:, 0].float(), lat) * sm_scale
    s = s.masked_fill(~live[:, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)  # a pad row: every score -inf
    p = torch.exp(s - m)
    v = torch.where(live[:, :, None], lat[..., :rank], 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhs,bsr->bhr", p, v) / torch.where(l == 0.0, 1.0, l)
    return o[:, None].to(q_eff.dtype)


def _check(q_eff, latent_cache, layer, page_table, kv_lens, rank):
    B, Q, H, Dl = q_eff.shape
    L, P, one, page, Dlc = latent_cache.shape
    if Q != 1 or one != 1 or Dlc != Dl:
        raise ValueError(
            f"q_eff {tuple(q_eff.shape)} does not fit the latent pool {tuple(latent_cache.shape)}"
        )
    if (Dl % 32 or rank % 32 or not 0 < rank <= Dl or Dl > _MAX_DL or rank > _MAX_RANK
            or page > _MAX_PAGE):
        raise ValueError(
            f"kernel takes Dl and rank multiples of 32 with rank <= Dl <= {_MAX_DL}, "
            f"rank <= {_MAX_RANK} and page <= {_MAX_PAGE}; "
            f"got Dl={Dl}, rank={rank}, page={page}"
        )
    if kv_lens.shape != (B,) or page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError("kv_lens must be [B] and page_table [B, max_pages]")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if q_eff.dtype != latent_cache.dtype or q_eff.dtype not in _DTYPE_CODES:
        raise ValueError(f"q_eff {q_eff.dtype} and pool {latent_cache.dtype} must share a float dtype")
    for name, t in (("q_eff", q_eff), ("latent_cache", latent_cache),
                    ("page_table", page_table), ("kv_lens", kv_lens)):
        if t.device != latent_cache.device:
            raise ValueError(f"{name} is on {t.device}, the pool on {latent_cache.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("page_table", page_table), ("kv_lens", kv_lens)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if q_eff.data_ptr() % 16 or latent_cache.data_ptr() % 16:
        raise ValueError("q_eff and the pool must be 16-byte aligned")


def mla_decode_paged_attention_full(
    q_eff: torch.Tensor,
    latent_cache: torch.Tensor,
    layer: int,
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,
    rank: int,
    sm_scale: float,
) -> torch.Tensor:
    """Latent attention of the decode batch's ``[B, 1, H, Dl]`` absorbed
    queries over ``latent_cache[layer]``, row b over its own table row;
    returns ``[B, 1, H, rank]`` in q_eff's dtype.

    CUDA tensors launch the kernel on the current stream; CPU tensors take
    the plain version."""
    if latent_cache.device.type == "cpu":
        return mla_decode_paged_attention_plain(
            q_eff, latent_cache, layer, page_table, kv_lens, rank, sm_scale
        )
    if latent_cache.device.type != "cuda":
        raise ValueError(f"unsupported device {latent_cache.device}")
    _check(q_eff, latent_cache, layer, page_table, kv_lens, rank)
    B, _, H, Dl = q_eff.shape
    _, P, _, page, _ = latent_cache.shape
    dev = q_eff.device
    out = torch.empty((B, 1, H, rank), dtype=q_eff.dtype, device=dev)
    if B == 0:
        return out
    sms = _sm_count(dev.index or 0)  # the blocks wanted per head group: one wave
    spans = spans_for(page_table.shape[1])
    # One scratch allocation: part_acc [items, H, rank] and part_ml [items,
    # H, 2] in f32, then row_items [B + 1] int32 (4 bytes each as well).
    items = max(sms, B)
    scratch = torch.empty(items * H * (rank + 2) + B + 1, dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    err = _kernel()(
        out.data_ptr(), base, base + 4 * items * H * rank, base + 4 * items * H * (rank + 2),
        q_eff.data_ptr(), latent_cache.data_ptr(), page_table.data_ptr(), kv_lens.data_ptr(),
        B, spans, layer, P, page, page_table.shape[1], H, Dl, rank, _DTYPE_CODES[q_eff.dtype],
        sm_scale, sms, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"mla_decode_attention launch failed: CUDA error {err}")
    mla_decode_paged_attention_full.launches += 1
    return out


mla_decode_paged_attention_full.launches = 0


def mla_span_partials_plain(
    q_eff: torch.Tensor,  # [B, 1, H, Dl]
    latent_cache: torch.Tensor,  # [L, num_pages, 1, page, Dl]
    layer: int,
    page_table: torch.Tensor,  # [B, max_pages]
    kv_lens: torch.Tensor,  # [B]
    rank: int,
    sm_scale: float,
    spans: int,
    group: int,
    target: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's per-block work in plain PyTorch (f32): for each row,
    head group of ``group`` heads and span of the row's live pages (chunks
    of ``span_chunk`` pages, the trailing spans possibly empty), each
    head's softmax partial over the span's live positions.
    Returns m, l ``[B, spans, H]`` (natural units, as the kernel hands them
    to the merge) and acc ``[B, spans, H, rank]``; an empty span keeps
    m = -inf, l = 0, acc = 0."""
    B, _, H, Dl = q_eff.shape
    page = latent_cache.shape[3]
    m = torch.full((B, spans, H), float("-inf"))
    l = torch.zeros((B, spans, H))
    acc = torch.zeros((B, spans, H, rank))
    chunk = span_chunk(kv_lens, page, spans, target)
    for b, kv_len in enumerate(kv_lens.tolist()):
        n_pages = -(-kv_len // page)
        for s in range(spans):
            pb = min(n_pages, s * chunk)
            pe = min(n_pages, pb + chunk)
            hi = min(pe * page, kv_len)
            if hi <= pb * page:
                continue
            lat = latent_cache[layer, page_table[b, pb:pe].long(), 0].reshape(-1, Dl).float()
            lat = lat[: hi - pb * page]
            for h0 in range(0, H, group):
                qg = q_eff[b, 0, h0 : h0 + group].float()  # [<= group, Dl]
                sc = qg @ lat.T * sm_scale
                mx = sc.amax(dim=1)
                p = torch.exp(sc - mx[:, None])
                m[b, s, h0 : h0 + group] = mx
                l[b, s, h0 : h0 + group] = p.sum(dim=1)
                acc[b, s, h0 : h0 + group] = p @ lat[:, :rank]
    return m, l, acc


def mla_merge_spans_plain(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """The merge kernel in plain PyTorch: fold each row's and head's span
    partials (``mla_span_partials_plain``) and normalise; ``[B, 1, H,
    rank]`` f32, a row with every span empty (a pad row) zero."""
    M = m.amax(dim=1, keepdim=True)  # [B, 1, H]
    w = torch.where(l > 0, torch.exp(m - torch.where(torch.isfinite(M), M, 0.0)), 0.0)
    den = (w * l).sum(dim=1)
    out = (w[..., None] * acc).sum(dim=1) / torch.where(den == 0.0, 1.0, den)[..., None]
    return out[:, None]
