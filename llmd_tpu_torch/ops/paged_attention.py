"""Plain paged attention and KV write over the bucketed ``[B, Q]`` layout.

The port of what ``llmd_tpu/ops/paged_attention.py`` computes in XLA,
outside any kernel: ``write_kv_pages``, ``scatter_kv_scales`` and
``scatter_kv_scales_flat`` (the int8 pool's per-row scales),
``paged_attention_xla`` (gather the context, masked softmax) and
``paged_attention_xla_blocked`` (the same by blocks of pages with an online
softmax, for long contexts), each attention with the sliding ``window``, the
per-head ``sinks`` and the int8 pool's ``scales``. They are plain PyTorch on
every device and serve ``Q > 1`` (prefill chunks), exactly where the JAX
package uses XLA; ``Q == 1`` goes to the decode kernels
(``llmd_tpu_torch.ops``).

The arithmetic is JAX's: operands in the working dtype, products summed in
f32 (bf16 operands are upcast first, which is exact), probabilities rounded
to the value dtype before the second product, masked scores at -1e30.

Layouts (one layer of the pool):
  kv_cache:   [num_pages, K, page, 2D]  (K in [..., :D], V in [..., D:])
  scales:     [num_pages, K, page, 2]   f32 (int8 pools: K and V half)
  q:          [B, Q, H, D]
  page_table: [B, max_pages] int32
  kv_lens:    [B] valid kv tokens per row after this step's writes
  positions:  [B, Q] absolute position of each query token
"""

from __future__ import annotations

import torch

_MASKED = -1e30


def write_kv_pages(
    kv_cache: torch.Tensor,  # [num_pages, K, page, 2D]
    k: torch.Tensor,  # [B, Q, K, D]
    v: torch.Tensor,  # [B, Q, K, D]
    page_table: torch.Tensor,  # [B, max_pages]
    positions: torch.Tensor,  # [B, Q]
    valid: torch.Tensor,  # [B, Q] bool
) -> torch.Tensor:
    """Scatter this step's K|V into their cache slots, in place.

    Token (b, i) lands at ``[page_table[b, pos // page], :, pos % page, :]``;
    invalid (padding) tokens are dropped. At least one token must be valid
    (the engine dispatches no empty group): instead of compacting the valid
    tokens, which would read their count back to the host, every invalid
    token repeats the first valid token's target and value, so duplicate
    stores carry identical bytes."""
    num_pages, K, page, D2 = kv_cache.shape
    T = positions.numel()
    kv = torch.cat([k, v], dim=-1).reshape(T, K, D2).to(kv_cache.dtype)
    pos = positions.long()
    phys = torch.gather(page_table.long(), 1, pos // page).reshape(T)
    offset = (pos % page).reshape(T)
    src = _first_valid(valid.reshape(T))
    heads = torch.arange(K, device=kv_cache.device)
    kv_cache.index_put_(
        (phys[src][:, None], heads[None, :], offset[src][:, None]), kv[src]
    )
    return kv_cache


def _first_valid(keep: torch.Tensor) -> torch.Tensor:
    """Source index per token: itself where ``keep``, else the first kept
    token, so a dropped token's store repeats a kept one's bytes (no host
    read of the kept count)."""
    first = keep.int().argmax()
    return torch.where(keep, torch.arange(keep.numel(), device=keep.device), first)


def scatter_kv_scales(
    scales: torch.Tensor,  # [num_pages, K, page, 2] (one layer)
    srow: torch.Tensor,  # [B, Q, K, 2] per-row K/V-half scales
    page_table: torch.Tensor,  # [B, max_pages]
    positions: torch.Tensor,  # [B, Q]
    valid: torch.Tensor,  # [B, Q] bool
) -> torch.Tensor:
    """Scatter this step's per-row scales into one layer's scale pool, in
    place: the int8 sibling of ``write_kv_pages``, with the same addressing
    and the same handling of invalid tokens."""
    num_pages, K, page, two = scales.shape
    T = positions.numel()
    pos = positions.long()
    phys = torch.gather(page_table.long(), 1, pos // page).reshape(T)
    offset = (pos % page).reshape(T)
    src = _first_valid(valid.reshape(T))
    heads = torch.arange(K, device=scales.device)
    scales.index_put_(
        (phys[src][:, None], heads[None, :], offset[src][:, None]),
        srow.reshape(T, K, two)[src].to(scales.dtype),
    )
    return scales


def scatter_kv_scales_flat(
    scales: torch.Tensor,  # [num_pages, K, page, 2] (one layer)
    srow: torch.Tensor,  # [T, 1, K, 2]
    page_table: torch.Tensor,  # [R, max_pages] compact per-row table
    rows: torch.Tensor,  # [T] token -> row
    positions: torch.Tensor,  # [T]
    total: int,  # live tokens [0, total); the rest are pads
) -> torch.Tensor:
    """The flat step's scale scatter, in place: one (page, slot) store per
    live token (distinct targets), as ``write_kv_pages_flat_plain`` stores
    the data."""
    page = scales.shape[2]
    pos = positions[:total].long()
    phys = page_table[rows[:total].long(), pos // page].long()
    scales[phys, :, pos % page, :] = srow[:total, 0].to(scales.dtype)
    return scales


def _gathered(kv_cache: torch.Tensor, pages: torch.Tensor, scales=None, dtype=None):
    """Pages ``[B, n]`` of the pool as k, v ``[B, n * page, K, D]``: k in
    f32, v in the pool's dtype; with ``scales`` (an int8 pool's ``[P, K,
    page, 2]``) both dequantized in f32 and rounded to ``dtype`` (the
    reference's working dtype), k then widened to f32."""
    B, n = pages.shape
    _, K, page, D2 = kv_cache.shape
    kv = kv_cache[pages.long()]  # [B, n, K, page, 2D]
    kv = kv.permute(0, 1, 3, 2, 4).reshape(B, n * page, K, D2)
    D = D2 // 2
    if scales is None:
        return kv[..., :D].float(), kv[..., D:]
    s = scales[pages.long()].permute(0, 1, 3, 2, 4).reshape(B, n * page, K, 2).float()
    k = (kv[..., :D].float() * s[..., 0:1]).to(dtype).float()
    return k, (kv[..., D:].float() * s[..., 1:2]).to(dtype)


def _mask(key_pos, positions, kv_lens, window):
    """[B, Q, S] live keys: causal, inside the context and, for a sliding
    ``window`` > 0, after ``position - window``."""
    mask = (key_pos <= positions[:, :, None]) & (key_pos < kv_lens[:, None, None])
    if window:
        mask &= key_pos > positions[:, :, None] - window
    return mask


def _sinks(sinks, K: int, G: int) -> torch.Tensor:
    """Per-q-head sink logits [H] as [K, G] f32 (head h -> (h // G, h % G))."""
    return sinks.float().reshape(K, G)


def paged_attention_xla(
    q: torch.Tensor,
    kv_cache: torch.Tensor,
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,
    positions: torch.Tensor,
    sm_scale: float | None = None,
    window: int = 0,
    sinks: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Reference paged attention: gather the whole table, masked softmax.
    ``sinks`` ([H]) append one always-live key column whose value is zero
    (the softmax over ``[scores, sink]``, then the sink column dropped);
    ``scales`` dequantize an int8 pool's gathered rows first."""
    B, Q, H, D = q.shape
    K = kv_cache.shape[1]
    G = H // K
    S = page_table.shape[1] * kv_cache.shape[2]
    if sm_scale is None:
        sm_scale = D**-0.5
    k, v = _gathered(kv_cache, page_table, scales, q.dtype)
    qg = q.reshape(B, Q, K, G, D).float()
    scores = torch.einsum("bqkgd,bskd->bqkgs", qg, k) * sm_scale
    key_pos = torch.arange(S, device=q.device)[None, None, :]
    mask = _mask(key_pos, positions, kv_lens, window)
    scores = torch.where(mask[:, :, None, None, :], scores, _MASKED)
    if sinks is None:
        probs = torch.softmax(scores, dim=-1)
    else:
        sk = _sinks(sinks, K, G)[None, None, :, :, None].expand(B, Q, K, G, 1)
        probs = torch.softmax(torch.cat([scores, sk], dim=-1), dim=-1)[..., :-1]
    out = torch.einsum("bqkgs,bskd->bqkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, Q, H, D).to(q.dtype)


def paged_attention_xla_blocked(
    q: torch.Tensor,
    kv_cache: torch.Tensor,
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,
    positions: torch.Tensor,
    sm_scale: float | None = None,
    block_pages: int = 32,
    window: int = 0,
    sinks: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """The same attention by blocks of ``block_pages`` pages with an online
    softmax carry (m, l, acc): peak memory is O(B * Q * block) whatever
    the context length. A fully masked row (``l == 0``) gives zeros; the
    sinks fold into (m, l, acc) after the last block."""
    B, Q, H, D = q.shape
    K, page = kv_cache.shape[1], kv_cache.shape[2]
    max_pages = page_table.shape[1]
    if sm_scale is None:
        sm_scale = D**-0.5
    G = H // K
    qg = q.reshape(B, Q, K, G, D).float()
    m = torch.full((B, Q, K, G), _MASKED, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Q, K, G, D), dtype=torch.float32, device=q.device)
    for p0 in range(0, max_pages, block_pages):
        pages = page_table[:, p0 : p0 + block_pages]
        k, v = _gathered(kv_cache, pages, scales, q.dtype)
        s = torch.einsum("bqkgd,bskd->bqkgs", qg, k) * sm_scale
        key_pos = p0 * page + torch.arange(k.shape[1], device=q.device)[None, None, :]
        mask = _mask(key_pos, positions, kv_lens, window)[:, :, None, None, :]
        s = torch.where(mask, s, _MASKED)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        # A fully masked row keeps m_new = -1e30 and exp(0) = 1: zero it.
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bqkgs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    if sinks is not None:
        # The sink is one more key without a value: fold exp(sink) into the
        # denominator in the running maximum's frame.
        sk = _sinks(sinks, K, G)[None, None]
        m2 = torch.maximum(m, sk)
        l = l * torch.exp(m - m2) + torch.exp(sk - m2)
        acc = acc * torch.exp(m - m2)[..., None]
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l[..., None]).reshape(B, Q, H, D).to(q.dtype)
