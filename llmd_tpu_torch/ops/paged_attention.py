"""Plain paged attention and KV write over the bucketed ``[B, Q]`` layout.

The port of what ``llmd_tpu/ops/paged_attention.py`` computes in XLA,
outside any kernel: ``write_kv_pages``, ``paged_attention_xla`` (gather the
context, masked softmax) and ``paged_attention_xla_blocked`` (the same by
blocks of pages with an online softmax, for long contexts), without sliding
window, sinks or int8 scales. They are plain PyTorch on every device and
serve ``Q > 1`` (prefill chunks), exactly where the JAX package uses XLA;
``Q == 1`` goes to the decode kernels (``llmd_tpu_torch.ops``).

The arithmetic is JAX's: operands in the working dtype, products summed in
f32 (bf16 operands are upcast first, which is exact), probabilities rounded
to the value dtype before the second product, masked scores at -1e30.

Layouts (one layer of the pool):
  kv_cache:   [num_pages, K, page, 2D]  (K in [..., :D], V in [..., D:])
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
    keep = valid.reshape(T)
    first = keep.int().argmax()
    src = torch.where(keep, torch.arange(T, device=keep.device), first)
    heads = torch.arange(K, device=keep.device)
    kv_cache.index_put_(
        (phys[src][:, None], heads[None, :], offset[src][:, None]), kv[src]
    )
    return kv_cache


def _gathered(kv_cache: torch.Tensor, pages: torch.Tensor):
    """Pages ``[B, n]`` of the pool as k, v ``[B, n * page, K, D]`` f32."""
    B, n = pages.shape
    _, K, page, D2 = kv_cache.shape
    kv = kv_cache[pages.long()]  # [B, n, K, page, 2D]
    kv = kv.permute(0, 1, 3, 2, 4).reshape(B, n * page, K, D2)
    D = D2 // 2
    return kv[..., :D].float(), kv[..., D:]


def paged_attention_xla(
    q: torch.Tensor,
    kv_cache: torch.Tensor,
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,
    positions: torch.Tensor,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Reference paged attention: gather the whole table, masked softmax."""
    B, Q, H, D = q.shape
    K = kv_cache.shape[1]
    S = page_table.shape[1] * kv_cache.shape[2]
    if sm_scale is None:
        sm_scale = D**-0.5
    k, v = _gathered(kv_cache, page_table)
    qg = q.reshape(B, Q, K, H // K, D).float()
    scores = torch.einsum("bqkgd,bskd->bqkgs", qg, k) * sm_scale
    key_pos = torch.arange(S, device=q.device)[None, None, :]
    mask = (key_pos <= positions[:, :, None]) & (key_pos < kv_lens[:, None, None])
    scores = torch.where(mask[:, :, None, None, :], scores, _MASKED)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bqkgs,bskd->bqkgd", probs.float(), v.float())
    return out.reshape(B, Q, H, D).to(q.dtype)


def paged_attention_xla_blocked(
    q: torch.Tensor,
    kv_cache: torch.Tensor,
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,
    positions: torch.Tensor,
    sm_scale: float | None = None,
    block_pages: int = 32,
) -> torch.Tensor:
    """The same attention by blocks of ``block_pages`` pages with an online
    softmax carry (m, l, acc): peak memory is O(B * Q * block) whatever
    the context length. A fully masked row (``l == 0``) gives zeros."""
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
        k, v = _gathered(kv_cache, pages)
        s = torch.einsum("bqkgd,bskd->bqkgs", qg, k) * sm_scale
        key_pos = p0 * page + torch.arange(k.shape[1], device=q.device)[None, None, :]
        mask = (key_pos <= positions[:, :, None]) & (key_pos < kv_lens[:, None, None])
        mask = mask[:, :, None, None, :]
        s = torch.where(mask, s, _MASKED)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        # A fully masked row keeps m_new = -1e30 and exp(0) = 1: zero it.
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bqkgs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l[..., None]).reshape(B, Q, H, D).to(q.dtype)
