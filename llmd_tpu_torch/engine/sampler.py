"""Token sampling on device: temperature / top-k / top-p / greedy.

The port of ``llmd_tpu/engine/sampler.py:sample_tokens`` with the same
masks. Gumbel noise comes from a ``torch.Generator`` seeded per row, so a
seeded row is reproducible within the port; its bits differ from JAX's
threefry stream, so seeded streams are not comparable across the two
packages (greedy streams are: both argmaxes return the first maximum).
"""

from __future__ import annotations

import numpy as np
import torch


def top_k_top_p_filter(
    scaled: torch.Tensor,  # [B, V] temperature-scaled logits
    top_k: torch.Tensor,  # [B] i32; 0 disables
    top_p: torch.Tensor,  # [B] f32; 1.0 disables
) -> torch.Tensor:
    """``scaled`` with the entries outside each row's top-k and top-p
    (nucleus) sets replaced by -inf — the JAX sampler's masks."""
    V = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    # top-k: keep values >= the k-th largest (k = 0 keeps all).
    k = torch.where(top_k > 0, top_k, V).long()
    kth = torch.gather(sorted_desc, -1, (k - 1)[:, None])
    scaled = torch.where(scaled >= kth, scaled, float("-inf"))
    # top-p: the smallest prefix of the sorted distribution with mass >= p.
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep_sorted = (cum - probs_sorted) < top_p[:, None]  # keeps rank 0
    num_keep = keep_sorted.sum(dim=-1).clamp(min=1)
    p_thresh = torch.gather(sorted_desc, -1, (num_keep - 1)[:, None])
    return torch.where(scaled >= p_thresh, scaled, float("-inf"))


def sample_tokens(
    logits: torch.Tensor,  # [B, V]
    temperature: np.ndarray,  # [B] f32 (host); <= 1e-5 means greedy
    top_k: np.ndarray,  # [B] i32 (host)
    top_p: np.ndarray,  # [B] f32 (host)
    seeds: np.ndarray,  # [B] u32 (host) per-row noise seeds
    all_greedy: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (token_ids [B] i32, logprobs [B] f32 of the chosen token).

    ``all_greedy`` skips the sort/top-k/top-p/gumbel pipeline."""
    logits = logits.float()
    greedy_tok = torch.argmax(logits, dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    if all_greedy:
        tokens = greedy_tok
    else:
        dev = logits.device
        temp = torch.as_tensor(np.maximum(temperature, 1e-5), device=dev)
        scaled = top_k_top_p_filter(
            logits / temp[:, None],
            torch.as_tensor(top_k, device=dev),
            torch.as_tensor(top_p, dtype=torch.float32, device=dev),
        )
        tokens = greedy_tok.clone()
        V = logits.shape[-1]
        for i in np.flatnonzero(temperature > 1e-5):
            g = torch.Generator(device=dev).manual_seed(int(seeds[i]))
            u = torch.rand(V, generator=g, device=dev).clamp_(min=1e-20)
            gumbel = -torch.log(-torch.log(u))
            tokens[i] = torch.argmax(scaled[i] + gumbel)
    chosen = torch.gather(logp, -1, tokens[:, None])[:, 0]
    return tokens.int(), chosen


def spec_seed(seed: int, out_index: int) -> int:
    """The per-(request seed, output index) sampling seed (the JAX
    derivation, ``sampler.spec_seed``)."""
    return (seed * 1000003 + out_index) & 0xFFFFFFFF
