"""Token sampling on device: temperature / top-k / top-p / greedy.

The port of ``llmd_tpu/engine/sampler.py:sample_tokens`` with the same
masks and the same noise: a sampled row's Gumbel values are those
``jax.random.gumbel(jax.random.key(seed), (V,), float32)`` gives, so seeded
streams are comparable across the two packages. ``threefry_bits`` and
``gumbel_noise`` reproduce JAX's default generator (``threefry2x32`` with
the partitionable counter layout, and the ``low`` branch of its Gumbel
sampler) in plain tensor arithmetic, batched over rows, on the logits'
device; the specification is ``jax/_src/prng.py`` (``threefry_2x32``,
``_threefry_random_bits_partitionable``) and ``jax/_src/random.py``
(``_uniform``, ``_gumbel``). The bits are exact; the Gumbel values agree to
an ulp of the two logarithms. Nothing here reads a value back to the host,
so the fused decode window can sample every iteration on the device.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # Threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


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


def _seeds_on(seeds, device: torch.device) -> torch.Tensor:
    """uint32 seeds (array or tensor, any shape) as a flat int64 tensor:
    PyTorch has few uint32 operators, int64 with a 32-bit mask has all."""
    if isinstance(seeds, torch.Tensor):
        return seeds.to(device=device, dtype=torch.int64).reshape(-1) & _MASK32
    flat = np.asarray(seeds).astype(np.int64).reshape(-1) & _MASK32
    return torch.from_numpy(flat).to(device)


def threefry_bits(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(jax.random.key(seed), (n,), uint32)`` for every
    seed of ``seeds`` ([N] int64 holding uint32 values): [N, n] int64.

    The key of a seed is the word pair (0, seed); element j's counter is
    the 64-bit index j split into (high, low) words; the output is the XOR
    of the two Threefry-2x32 words (20 rounds, a key injection every 4)."""
    k0 = torch.zeros_like(seeds)[:, None]
    k1 = seeds[:, None]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = k0
    x1 = (torch.arange(n, device=seeds.device)[None, :] + k1) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0 ^ x1


def gumbel_noise(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(jax.random.key(seed), (n,), float32)`` per seed:
    [N, n] f32. The top 23 bits fill the mantissa of a float in [1, 2);
    minus 1 it is uniform in [0, 1), floored at the smallest normal so the
    logarithms stay finite."""
    bits = threefry_bits(seeds, n)
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = mantissa.view(torch.float32) - 1.0
    u = torch.clamp(f * (1.0 - _TINY) + _TINY, min=_TINY)
    return -torch.log(-torch.log(u))


def sample_tokens(
    logits: torch.Tensor,  # [B, V]
    temperature,  # [B] f32, array or tensor; <= 1e-5 means greedy
    top_k,  # [B] i32
    top_p,  # [B] f32
    seeds,  # B uint32 noise seeds, array or tensor of any shape
    all_greedy: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (token_ids [B] i32, logprobs [B] f32 of the chosen token).

    ``all_greedy`` (the host knows the batch's sampling mix) skips the
    sort/top-k/top-p/gumbel pipeline."""
    logits = logits.float()
    greedy_tok = torch.argmax(logits, dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    if all_greedy:
        tokens = greedy_tok
    else:
        dev = logits.device
        temp = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
        scaled = top_k_top_p_filter(
            logits / temp.clamp(min=1e-5)[:, None],
            torch.as_tensor(top_k, device=dev),
            torch.as_tensor(top_p, dtype=torch.float32, device=dev),
        )
        gumbel = gumbel_noise(_seeds_on(seeds, dev), logits.shape[-1])
        sampled_tok = torch.argmax(scaled + gumbel, dim=-1)
        tokens = torch.where(temp <= 1e-5, greedy_tok, sampled_tok)
    chosen = torch.gather(logp, -1, tokens[:, None])[:, 0]
    return tokens.int(), chosen


def spec_seed(seed, out_index):
    """The per-(request seed, output index) sampling seed (JAX
    ``sampler.spec_seed``): ``seed * 1000003 + out_index`` mod 2**32.
    Python ints on the host (prefill, decode windows, one-shot verify);
    int64 tensors holding uint32 values on the device, where the fused
    verify window derives a row's seeds from its own acceptance. The
    product of two values below 2**32 and 2**20 fits in int64, so the
    masked tensor form is bit-equal to the Python form."""
    if isinstance(seed, torch.Tensor):
        return (seed.long() * 1000003 + out_index) & _MASK32
    return (seed * 1000003 + out_index) & _MASK32


def accept_counts(draft: torch.Tensor, target: torch.Tensor, draft_len: torch.Tensor):
    """The acceptance rule (JAX ``sampler.accept_counts``) on tensors, with
    no host read, so that the fused verify window applies it on the
    device. ``draft [..., k]`` against the target's samples ``[..., >= k]``,
    ``draft_len [...]`` masking each row's real width. Returns ``(n_emit,
    n_acc)``: ``n_acc`` the leading run of ``draft[j] == target[j]`` with
    ``j < draft_len``, and ``n_emit = n_acc + 1`` (the correction or bonus
    sample always lands)."""
    k = draft.shape[-1]
    idx = torch.arange(k, device=draft.device)
    matches = (draft == target[..., :k]) & (idx < draft_len[..., None])
    n_acc = torch.cumprod(matches.long(), dim=-1).sum(dim=-1)
    return n_acc + 1, n_acc


def accept_draft_tokens(draft: list[int], sampled: list[int]) -> tuple[list[int], int]:
    """One row's acceptance on the host (JAX ``accept_draft_tokens``):
    ``sampled[j]`` is the target's sample at drafted position j, whose
    context is ``draft[:j]``; that context holds while every earlier
    draft token matched, so the emitted window is ``sampled[0 .. m]`` with
    m the first mismatch (or the bonus sample when the whole draft
    holds). Returns (emitted window, draft tokens accepted): the rule of
    ``accept_counts`` on one row, in plain Python."""
    if not sampled:
        return [], 0
    k = min(len(draft), len(sampled))
    n_acc = 0
    while n_acc < k and draft[n_acc] == sampled[n_acc]:
        n_acc += 1
    return [int(t) for t in sampled[: min(n_acc + 1, len(sampled))]], n_acc
