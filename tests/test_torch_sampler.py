"""The port's sampler against the JAX sampler on the same logits.

Greedy picks (and their logprobs) must be identical. The top-k / top-p
masks must select the same tokens: the JAX sampler does not expose its
mask, so each candidate token j is probed by replacing the Gumbel noise
with a spike at j — JAX then samples j exactly when j survives the mask.
Sampled rows draw JAX's own noise: the port's threefry bits must equal
``jax.random.bits`` exactly, its Gumbel values ``jax.random.gumbel`` to an
ulp of the two logarithms, and so the sampled tokens are JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llmd_tpu.engine.sampler as jsampler
from llmd_tpu.engine.sampler import SamplingInputs
from llmd_tpu_torch.engine.sampler import (
    gumbel_noise,
    sample_tokens,
    threefry_bits,
    top_k_top_p_filter,
)

B, V = 6, 40


def logits(seed, scale=3.0):
    x = np.random.default_rng(seed).normal(size=(B, V)).astype(np.float32) * scale
    x[0, [4, 17]] = x[0].max() + 1.0  # an exact tie: both pick the first
    return x


def knobs(temperature, top_k, top_p):
    return (
        np.asarray(temperature, np.float32), np.asarray(top_k, np.int32),
        np.asarray(top_p, np.float32),
    )


def jax_sample(x, temp, top_k, top_p, seeds, all_greedy=False):
    s = SamplingInputs(
        temperature=jnp.asarray(temp), top_k=jnp.asarray(top_k),
        top_p=jnp.asarray(top_p), seeds=jnp.asarray(seeds, jnp.uint32),
    )
    tok, logp = jsampler.sample_tokens(jnp.asarray(x), s, all_greedy)
    return np.asarray(tok), np.asarray(logp)


@pytest.mark.parametrize("all_greedy", [True, False])
def test_greedy_is_identical(all_greedy):
    x = logits(0)
    temp, top_k, top_p = knobs([0.0] * B, [0] * B, [1.0] * B)
    seeds = np.arange(B, dtype=np.uint32)
    jt, jl = jax_sample(x, temp, top_k, top_p, seeds, all_greedy)
    tt, tl = sample_tokens(torch.from_numpy(x), temp, top_k, top_p, seeds, all_greedy)
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-5, rtol=0)
    assert tt[0].item() == 4


def test_greedy_rows_in_a_sampled_batch():
    x = logits(1)
    temp, top_k, top_p = knobs([0.0, 0.7, 0.0, 1.2, 0.0, 0.5], [0, 5] * 3, [1.0, 0.9] * 3)
    seeds = np.arange(B, dtype=np.uint32)
    jt, _ = jax_sample(x, temp, top_k, top_p, seeds)
    tt, _ = sample_tokens(torch.from_numpy(x), temp, top_k, top_p, seeds)
    greedy = temp == 0
    np.testing.assert_array_equal(tt.numpy()[greedy], jt[greedy])


def jax_mask(monkeypatch, x, temp, top_k, top_p):
    """[B, V] bool: which tokens the JAX sampler can emit per row."""

    def spike(key, shape, dtype):
        j = jax.random.key_data(key)[-1] % V
        return jax.nn.one_hot(j, V, dtype=dtype) * 1e6

    monkeypatch.setattr(jsampler.jax.random, "gumbel", spike)
    mask = np.zeros((B, V), bool)
    for j in range(V):
        tok, _ = jax_sample(x, temp, top_k, top_p, np.full(B, j, np.uint32))
        mask[:, j] = tok == j
    return mask


@pytest.mark.parametrize(
    "top_k,top_p",
    [([0] * B, [1.0] * B), ([1, 3, 7, 0, 40, 2], [1.0] * B),
     ([0] * B, [0.1, 0.5, 0.9, 0.99, 1.0, 0.3]), ([5, 0, 2, 9, 1, 3], [0.5, 0.8, 0.95, 0.3, 1.0, 0.6])],
    ids=["off", "top_k", "top_p", "both"],
)
def test_top_k_top_p_masks_match_jax(monkeypatch, top_k, top_p):
    # Scale 1 keeps every token's probability far above f32 rounding of
    # the cumulative sum near 1.0 (the two cumsums add in other orders).
    x = logits(2, scale=1.0)
    temp, top_k, top_p = knobs([0.7, 1.0, 1.3, 0.8, 2.0, 0.9], top_k, top_p)
    want = jax_mask(monkeypatch, x, temp, top_k, top_p)
    scaled = torch.from_numpy(x) / torch.from_numpy(temp)[:, None]
    got = torch.isfinite(
        top_k_top_p_filter(scaled, torch.from_numpy(top_k), torch.from_numpy(top_p))
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_seeded_noise_is_reproducible_and_stays_in_the_mask():
    x = torch.from_numpy(logits(3))
    temp, top_k, top_p = knobs([0.8] * B, [4] * B, [0.9] * B)
    seeds = np.arange(100, 100 + B, dtype=np.uint32)
    a, la = sample_tokens(x, temp, top_k, top_p, seeds)
    b, lb = sample_tokens(x, temp, top_k, top_p, seeds)
    assert torch.equal(a, b) and torch.equal(la, lb)
    allowed = torch.isfinite(top_k_top_p_filter(
        x / torch.from_numpy(temp)[:, None], torch.from_numpy(top_k),
        torch.from_numpy(top_p),
    ))
    assert allowed[torch.arange(B), a.long()].all()
    draws = {
        tuple(sample_tokens(x, temp, top_k, top_p, seeds + s)[0].tolist())
        for s in range(1, 9)
    }
    assert len(draws) > 1, "different seeds never changed a draw"


NOISE_SEEDS = [0, 1, 2**32 - 1, *np.random.default_rng(9).integers(0, 2**32, size=3).tolist()]


@pytest.mark.parametrize("vocab", [256, 128256])
def test_threefry_bits_equal_jax(vocab):
    seeds = torch.tensor(NOISE_SEEDS, dtype=torch.int64)
    got = threefry_bits(seeds, vocab).numpy()
    assert got.shape == (len(NOISE_SEEDS), vocab) and got.min() >= 0 and got.max() < 2**32
    for row, seed in zip(got, NOISE_SEEDS):
        want = jax.random.bits(jax.random.key(np.uint32(seed)), (vocab,), jnp.uint32)
        np.testing.assert_array_equal(row.astype(np.uint32), np.asarray(want))


@pytest.mark.parametrize("vocab", [256, 128256])
def test_gumbel_noise_matches_jax(vocab):
    """Within 1e-6 absolute plus two float32 ulps relative: the bits are
    equal, the two logarithms of either library may each round an ulp
    apart (an ulp is 9.5e-7 at the largest values, near 12)."""
    seeds = torch.tensor(NOISE_SEEDS, dtype=torch.int64)
    got = gumbel_noise(seeds, vocab).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    for row, seed in zip(got, NOISE_SEEDS):
        want = jax.random.gumbel(jax.random.key(np.uint32(seed)), (vocab,), jnp.float32)
        np.testing.assert_allclose(row, np.asarray(want), atol=1e-6, rtol=2.4e-7)


@pytest.mark.parametrize(
    "top_k,top_p",
    [([0] * B, [1.0] * B), ([5, 0, 2, 9, 1, 3], [0.5, 0.8, 0.95, 0.3, 1.0, 0.6])],
    ids=["off", "both"],
)
def test_sampled_tokens_equal_jax(top_k, top_p):
    """Seeded rows (and greedy rows beside them) with the masks set: the
    same numpy logits give JAX's tokens and logprobs."""
    temp, top_k, top_p = knobs([0.7, 1.0, 0.0, 0.8, 2.0, 0.9], top_k, top_p)
    for trial in range(8):
        x = logits(10 + trial, scale=1.0)
        seeds = np.random.default_rng(trial).integers(0, 2**32, size=B, dtype=np.uint32)
        jt, jl = jax_sample(x, temp, top_k, top_p, seeds)
        tt, tl = sample_tokens(torch.from_numpy(x), temp, top_k, top_p, seeds)
        np.testing.assert_array_equal(tt.numpy(), jt)
        np.testing.assert_allclose(tl.numpy(), jl, atol=1e-5, rtol=0)


def test_sample_tokens_takes_tensors_and_any_seed_shape():
    """The fused window hands over device tensors and one column of its
    [B, K] seed block: the result equals the arrays' path."""
    x = torch.from_numpy(logits(4))
    temp, top_k, top_p = knobs([0.8, 0.0] * 3, [4] * B, [0.9] * B)
    block = np.random.default_rng(5).integers(0, 2**32, size=(B, 3), dtype=np.uint32)
    want, want_lp = sample_tokens(x, temp, top_k, top_p, block[:, 1])
    got, got_lp = sample_tokens(
        x, torch.from_numpy(temp), torch.from_numpy(top_k), torch.from_numpy(top_p),
        torch.from_numpy(block.astype(np.int64))[:, 1],
    )
    assert torch.equal(got, want) and torch.equal(got_lp, want_lp)
    again, _ = sample_tokens(x, temp, top_k, top_p, block[:, 1:2])  # [B, 1]
    assert torch.equal(again, want)
