"""The plans of the MoE grouped GEMM (K6') and the latent decode attention
(K5') in plain PyTorch, against the JAX package, on the CPU.

- The work map of K6' (``grouped_tiles``, which the kernel's in-kernel scan
  mirrors): every (row, column tile) of the output in exactly one item, no
  item across two groups, none for an empty group, no more items than the
  host sizes the grid for (hypothesis).
- The gate|up pair's plain version against two calls of JAX's
  ``grouped_matmul`` in ``megablox.gmm``'s interpret mode
  (``LLMD_PALLAS=interpret``) and on its XLA path (``lax.ragged_dot``), at
  H and F of 128 and 256; the expert MLP (pair, gpt-oss biases, clamped
  SwiGLU, down) against JAX's ``expert_mlp_grouped`` on both paths.
- The decomposition of K5' (head groups x spans, partials, merge) against JAX's
  ``mla_decode_paged_attention_full`` in interpret mode at 16, 20 and 128
  heads, with NaN past kv_len and pad rows.

f32 throughout. Tolerances: the XLA path 2e-5 (matmul order); the
interpret gmm kernel 2e-4 (it tiles the contraction, as
``tests/test_torch_moe.py`` holds it); the latent attention 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import llmd_tpu.config as jcfg
import llmd_tpu_torch.config as tcfg
from llmd_tpu.ops.grouped_gemm import expert_mlp_grouped as jax_expert_mlp_grouped
from llmd_tpu.ops.grouped_gemm import grouped_matmul as jax_grouped_matmul
from llmd_tpu.ops.mla_decode import mla_decode_paged_attention_full as jax_mla_decode
from llmd_tpu_torch.ops import grouped_gemm as gg
from llmd_tpu_torch.ops import mla_decode as md


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@settings(max_examples=200, deadline=None)
@given(
    sizes=st.lists(st.integers(0, 300), min_size=1, max_size=70),
    bm=st.sampled_from([64, 128]),
    ncols=st.integers(1, 12),
    cut=st.integers(0, 40),
)
def test_grouped_tiles_cover_every_output_tile_once(sizes, bm, ncols, cut):
    """The work map on group layouts with empty groups, groups of exactly
    BM and BM + 1 rows, and sizes that run past M (the kernel cuts at M)."""
    M = max(sum(sizes) - cut, 0)
    items = gg.grouped_tiles(torch.tensor(sizes, dtype=torch.int32), M, bm, ncols)
    assert items.shape[0] <= gg.max_items(M, len(sizes), bm, ncols)
    ends = np.cumsum(sizes)
    starts = ends - np.asarray(sizes)
    cover = np.zeros((M, ncols), np.int64)
    for g, row0, rows, col in items.tolist():
        assert sizes[g] > 0 and 0 < rows <= bm and 0 <= col < ncols
        assert starts[g] <= row0 and row0 + rows <= min(ends[g], M)  # one group, cut at M
        cover[row0 : row0 + rows, col] += 1
    assert (cover == 1).all()
    # Row tile major: the kernel's item i is row tile i // ncols, column i % ncols.
    assert items[:, 3].tolist() == list(range(ncols)) * (items.shape[0] // ncols)


def test_tile_choice_reads_only_m_and_g():
    assert gg.tile_choice(288, 64) in gg.TILES  # a deepseek-v2-lite decode step
    assert gg.TILES[gg.tile_choice(6144, 64)][0] == 128  # its 1,024-token prefill step


SIZES = (5, 0, 37, 20)


@pytest.mark.parametrize("path", ["interpret", "xla"])
@pytest.mark.parametrize("H,F", [(128, 256), (256, 128)])
def test_grouped_matmul_pair_plain_matches_two_jax_calls(monkeypatch, path, H, F):
    rng = np.random.default_rng(H + F)
    M, G = sum(SIZES), len(SIZES)
    x = rng.standard_normal((M, H)).astype(np.float32)
    wa, wb = ((rng.standard_normal((G, H, F)) * H**-0.5).astype(np.float32) for _ in range(2))
    sizes = np.asarray(SIZES, np.int32)
    monkeypatch.setenv("LLMD_PALLAS", "interpret" if path == "interpret" else "off")
    want = [np.asarray(jax_grouped_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes)))
            for w in (wa, wb)]
    got = gg.grouped_matmul_pair_plain(t(x), t(wa), t(wb), t(sizes))
    tol = 2e-4 if path == "interpret" else 2e-5
    for g, w in zip(got, want):
        assert g.shape == (M, F) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol)
    # On the CPU the pair wrapper is its plain version.
    for g, w in zip(gg.grouped_matmul_pair(t(x), t(wa), t(wb), t(sizes)), got):
        assert torch.equal(g, w)


OSS_MOE = dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=128,
               hidden_size=128, num_heads=4, num_kv_heads=2, intermediate_size=128,
               moe_activation="swiglu_oss", router_logit_bias=True, swiglu_limit=1.5)


@pytest.mark.parametrize("path", ["interpret", "xla"])
def test_expert_mlp_with_biases_and_clamped_glu_matches_jax(monkeypatch, path):
    """gpt-oss's expert MLP at a lane-tiled width (H = F = 128, where JAX
    runs the gmm kernel): gate|up as one pair call, the per-expert biases,
    the clamped SwiGLU and down, against JAX's three calls."""
    jc, tc = jcfg.tiny_model_config(**OSS_MOE), tcfg.tiny_model_config(**OSS_MOE)
    rng = np.random.default_rng(12)
    E, H, F = 4, 128, 128
    sizes = np.asarray(SIZES, np.int32)
    x = rng.standard_normal((sizes.sum(), H)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.3).astype(np.float32) for s in ((E, H, F), (E, H, F), (E, F, H))]
    bs = [(rng.standard_normal(s) * 0.5).astype(np.float32) for s in ((E, F), (E, F), (E, H))]
    monkeypatch.setenv("LLMD_PALLAS", "interpret" if path == "interpret" else "off")
    want = jax_expert_mlp_grouped(
        jnp.asarray(x), jnp.asarray(sizes), *(jnp.asarray(w) for w in ws),
        biases=tuple(jnp.asarray(b) for b in bs), cfg=jc)
    got = gg.expert_mlp_grouped(
        t(x), t(sizes), *(t(w) for w in ws), biases=tuple(t(b) for b in bs), cfg=tc,
        expert_ids=t(np.repeat(np.arange(E), sizes)))
    tol = 2e-4 if path == "interpret" else 2e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def latent_case(H, seed=4):
    """A decode batch over a latent pool [2, P, 1, 8, 128]: rows at 1, 0 (a
    pad row), 17, 100 and 0 positions on distinct pages, NaN at every
    position past a row's kv_len on its live pages."""
    rng = np.random.default_rng(seed)
    page, Dl = 8, 128
    kv_lens = np.asarray([1, 0, 17, 100, 0], np.int32)
    need = -(-kv_lens // page)
    max_pages = 16
    P = int(need.sum()) + 3
    perm = rng.permutation(P)
    pt = np.zeros((len(kv_lens), max_pages), np.int32)
    off = 0
    for b, n in enumerate(need):
        pt[b, :n] = perm[off : off + n]
        off += n
    pool = rng.standard_normal((2, P, 1, page, Dl)).astype(np.float32)
    for b, n in enumerate(kv_lens):
        for i in range(n, need[b] * page):
            pool[:, pt[b, i // page], 0, i % page] = np.nan
    q = rng.standard_normal((len(kv_lens), 1, H, Dl)).astype(np.float32)
    return q, pool, pt, kv_lens


@pytest.mark.parametrize("H", [16, 20, 128])
def test_latent_decomposition_matches_the_tpu_kernel(H):
    """Head groups of the kernel's size (16 heads up to 16, else 32; the
    one group at 20 partial) x spans of equal page chunks:
    partials, then the merge, against JAX's interpret-mode Pallas kernel;
    pad rows are zero and the NaN past kv_len never enters a sum."""
    q, pool, pt, kv_lens = latent_case(H)
    rank, scale = 64, 0.09
    want = np.asarray(jax_mla_decode(
        jnp.asarray(q), jnp.asarray(pool), jnp.int32(1), jnp.asarray(pt), jnp.asarray(kv_lens),
        rank=rank, sm_scale=scale, interpret=True))
    group = md.heads_per_block(H, torch.bfloat16)
    assert group == (16 if H <= 16 else 32)
    # One span a row; at most 3; and the chunks the wrapper's target gives
    # on a card of 132 SMs (several spans for the longest row, one for the
    # shortest).
    for spans, target in ((1, 1), (3, 2), (md.spans_for(pt.shape[1]), 132)):
        m, l, acc = md.mla_span_partials_plain(
            t(q), t(pool), 1, t(pt), t(kv_lens), rank, scale, spans, group, target)
        got = md.mla_merge_spans_plain(m, l, acc)
        assert got.shape == (len(kv_lens), 1, H, rank) and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        assert not got[t(kv_lens) == 0].any()
