"""What surrounds the paged-attention kernels K1' and K3', on the CPU.

The tensor-core kernels (``ops/csrc/paged_attention.cuh``) run only on the
card; what decides their work is plain PyTorch and is held here:

- the flat step's query tiles (``flat_work_items``): every live token in
  exactly one tile, no tile across two rows or longer than Tq, pads in
  none, the list compacted and no longer than the grid the host sizes;
- the span cut (``span_pages``, ``spans_for``): a tile's live pages in
  exactly one span, for windows shorter and longer than the rows;
- the kernels' decomposition in plain PyTorch (``span_partials_plain``
  then ``merge_spans_plain``: per-span (m, l, acc), the sinks added at the
  merge, pads zero) against the plain versions and the JAX package's TPU
  kernels in interpret mode, on float and int8 pools with window, sinks
  and all three, in f32 at atol 1e-5;
- a numpy model of the P split: P rounded once to bf16 before P.V leaves
  outputs near zero outside ``chip_smoke.py``'s one-ulp bound, P as
  bf16 hi + lo does not.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llmd_tpu.ops.ragged_paged_attention import (
    decode_paged_attention_full as jax_decode_attention,
    flat_paged_attention_full as jax_flat_attention,
)
from llmd_tpu_torch import ops
from llmd_tpu_torch.ops import ragged_paged_attention as rpa

ATOL = 1e-5


def packed(rows_spec, pad, page, pad_row=None):
    """A flat step: (pos0, qlen) per row, its tokens contiguous, then
    ``pad`` pad tokens on row ``pad_row`` (the last row by default, as the
    runner's searchsorted leaves them). Returns rows, kv_lens, the page
    table (distinct pages per row) and the pool size in pages."""
    need = [-(-(p0 + w) // page) for p0, w in rows_spec]
    max_pages = max(need) + 1
    P = sum(need) + 3
    perm = np.random.default_rng(0).permutation(P)
    pt = np.zeros((len(rows_spec), max_pages), np.int32)
    rows, kv, off = [], [], 0
    for r, ((p0, w), n) in enumerate(zip(rows_spec, need)):
        pt[r, :n] = perm[off : off + n]
        off += n
        rows += [r] * w
        kv += range(p0 + 1, p0 + w + 1)
    rows += [len(rows_spec) - 1 if pad_row is None else pad_row] * pad
    kv += [0] * pad
    return np.asarray(rows, np.int32), np.asarray(kv, np.int32), pt, P


# The mix of tests/test_torch_cuda.py (chunks with and without a prefix,
# one across pages, decode rows) and chip_smoke.py's mixed step (3 chunks
# of 128-512 tokens and 32 decode rows at 1k-4k, padded to 16).
ROWS_MIX = ((0, 37), (45, 20), (130, 1), (7, 1), (250, 3), (0, 1))
SMOKE_MIX = ((0, 512), (1024, 256), (2000, 128)) + tuple(
    (c - 1, 1) for c in np.random.default_rng(5).integers(1024, 4097, 32).tolist())
MIXES = {"rows": (ROWS_MIX, 5), "smoke": (SMOKE_MIX, 0), "one_chunk": (((3072, 1024),), 0),
         "decode_only": (tuple((c, 1) for c in range(20, 52)), 16)}


@pytest.mark.parametrize("group", [1, 4, 8, 5, 32])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_flat_items_cover_every_live_token_once(mix, group):
    spec, pad = MIXES[mix]
    rows, kv_lens, pt, _ = packed(spec, pad, 16)
    T, R = len(rows), pt.shape[0]
    items = ops.flat_work_items(torch.from_numpy(rows), torch.from_numpy(kv_lens), group)
    assert items.shape == (T, 2) and items.dtype == torch.int32 and items.is_contiguous()
    tq = rpa.tile_tokens(group)
    assert tq * group <= 64
    n_items = int((items[:, 1] > 0).sum())
    assert (items[n_items:] == 0).all()  # compacted
    assert n_items <= rpa.flat_grid(T, R, group)  # the host-sized grid holds them
    covered = np.zeros(T, np.int32)
    for t0, n in items[:n_items].tolist():
        assert 1 <= n <= tq
        assert len(set(rows[t0 : t0 + n])) == 1  # one row a tile
        covered[t0 : t0 + n] += 1
    np.testing.assert_array_equal(covered, (kv_lens > 0).astype(np.int32))
    # Tiles start at their row's first token and every Tq tokens after.
    first = {}
    for t, r in enumerate(rows[: T - pad]):
        first.setdefault(r, t)
    for t0, _ in items[:n_items].tolist():
        assert (t0 - first[rows[t0]]) % tq == 0


def test_flat_items_split_rows_that_are_not_contiguous():
    """A row whose tokens are split by another row's, or by a pad, gets a
    tile per run: still every live token once, one row a tile."""
    rows = torch.tensor([0, 0, 1, 0, 0, 2, 2, 2], dtype=torch.int32)
    kv_lens = torch.tensor([1, 2, 5, 3, 4, 0, 7, 8], dtype=torch.int32)
    items = ops.flat_work_items(rows, kv_lens, 32)  # Tq = 2
    assert items[:5].tolist() == [[0, 2], [2, 1], [3, 2], [6, 2], [0, 0]]


WINDOWS = (0, 3, 40, 5000)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("spans", [1, 2, 3, 7, 16])
@pytest.mark.parametrize("page", [8, 16, 32])
def test_spans_cover_the_live_pages_once(page, spans, window):
    """Each tile's in-window pages, cut into ``spans`` runs, are covered
    exactly once, in order, for windows shorter and longer than the row."""
    for kv_len in (1, 15, 16, 17, 100, 1000, 8192):
        lo = max(kv_len - window, 0) if window else 0
        cut = rpa.span_pages(lo, kv_len, page, spans)
        assert len(cut) == spans
        pages = [p for b, e in cut for p in range(b, e)]
        assert pages == list(range(lo // page, -(-kv_len // page)))
        assert all(b <= e for b, e in cut)


def test_span_counts_follow_the_host_sizes():
    assert rpa.spans_for(64 * 8, 512, 132) == 2  # the smoke's decode batch
    assert rpa.spans_for(8 * 8, 512, 132) == 9  # 8 rows fill the card
    assert rpa.spans_for(8 * 8, 40, 132) == 3  # no span under 16 pages
    assert rpa.spans_for(8 * 8, 4, 132) == 1
    assert rpa.spans_for(1, 8192, 132) == 16  # at most 16
    assert rpa.spans_for(93 * 8, 256, 132) == 1  # the smoke's mixed step
    # A sliding window of 128 at page 16 bounds a query to 10 pages.
    assert rpa.live_pages_bound(512, 16, 128) == 10
    assert rpa.live_pages_bound(512, 16, 0) == 512
    assert rpa.live_pages_bound(4, 16, 128) == 4
    assert rpa.spans_for(64 * 8, rpa.live_pages_bound(8192, 16, 128), 132) == 1
    assert rpa.flat_grid(928, 35, 4) == 58 + 35
    assert rpa.flat_grid(32, 64, 8) == 32  # never more than T


# --------------------------------------------------------------------- #
# The kernels' decomposition: span partials, then the merge.

L, K, G = 2, 2, 4
# name -> (window, sinks, int8 pool)
VARIANTS = {
    "plain": (0, False, False),
    "window": (7, False, False),
    "sinks": (0, True, False),
    "int8": (0, False, True),
    "all": (7, True, True),
}
FLAT_ROWS = ((3, 5), (9, 1), (0, 11), (22, 1), (30, 19))


def pool(rng, P, page, D, int8):
    if not int8:
        return rng.normal(size=(L, P, K, page, 2 * D)).astype(np.float32), None
    data = rng.integers(-127, 128, size=(L, P, K, page, 2 * D)).astype(np.int8)
    scales = rng.uniform(0.004, 0.016, size=(L, P, K, page, 2)).astype(np.float16).astype(np.float32)
    return data, scales


def t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def inputs(rng, variant, P, page, D, T):
    window, with_sinks, int8 = VARIANTS[variant]
    data, scales = pool(rng, P, page, D, int8)
    q = rng.normal(size=(T, 1, K * G, D)).astype(np.float32)
    sinks = rng.normal(size=(K * G,)).astype(np.float32) if with_sinks else None
    return window, data, scales, q, sinks


@pytest.mark.parametrize("spans", [1, 3])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flat_span_merge_matches_plain(variant, spans):
    """The flat decomposition (tiles of Tq = 16 tokens at G = 4, spans of
    each tile's pages) equals ``flat_paged_attention_plain``."""
    rng = np.random.default_rng(31)
    page, D = 4, 64
    rows, kv_lens, pt, P = packed(FLAT_ROWS, 3, page)
    window, data, scales, q, sinks = inputs(rng, variant, P, page, D, len(rows))
    args = (t(q), t(data), 1, t(rows), t(pt), t(kv_lens))
    want = ops.flat_paged_attention_plain(*args, None, window, t(sinks), t(scales))
    items = ops.flat_work_items(t(rows), t(kv_lens), G)
    m, l, acc = rpa.span_partials_plain(*args, items, spans, None, window, t(scales))
    got = rpa.merge_spans_plain(m, l, acc, t(kv_lens), t(sinks))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    assert not got[kv_lens == 0].any()


DECODE_LENS = (8, 23, 0, 1, 32, 3, 0, 61)


@pytest.mark.parametrize("spans", [1, 2, 5])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_span_merge_matches_plain(variant, spans):
    """The decode decomposition (each row a tile of one token, its pages
    in spans) equals ``decode_paged_attention_plain``; pad rows are zero
    with sinks too."""
    rng = np.random.default_rng(32)
    page, D = 4, 64
    kv_lens = np.asarray(DECODE_LENS, np.int32)
    B = len(kv_lens)
    max_pages = -(-int(kv_lens.max()) // page) + 1
    P = B * max_pages + 2
    pt = rng.permutation(P)[: B * max_pages].reshape(B, max_pages).astype(np.int32)
    window, data, scales, q, sinks = inputs(rng, variant, P, page, D, B)
    want = ops.decode_paged_attention_plain(
        t(q), t(data), 1, t(pt), t(kv_lens), None, None, window, t(sinks), t(scales))
    items = torch.stack([torch.arange(B), torch.ones(B, dtype=torch.long)], 1).int()
    m, l, acc = rpa.span_partials_plain(
        t(q), t(data), 1, torch.arange(B), t(pt), t(kv_lens), items, spans, None, window,
        t(scales))
    got = rpa.merge_spans_plain(m, l, acc, t(kv_lens), t(sinks))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    assert not got[kv_lens == 0].any()


# The interpret-mode TPU kernel compiles anew for each case (seconds a
# case on the CPU): plain and all three branches on float and int8 pools.
JAX_CASES = ["plain", "all", "sinks", "int8"]


@pytest.mark.parametrize("variant", JAX_CASES)
def test_span_merge_matches_the_tpu_kernels(variant):
    """The decomposition against the JAX package's flat and decode
    kernels in interpret mode, on the same numpy inputs."""
    rng = np.random.default_rng(33)
    page, D = 4, 64
    rows, kv_lens, pt, P = packed(FLAT_ROWS, 3, page)
    window, data, scales, q, sinks = inputs(rng, variant, P, page, D, len(rows))
    items = ops.flat_work_items(t(rows), t(kv_lens), G)
    m, l, acc = rpa.span_partials_plain(
        t(q), t(data), 1, t(rows), t(pt), t(kv_lens), items, 3, None, window, t(scales))
    got = rpa.merge_spans_plain(m, l, acc, t(kv_lens), t(sinks)).numpy()
    jw = jnp.int32(window) if window else None
    js = None if sinks is None else jnp.asarray(sinks)
    jsc = None if scales is None else jnp.asarray(scales)
    flat = jax_flat_attention(
        jnp.asarray(q), jnp.asarray(data), jnp.int32(1), jnp.asarray(rows), jnp.asarray(pt),
        jnp.asarray(kv_lens), interpret=True, window=jw, sinks=js, scales=jsc)
    live = kv_lens > 0
    np.testing.assert_allclose(got[live], np.asarray(flat)[live], atol=ATOL, rtol=0)
    assert not got[~live].any()
    # The decode entry: the flat step's last token of each row as a batch.
    last = [int(np.nonzero(rows[: live.sum()] == r)[0][-1]) for r in range(len(FLAT_ROWS))]
    dq, dlens, dpt = q[last], kv_lens[last], pt[rows[last]]
    B = len(last)
    ditems = torch.stack([torch.arange(B), torch.ones(B, dtype=torch.long)], 1).int()
    m, l, acc = rpa.span_partials_plain(
        t(dq), t(data), 1, torch.arange(B), t(dpt), t(dlens), ditems, 2, None, window,
        t(scales))
    dgot = rpa.merge_spans_plain(m, l, acc, t(dlens), t(sinks)).numpy()
    dec = jax_decode_attention(
        jnp.asarray(dq), jnp.asarray(data), jnp.int32(1), jnp.asarray(dpt), jnp.asarray(dlens),
        interpret=True, window=jw, sinks=js, scales=jsc)
    np.testing.assert_allclose(dgot, np.asarray(dec), atol=ATOL, rtol=0)


# --------------------------------------------------------------------- #
# Why P is split into two terms.


def bf16(x):
    """Round-to-nearest-even to bfloat16, in f32 (numpy has no bf16)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def test_p_split_keeps_outputs_within_one_ulp():
    """chip_smoke.py's decode step: scores of bf16 q . k (D 128, unit
    normal) at 1k-4k positions, V unit normal in bf16. The output of
    P.V / l is rounded to bf16 and held to the f32 reference within
    2e-5 + 2^-7 |ref| (chip_smoke.py's BF16_ATOL + BF16_ULP). With P
    rounded once to bf16 many heads fall outside it; with P = hi + lo
    (each bf16, the products summed in f32) none does."""
    rng = np.random.default_rng(7)
    D, heads = 128, 64
    bad_once = bad_split = 0
    for n in (1024, 2500, 4096):
        q = bf16(rng.normal(size=(heads, D)))
        k = bf16(rng.normal(size=(n, D)))
        v = bf16(rng.normal(size=(n, D)))
        s = (q @ k.T) * D**-0.5
        p = np.exp(s - s.max(axis=1, keepdims=True)).astype(np.float32)
        l = p.sum(axis=1, keepdims=True)
        ref = (p.astype(np.float64) @ v) / l
        bound = 2e-5 + 2.0**-7 * np.abs(ref)
        once = bf16((bf16(p).astype(np.float64) @ v) / l)
        hi = bf16(p)
        lo = bf16(p - hi)
        split = bf16(((hi.astype(np.float64) + lo) @ v) / l)
        bad_once += int((np.abs(once - ref) > bound).sum())
        bad_split += int((np.abs(split - ref) > bound).sum())
        # hi + lo keeps P to about 2^-16 of its value.
        assert np.max(np.abs(hi + lo - p) / np.maximum(p, 1e-30)) <= 2.0**-16
    assert bad_split == 0
    assert bad_once > 0.01 * 3 * heads * D
