"""The port's ops against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, go through the port's plain
PyTorch versions and through the JAX functions: the XLA fallbacks of
``llmd_tpu.ops`` and the Pallas kernels in interpret mode (Pallas-legal
geometry: page 8, head_dim 128). This holds for the flat step's pair, for
the decode pair (one token per row, pad rows included) and for the plain
``[B, Q]`` functions that serve ``Q > 1``. The KV writes are exact;
attention holds to atol 1e-5 (f32, different summation order).
"""

import importlib
import shutil
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llmd_tpu.ops as jops
from llmd_tpu.engine.runner import ModelRunner as JaxRunner
from llmd_tpu.ops.kv_write import write_kv_pages_decode as jax_decode_write_1l
from llmd_tpu.ops.kv_write import write_kv_pages_decode_full as jax_decode_write
from llmd_tpu.ops.kv_write import write_kv_pages_flat_full as jax_flat_write
from llmd_tpu.ops.ragged_paged_attention import (
    decode_paged_attention as jax_decode_attention_1l,
    decode_paged_attention_full as jax_decode_attention,
    flat_paged_attention_full as jax_flat_attention,
)
from llmd_tpu_torch import ops

# ``llmd_tpu.ops.paged_attention`` the attribute is a function of the same
# name; the module comes from the import system.
jpa = importlib.import_module("llmd_tpu.ops.paged_attention")

L, P, K, PAGE, D = 2, 24, 2, 8, 128

# (pos0, qlen) per row: prefill chunks with a prefix, chunks that straddle
# pages, one-token decode rows.
LAYOUTS = {
    "mixed": ((3, 5), (9, 1), (0, 11)),
    "straddle": ((3, 11), (17, 1), (0, 5)),
    "decode": ((7, 1), (15, 1), (0, 1), (22, 1)),
}


def flat_step(rows_spec, pad=3):
    """Packed stream of the rows: live tokens first, then ``pad`` pads;
    per-row metadata as the engine stages it (pad rows: row_start =
    total)."""
    B = len(rows_spec) + 2
    row_start = np.zeros(B, np.int32)
    pos0 = np.zeros(B, np.int32)
    qlens = np.zeros(B, np.int32)
    tok_rows, positions = [], []
    t = 0
    for r, (p0, w) in enumerate(rows_spec):
        row_start[r], pos0[r], qlens[r] = t, p0, w
        tok_rows += [r] * w
        positions += range(p0, p0 + w)
        t += w
    row_start[len(rows_spec):] = t
    total = t
    tok_rows += [len(rows_spec) - 1] * pad
    positions += [0] * pad
    positions = np.asarray(positions, np.int32)
    live = np.arange(total + pad) < total
    return SimpleNamespace(
        B=B, T=total + pad, total=total, num_live=np.asarray([total], np.int32),
        row_start=row_start, pos0=pos0,
        qlens=qlens, rows=np.asarray(tok_rows, np.int32), positions=positions,
        live=live, kv_lens=np.where(live, positions + 1, 0).astype(np.int32),
    )


def page_table(rng, B, max_pages=4):
    return rng.permutation(P)[: B * max_pages].reshape(B, max_pages).astype(np.int32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_flat_write_matches_jax_xla(layout):
    rng = np.random.default_rng(0)
    s = flat_step(LAYOUTS[layout])
    pt = page_table(rng, s.B)
    cache = rng.normal(size=(L, P, K, PAGE, 2 * D)).astype(np.float32)
    k = rng.normal(size=(s.T, 1, K, D)).astype(np.float32)
    v = rng.normal(size=(s.T, 1, K, D)).astype(np.float32)
    want = jops.write_kv_pages_full_flat(
        jnp.asarray(cache), jnp.int32(1), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pt), jnp.asarray(s.rows), jnp.asarray(s.positions[:, None]),
        jnp.asarray(s.live[:, None]), None,
    )
    got = ops.write_kv_pages_flat_plain(
        t(cache), 1, t(k), t(v), t(pt), t(s.rows), t(s.positions), t(s.num_live)
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_flat_write_matches_pallas_interpret(layout):
    """Against the TPU kernel itself, fed the run plan the JAX runner
    builds (``ModelRunner._fill_flat_runs``)."""
    rng = np.random.default_rng(1)
    s = flat_step(LAYOUTS[layout])
    pt = page_table(rng, s.B)
    cache = rng.normal(size=(L, P, K, PAGE, 2 * D)).astype(np.float32)
    k = rng.normal(size=(s.T, 1, K, D)).astype(np.float32)
    v = rng.normal(size=(s.T, 1, K, D)).astype(np.float32)
    a = {"row_start": s.row_start, "pos0": s.pos0, "qlens": s.qlens,
         "page_table": pt}
    staged = SimpleNamespace(B=s.B, T=s.T, row_seqs=[None] * (s.B - 2))
    JaxRunner._fill_flat_runs(SimpleNamespace(page=PAGE), staged, a)
    kv_new = np.concatenate([k, v], axis=-1).reshape(s.T, K, 2 * D)
    want = jax_flat_write(
        jnp.asarray(cache), jnp.asarray(kv_new), jnp.int32(0),
        jnp.asarray(a["wsrc"]), jnp.asarray(a["wphys"]),
        jnp.asarray(a["woff"]), jnp.asarray(a["wcnt"]), interpret=True,
    )
    got = ops.write_kv_pages_flat_plain(
        t(cache), 0, t(k), t(v), t(pt), t(s.rows), t(s.positions), t(s.num_live)
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_flat_attention_matches_jax(layout):
    """Live tokens against the XLA fallback and the interpret-mode Pallas
    kernel (atol 1e-5: f32 both sides, summation order differs)."""
    rng = np.random.default_rng(2)
    G = 3
    s = flat_step(LAYOUTS[layout])
    pt = page_table(rng, s.B)
    cache = rng.normal(size=(L, P, K, PAGE, 2 * D)).astype(np.float32)
    q = rng.normal(size=(s.T, 1, K * G, D)).astype(np.float32)
    got = ops.flat_paged_attention_plain(
        t(q), t(cache), 1, t(s.rows), t(pt), t(s.kv_lens)
    ).numpy()
    xla = jops.paged_attention_full_flat(
        jnp.asarray(q), jnp.asarray(cache), jnp.int32(1), jnp.asarray(s.rows),
        jnp.asarray(pt), jnp.asarray(s.kv_lens), jnp.asarray(s.positions[:, None]),
    )
    pallas = jax_flat_attention(
        jnp.asarray(q), jnp.asarray(cache), jnp.int32(1), jnp.asarray(s.rows),
        jnp.asarray(pt), jnp.asarray(s.kv_lens), interpret=True,
    )
    live = s.live
    np.testing.assert_allclose(got[live], np.asarray(xla)[live], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[live], np.asarray(pallas)[live], atol=1e-5, rtol=0)
    # Pads (kv_len 0) come out as zeros, as the kernels write them.
    assert not got[~live].any()


# kv_len per row of a decode batch: 0 marks a pad row (valid = 0).
DECODE_BATCHES = {
    "mixed": (8, 23, 0, 1, 32, 0),
    "one_page": (3, 8, 1, 5),
    "pads_first": (0, 0, 17, 9),
}


def decode_step(rng, kv_lens, max_pages=4):
    """One decode step's addressing: each live row writes position
    kv_len - 1; pad rows carry a garbage page and slot."""
    kv_lens = np.asarray(kv_lens, np.int32)
    B = len(kv_lens)
    pt = page_table(rng, B, max_pages)
    valid = (kv_lens > 0).astype(np.int32)
    pos = np.maximum(kv_lens - 1, 0)
    phys = pt[np.arange(B), pos // PAGE].astype(np.int32)
    offset = (pos % PAGE).astype(np.int32)
    phys[valid == 0] = 10_000  # never dereferenced
    return SimpleNamespace(B=B, kv_lens=kv_lens, pt=pt, valid=valid, pos=pos,
                           phys=phys, offset=offset)


@pytest.mark.parametrize("batch", sorted(DECODE_BATCHES))
def test_decode_write_matches_jax(batch):
    """K4's plain version against the TPU kernel in interpret mode and the
    XLA scatter; exact, and pad rows leave the pool untouched."""
    rng = np.random.default_rng(4)
    s = decode_step(rng, DECODE_BATCHES[batch])
    cache = rng.normal(size=(L, P, K, PAGE, 2 * D)).astype(np.float32)
    kv_new = rng.normal(size=(s.B, K, 2 * D)).astype(np.float32)
    phys_j = np.where(s.valid == 1, s.phys, 0).astype(np.int32)
    pallas = jax_decode_write(
        jnp.asarray(cache), jnp.asarray(kv_new), jnp.int32(1), jnp.asarray(phys_j),
        jnp.asarray(s.offset), jnp.asarray(s.valid), interpret=True,
    )
    xla = jpa.write_kv_pages(
        jnp.asarray(cache[1]), jnp.asarray(kv_new[:, None, :, :D]),
        jnp.asarray(kv_new[:, None, :, D:]), jnp.asarray(s.pt),
        jnp.asarray(s.pos[:, None]), jnp.asarray(s.valid[:, None].astype(bool)),
    )
    got = ops.write_kv_pages_decode_plain(
        t(cache), t(kv_new), 1, t(s.phys), t(s.offset), t(s.valid)
    ).numpy()
    np.testing.assert_array_equal(got, np.asarray(pallas))
    np.testing.assert_array_equal(got[1], np.asarray(xla))
    np.testing.assert_array_equal(got[0], cache[0])
    # The single-layer entry writes the same bytes into a one-layer pool.
    one = ops.write_kv_pages_decode(
        t(cache[1]), t(kv_new), t(s.phys), t(s.offset), t(s.valid)
    ).numpy()
    np.testing.assert_array_equal(one, got[1])
    np.testing.assert_array_equal(one, np.asarray(jax_decode_write_1l(
        jnp.asarray(cache[1]), jnp.asarray(kv_new), jnp.asarray(phys_j),
        jnp.asarray(s.offset), jnp.asarray(s.valid), interpret=True,
    )))


@pytest.mark.parametrize("batch", sorted(DECODE_BATCHES))
def test_decode_attention_matches_jax(batch):
    """K3's plain version against the TPU kernel in interpret mode and the
    XLA attention (atol 1e-5: f32 both sides, summation order differs).
    Pad rows come out as zeros; the pool past each row's kv_len is NaN, so
    a dead position that entered a sum would show."""
    rng = np.random.default_rng(5)
    G = 2
    s = decode_step(rng, DECODE_BATCHES[batch])
    cache = rng.normal(size=(L, P, K, PAGE, 2 * D)).astype(np.float32)
    q = rng.normal(size=(s.B, 1, K * G, D)).astype(np.float32)
    pallas = jax_decode_attention(
        jnp.asarray(q), jnp.asarray(cache), jnp.int32(1), jnp.asarray(s.pt),
        jnp.asarray(s.kv_lens), interpret=True,
    )
    xla = jpa.paged_attention_xla(
        jnp.asarray(q), jnp.asarray(cache[1]), jnp.asarray(s.pt),
        jnp.asarray(s.kv_lens), jnp.asarray(s.pos[:, None]),
    )
    poisoned = cache.copy()
    for b, n in enumerate(s.kv_lens):
        for i in range(n, s.pt.shape[1] * PAGE):
            poisoned[:, s.pt[b, i // PAGE], :, i % PAGE] = np.nan
    got = ops.decode_paged_attention_plain(
        t(q), t(poisoned), 1, t(s.pt), t(s.kv_lens)
    ).numpy()
    live = s.kv_lens > 0
    np.testing.assert_allclose(got[live], np.asarray(pallas)[live], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[live], np.asarray(xla)[live], atol=1e-5, rtol=0)
    assert not got[~live].any() and not np.asarray(pallas)[~live].any()
    # A bounded gather (live_pages) and the single-layer entry agree.
    bounded = ops.decode_paged_attention_plain(
        t(q), t(poisoned), 1, t(s.pt), t(s.kv_lens),
        live_pages=-(-int(s.kv_lens.max()) // PAGE),
    ).numpy()
    np.testing.assert_allclose(bounded, got, atol=1e-6, rtol=0)
    one = ops.decode_paged_attention(t(q), t(poisoned[1]), t(s.pt), t(s.kv_lens)).numpy()
    np.testing.assert_array_equal(one, got)
    np.testing.assert_allclose(one[live], np.asarray(jax_decode_attention_1l(
        jnp.asarray(q), jnp.asarray(cache[1]), jnp.asarray(s.pt),
        jnp.asarray(s.kv_lens), interpret=True,
    ))[live], atol=1e-5, rtol=0)


# (start, qlen) per row of a bucketed [B, Q] step; qlen 0 is a pad row.
BUCKETED = {
    "prefill": ((0, 11), (3, 5), (9, 1), (0, 0)),
    "straddle": ((5, 12), (16, 7), (0, 3)),
}


def bucketed_step(rows_spec):
    B = len(rows_spec)
    Q = max(w for _, w in rows_spec)
    positions = np.zeros((B, Q), np.int32)
    qlens = np.zeros(B, np.int32)
    kvlens = np.zeros(B, np.int32)
    for i, (p0, w) in enumerate(rows_spec):
        positions[i, :w] = np.arange(p0, p0 + w)
        positions[i, w:] = p0 + max(w - 1, 0)
        qlens[i], kvlens[i] = w, (p0 + w if w else 0)
    valid = np.arange(Q)[None, :] < qlens[:, None]
    return SimpleNamespace(B=B, Q=Q, positions=positions, qlens=qlens,
                           kvlens=kvlens, valid=valid)


@pytest.mark.parametrize("layout", sorted(BUCKETED))
def test_bucketed_write_matches_jax(layout):
    rng = np.random.default_rng(6)
    s = bucketed_step(BUCKETED[layout])
    pt = page_table(rng, s.B)
    cache = rng.normal(size=(P, K, PAGE, 2 * D)).astype(np.float32)
    k = rng.normal(size=(s.B, s.Q, K, D)).astype(np.float32)
    v = rng.normal(size=(s.B, s.Q, K, D)).astype(np.float32)
    want = jpa.write_kv_pages(
        jnp.asarray(cache), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
        jnp.asarray(s.positions), jnp.asarray(s.valid),
    )
    got = ops.write_kv_pages(t(cache), t(k), t(v), t(pt), t(s.positions), t(s.valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("form", ["dense", "blocked"])
@pytest.mark.parametrize("layout", sorted(BUCKETED))
def test_bucketed_attention_matches_jax(layout, form):
    """``paged_attention_xla`` and ``_blocked`` (2 pages a block, so the
    online softmax carries across blocks) against their JAX namesakes on
    the live tokens, atol 1e-5."""
    rng = np.random.default_rng(7)
    G = 2
    s = bucketed_step(BUCKETED[layout])
    pt = page_table(rng, s.B)
    cache = rng.normal(size=(P, K, PAGE, 2 * D)).astype(np.float32)
    q = rng.normal(size=(s.B, s.Q, K * G, D)).astype(np.float32)
    args = (q, cache, pt, s.kvlens, s.positions)
    if form == "dense":
        want = jpa.paged_attention_xla(*map(jnp.asarray, args))
        got = ops.paged_attention_xla(*map(t, args))
    else:
        want = jpa.paged_attention_xla_blocked(*map(jnp.asarray, args), block_pages=2)
        got = ops.paged_attention_xla_blocked(*map(t, args), block_pages=2)
    np.testing.assert_allclose(
        got.numpy()[s.valid], np.asarray(want)[s.valid], atol=1e-5, rtol=0
    )


@pytest.mark.parametrize("Q", [1, 6])
def test_bucketed_entries_follow_the_jax_dispatch_rule(Q, monkeypatch):
    """``write_kv_pages_full`` / ``paged_attention_full``: Q == 1 goes to
    the decode pair, Q > 1 to the plain [B, Q] functions, with the dense
    form up to 4,096 gathered positions and the blocked form above; the
    results equal the JAX entries' on the same inputs."""
    rng = np.random.default_rng(8)
    G = 2
    s = bucketed_step(((7, Q), (2, Q), (0, 0)) if Q > 1 else ((7, 1), (22, 1), (0, 0)))
    pt = page_table(rng, s.B)
    cache = rng.normal(size=(L, P, K, PAGE, 2 * D)).astype(np.float32)
    q = rng.normal(size=(s.B, s.Q, K * G, D)).astype(np.float32)
    k = rng.normal(size=(s.B, s.Q, K, D)).astype(np.float32)
    v = rng.normal(size=(s.B, s.Q, K, D)).astype(np.float32)
    taken = []
    for name in ("write_kv_pages_decode_full", "decode_paged_attention_full",
                 "write_kv_pages", "paged_attention_xla", "paged_attention_xla_blocked"):
        def spy(*a, _fn=getattr(ops, name), _name=name, **kw):
            taken.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    pool = ops.write_kv_pages_full(
        t(cache), 1, t(k), t(v), t(pt), t(s.positions), t(s.valid)
    )
    out = ops.paged_attention_full(
        t(q), pool, 1, t(pt), t(s.kvlens), t(s.positions),
        live_pages=-(-int(s.kvlens.max()) // PAGE),
    )
    want_pool = jops.write_kv_pages_full(
        jnp.asarray(cache), jnp.int32(1), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pt), jnp.asarray(s.positions), jnp.asarray(s.valid),
    )
    want = jops.paged_attention_full(
        jnp.asarray(q), want_pool, jnp.int32(1), jnp.asarray(pt),
        jnp.asarray(s.kvlens), jnp.asarray(s.positions),
    )
    np.testing.assert_array_equal(pool.numpy(), np.asarray(want_pool))
    live = s.qlens > 0
    np.testing.assert_allclose(
        out.numpy()[s.valid], np.asarray(want)[s.valid], atol=1e-5, rtol=0
    )
    if Q == 1:
        assert taken == ["write_kv_pages_decode_full", "decode_paged_attention_full"]
        assert not out.numpy()[~live].any()
    else:
        assert taken == ["write_kv_pages", "paged_attention_xla"]
    taken.clear()
    # The table's full width (4 pages = 32 positions) decides the form, as
    # in the JAX package, not the 2 live pages the gather is cut to.
    monkeypatch.setattr(ops, "_DENSE_XLA_MAX_S", 16)
    if Q > 1:
        blocked = ops.paged_attention_full(
            t(q), pool, 1, t(pt), t(s.kvlens), t(s.positions), live_pages=2
        )
        assert taken == ["paged_attention_xla_blocked"]
        np.testing.assert_allclose(
            blocked.numpy()[s.valid], out.numpy()[s.valid], atol=1e-5, rtol=0
        )


def test_cpu_entry_points_run_the_plain_versions():
    rng = np.random.default_rng(3)
    s = flat_step(LAYOUTS["mixed"])
    pt = t(page_table(rng, s.B))
    cache = t(rng.normal(size=(L, P, K, PAGE, 2 * D)).astype(np.float32))
    k, v = (t(rng.normal(size=(s.T, 1, K, D)).astype(np.float32)) for _ in range(2))
    q = t(rng.normal(size=(s.T, 1, 2 * K, D)).astype(np.float32))
    ops.reset_launch_counts()
    ref = ops.write_kv_pages_flat_plain(
        cache.clone(), 0, k, v, pt, t(s.rows), t(s.positions), t(s.num_live)
    )
    out = ops.write_kv_pages_full_flat(
        cache, 0, k, v, pt, t(s.rows), t(s.positions[:, None]), t(s.num_live)
    )
    assert out is cache and torch.equal(out, ref)
    attn = ops.paged_attention_full_flat(q, cache, 0, t(s.rows), pt, t(s.kv_lens))
    assert torch.equal(
        attn, ops.flat_paged_attention_plain(q, cache, 0, t(s.rows), pt, t(s.kv_lens))
    )
    d = decode_step(rng, DECODE_BATCHES["mixed"])
    kv_new = t(rng.normal(size=(d.B, K, 2 * D)).astype(np.float32))
    dargs = (kv_new, 1, t(d.phys), t(d.offset), t(d.valid))
    ref = ops.write_kv_pages_decode_plain(cache.clone(), *dargs)
    out = ops.write_kv_pages_decode_full(cache, *dargs)
    assert out is cache and torch.equal(out, ref)
    qd = t(rng.normal(size=(d.B, 1, 2 * K, D)).astype(np.float32))
    assert torch.equal(
        ops.decode_paged_attention_full(qd, cache, 1, t(d.pt), t(d.kv_lens)),
        ops.decode_paged_attention_plain(qd, cache, 1, t(d.pt), t(d.kv_lens)),
    )
    x = t(rng.normal(size=(9, 16)).astype(np.float32))
    w = t(rng.normal(size=(3, 16, 8)).astype(np.float32))
    sizes = t(np.asarray([4, 0, 5], np.int32))
    assert torch.equal(ops.grouped_matmul(x, w, sizes), ops.grouped_matmul_plain(x, w, sizes))
    latent = t(rng.normal(size=(2, P, 1, PAGE, 64)).astype(np.float32))
    q_eff = t(rng.normal(size=(d.B, 1, 4, 64)).astype(np.float32))
    assert torch.equal(
        ops.mla_decode_paged_attention_full(q_eff, latent, 1, t(d.pt), t(d.kv_lens), 32, 0.1),
        ops.mla_decode_paged_attention_plain(q_eff, latent, 1, t(d.pt), t(d.kv_lens), 32, 0.1),
    )
    # The plain versions are not kernel launches.
    assert ops.launch_counts() == {
        "write_kv_pages_flat_full": 0, "flat_paged_attention_full": 0,
        "write_kv_pages_decode_full": 0, "decode_paged_attention_full": 0,
        "mla_decode_paged_attention_full": 0, "grouped_matmul": 0,
        "grouped_matmul_pair": 0,
    }


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor off the CPU goes to the kernel or the call raises; here a
    meta tensor (no device memory) must raise, not fall back."""
    s = flat_step(LAYOUTS["decode"])
    meta = dict(device="meta")
    cache = torch.empty((L, P, K, PAGE, 2 * D), **meta)
    k = torch.empty((s.T, 1, K, D), **meta)
    rows = torch.empty((s.T,), dtype=torch.int32, **meta)
    pt = torch.empty((s.B, 4), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.write_kv_pages_flat_full(cache, 0, k, k, pt, rows, rows, rows[:1])
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flat_paged_attention_full(k, cache, 0, rows, pt, rows)
    B = s.B
    kv_new = torch.empty((B, K, 2 * D), **meta)
    idx = torch.empty((B,), dtype=torch.int32, **meta)
    qd = torch.empty((B, 1, K, D), **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.write_kv_pages_decode_full(cache, kv_new, 0, idx, idx, idx)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.write_kv_pages_decode(cache[0], kv_new, idx, idx, idx)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.decode_paged_attention_full(qd, cache, 0, pt, idx)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.decode_paged_attention(qd, cache[0], pt, idx)
    # The bucketed entries at Q == 1 reach those wrappers.
    pos = torch.zeros((B, 1), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.write_kv_pages_full(cache, 0, qd, qd, pt, pos, pos.bool())
    with pytest.raises(ValueError, match="unsupported device"):
        ops.paged_attention_full(qd, cache, 0, pt, idx, pos)


def test_kernel_sources_are_built_from_the_package(tmp_path, monkeypatch):
    from llmd_tpu_torch.ops import _build

    assert _build.sources() == [
        "decode_kv_write", "decode_paged_attention", "flat_kv_write",
        "flat_paged_attention", "grouped_gemm", "mla_decode_attention",
    ]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # The header both attention kernels include is part of each library's
    # name, so editing it rebuilds them (checked on a copy of the sources).
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    before = _build._library_path("decode_paged_attention")
    monkeypatch.setattr(_build, "CSRC", copy)
    assert _build._library_path("decode_paged_attention") == before
    with open(copy / "paged_attention.cuh", "a") as f:
        f.write("// touched\n")
    assert _build._library_path("decode_paged_attention") != before
    assert _build._library_path("flat_paged_attention").name.startswith("libflat_paged_attention-")


def test_moe_and_mla_wrappers_never_take_the_plain_version_off_the_cpu():
    """K5' and K6' dispatch by device like the others: a meta tensor
    raises, through the wrappers and through the MLA entry at Q == 1."""
    meta = dict(device="meta")
    x = torch.empty((10, 64), **meta)
    w = torch.empty((2, 64, 64), **meta)
    sizes = torch.empty((2,), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.grouped_matmul(x, w, sizes)
    latent = torch.empty((2, 8, 1, 16, 640), **meta)
    q_eff = torch.empty((3, 1, 16, 640), **meta)
    idx = torch.empty((3,), dtype=torch.int32, **meta)
    pt = torch.empty((3, 4), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.mla_decode_paged_attention_full(q_eff, latent, 0, pt, idx, 512, 0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.mla_paged_attention_full(q_eff, latent, 0, pt, idx, idx[:, None], 512, 0.1)
