"""The port's flat-step ops against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, go through the port's plain
PyTorch versions and through the JAX functions: the XLA fallbacks of
``llmd_tpu.ops`` and the Pallas kernels in interpret mode (Pallas-legal
geometry: page 8, head_dim 128). The KV write is exact; attention holds to
atol 1e-5 (f32, different summation order).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llmd_tpu.ops as jops
from llmd_tpu.engine.runner import ModelRunner as JaxRunner
from llmd_tpu.ops.kv_write import write_kv_pages_flat_full as jax_flat_write
from llmd_tpu.ops.ragged_paged_attention import (
    flat_paged_attention_full as jax_flat_attention,
)
from llmd_tpu_torch import ops

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
        B=B, T=total + pad, total=total, row_start=row_start, pos0=pos0,
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
        t(cache), 1, t(k), t(v), t(pt), t(s.rows), t(s.positions), s.total
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
        t(cache), 0, t(k), t(v), t(pt), t(s.rows), t(s.positions), s.total
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


def test_cpu_entry_points_run_the_plain_versions():
    rng = np.random.default_rng(3)
    s = flat_step(LAYOUTS["mixed"])
    pt = t(page_table(rng, s.B))
    cache = t(rng.normal(size=(L, P, K, PAGE, 2 * D)).astype(np.float32))
    k, v = (t(rng.normal(size=(s.T, 1, K, D)).astype(np.float32)) for _ in range(2))
    q = t(rng.normal(size=(s.T, 1, 2 * K, D)).astype(np.float32))
    ops.reset_launch_counts()
    ref = ops.write_kv_pages_flat_plain(
        cache.clone(), 0, k, v, pt, t(s.rows), t(s.positions), s.total
    )
    out = ops.write_kv_pages_full_flat(
        cache, 0, k, v, pt, t(s.rows), t(s.positions[:, None]), s.total
    )
    assert out is cache and torch.equal(out, ref)
    attn = ops.paged_attention_full_flat(q, cache, 0, t(s.rows), pt, t(s.kv_lens))
    assert torch.equal(
        attn, ops.flat_paged_attention_plain(q, cache, 0, t(s.rows), pt, t(s.kv_lens))
    )
    # The plain versions are not kernel launches.
    assert ops.launch_counts() == {
        "write_kv_pages_flat_full": 0, "flat_paged_attention_full": 0,
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
        ops.write_kv_pages_flat_full(cache, 0, k, k, pt, rows, rows, s.total)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flat_paged_attention_full(k, cache, 0, rows, pt, rows)


def test_kernel_sources_are_built_from_the_package():
    from llmd_tpu_torch.ops import _build

    assert _build.sources() == ["flat_kv_write", "flat_paged_attention"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
