"""The int8 KV pool of the port against the JAX package's, on the CPU.

``CacheConfig(dtype="int8")`` makes the pool a pair: int8 data
``[L, P, K, page, 2D]`` and f32 scales ``[L, P, K, page, 2]`` valued on the
f16 grid (``ops/quant_kv.py``). Held to the JAX package, bit for bit:
``quantize_kv_rows`` (the all-zero row and the row whose scale overflows
f16 included), the flat, decode and bucketed int8 writes, and the pools
the engines leave behind; the greedy and seeded streams of ``tiny`` and
``tiny-moe`` on an int8 pool equal the JAX engine's in every step layout.
MLA models refuse the int8 pool in both packages. The int8 branch of the
attention kernels' plain versions is in ``tests/test_torch_oss.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llmd_tpu.ops as jops
import llmd_tpu_torch.config as tcfg
from llmd_tpu.ops import quant_kv as jquant
from llmd_tpu_torch import ops
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.models.registry import get_model_config
from test_torch_engine import (
    LAYOUTS, PROMPTS, counting_host_reads, engines, layout_streams_match, long_prompts,
)
from test_torch_oss import K, L, decode_step, f16_grid, flat_step, t


def edge_rows(x):
    """Row 0 all zeros; row 1 so large that amax / 127 overflows f16."""
    x = x.copy()
    x[0] = 0.0
    x[1] = x[1] * 0 + np.float32(1e7) * np.sign(x[1] + 0.5)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_is_bit_equal(dtype):
    rng = np.random.default_rng(14)
    k = edge_rows(rng.normal(size=(9, 3, 64)).astype(np.float32) * 3)
    v = edge_rows(rng.normal(size=(9, 3, 64)).astype(np.float32))[::-1].copy()
    k[4, 1, :5] = [126.5, -126.5, 127.49, 0.5, -0.5]  # ties and the clamp
    jk, jv = jnp.asarray(k, dtype), jnp.asarray(v, dtype)
    want = [np.asarray(a) for a in jquant.quantize_kv_rows(jk, jv)]
    tk, tv = (t(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype)) for a in (jk, jv))
    got = [a.numpy() for a in ops.quantize_kv_rows(tk, tv)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # The edge rows: zero data, scale 0 or inf.
    assert not got[0][0].any() and not got[0][1].any()
    assert (got[2][0, :, 0] == 0).all() and np.isinf(got[2][1, :, 0]).all()
    # Pages: quantize -> dequantize -> quantize is a round trip.
    pages = rng.normal(size=(2, 3, 4, 128)).astype(np.float32)
    d, s8 = ops.quantize_pages(t(pages))
    jd, js = jquant.quantize_pages(jnp.asarray(pages))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(s8.numpy(), np.asarray(js))
    back = ops.dequantize_pages(d, s8, torch.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jquant.dequantize_pages(jd, js, jnp.float32)))
    d2, s2 = ops.quantize_pages(back)
    assert torch.equal(d2, d) and torch.equal(s2, s8)


def int8_pool(rng, P, page, D):
    data = rng.integers(-127, 128, size=(L, P, K, page, 2 * D)).astype(np.int8)
    return data, f16_grid(rng.uniform(0.01, 0.1, size=(L, P, K, page, 2)))


@pytest.mark.parametrize("D,page", [(64, 4), (128, 16)])
def test_flat_int8_write_is_bit_equal(D, page):
    rng = np.random.default_rng(15)
    s = flat_step(rng, page)
    data, scales = int8_pool(rng, s.P, page, D)
    k = edge_rows(rng.normal(size=(s.T, 1, K, D)).astype(np.float32))
    v = edge_rows(rng.normal(size=(s.T, 1, K, D)).astype(np.float32) * 5)
    jd, js = jops.write_kv_pages_full_flat(
        (jnp.asarray(data), jnp.asarray(scales)), jnp.int32(1), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(s.pt), jnp.asarray(s.rows),
        jnp.asarray(s.positions[:, None]), jnp.asarray(s.live[:, None]), None,
    )
    pair = (t(data), t(scales))
    out = ops.write_kv_pages_full_flat(
        pair, 1, t(k), t(v), t(s.pt), t(s.rows), t(s.positions[:, None]),
        torch.tensor([s.total], dtype=torch.int32),
    )
    assert out is pair
    np.testing.assert_array_equal(pair[0].numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pair[1].numpy(), np.asarray(js))
    assert (pair[1].numpy() != scales).any() and (pair[0].numpy() != data).any()


@pytest.mark.parametrize("D,page", [(64, 4), (128, 16)])
def test_decode_int8_write_is_bit_equal(D, page):
    """Q == 1 (the decode write kernel's plain version) and Q > 1 (the
    plain scatter) against JAX's int8 ``write_kv_pages_full``; pad rows
    write neither data nor scales."""
    rng = np.random.default_rng(16)
    s = decode_step(rng, page)
    data, scales = int8_pool(rng, s.P, page, D)
    k = edge_rows(rng.normal(size=(s.B, 1, K, D)).astype(np.float32))
    v = edge_rows(rng.normal(size=(s.B, 1, K, D)).astype(np.float32))
    valid = s.valid[:, None].astype(bool)
    jd, js = jops.write_kv_pages_full(
        (jnp.asarray(data), jnp.asarray(scales)), jnp.int32(0), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(s.pt), jnp.asarray(s.pos[:, None]), jnp.asarray(valid),
    )
    pair = (t(data), t(scales))
    ops.write_kv_pages_full(pair, 0, t(k), t(v), t(s.pt), t(s.pos[:, None]), t(valid))
    np.testing.assert_array_equal(pair[0].numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pair[1].numpy(), np.asarray(js))
    np.testing.assert_array_equal(pair[0].numpy()[1], data[1])
    # The decode write's plain version, with garbage pad targets.
    kv_new = t(np.concatenate([k, v], -1)[:, 0])
    pair2 = (t(data), t(scales))
    ops.write_kv_pages_decode_full(pair2[0], kv_new, 0, t(s.phys), t(s.offset),
                                   t(s.valid), pair2[1])
    assert torch.equal(pair2[0], pair[0]) and torch.equal(pair2[1], pair[1])
    # Q > 1: two tokens a row (the second of each live row, at the next
    # position), through the plain scatter.
    pos2 = np.stack([s.pos, s.pos + 1], 1).astype(np.int32)
    valid2 = np.stack([valid[:, 0], valid[:, 0] & (s.pos % page != page - 1)], 1)
    k2, v2 = (np.repeat(a, 2, axis=1) * 1.5 for a in (k, v))
    jd, js = jops.write_kv_pages_full(
        (jnp.asarray(data), jnp.asarray(scales)), jnp.int32(1), jnp.asarray(k2),
        jnp.asarray(v2), jnp.asarray(s.pt), jnp.asarray(pos2), jnp.asarray(valid2),
    )
    pair3 = (t(data), t(scales))
    ops.write_kv_pages_full(pair3, 1, t(k2), t(v2), t(s.pt), t(pos2), t(valid2))
    np.testing.assert_array_equal(pair3[0].numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pair3[1].numpy(), np.asarray(js))



@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("model", ["tiny", "tiny-moe"])
def test_int8_pool_streams_match_jax(model, layout):
    """``CacheConfig(dtype="int8")``: the pool is the (int8 data, f32
    scales) pair in the JAX shapes, and the streams equal the JAX engine's
    in every step layout."""
    j, p = engines(model=model, max_batched=16, kv_dtype="int8",
                   **LAYOUTS[layout])
    data, scales = p.runner.kv_cache
    jdata, jscales = j.runner.kv_cache
    assert data.dtype == torch.int8 and scales.dtype == torch.float32
    assert tuple(data.shape) == jdata.shape and tuple(scales.shape) == jscales.shape
    layout_streams_match(j, p, long_prompts(8))
    # Written pages hold the JAX engine's bytes (the same K|V quantized).
    data, scales = p.runner.kv_cache
    jdata, jscales = j.runner.kv_cache
    written = scales.numpy() != 1.0
    assert written.any()
    np.testing.assert_array_equal(scales.numpy()[written], np.asarray(jscales)[written])
    np.testing.assert_array_equal(data.numpy(), np.asarray(jdata))


def test_int8_decode_window_reads_nothing_back():
    """On the int8 pool too, the K iterations of a fused window are
    enqueued without a host read (the plain write quantizes on the
    device)."""
    _, p = engines(kv_dtype="int8", **LAYOUTS["window"])
    windows = []
    orig = p.runner.dispatch_staged_decode

    def guarded(staged):
        with counting_host_reads() as calls:
            pending = orig(staged)
        windows.append((staged.k, list(calls)))
        return pending

    p.runner.dispatch_staged_decode = guarded
    p.generate(PROMPTS, SamplingParams(temperature=0.0, max_tokens=9, ignore_eos=True))
    assert [k for k, _ in windows] == [4, 4]
    assert all(calls == [] for _, calls in windows)


def test_int8_pool_refused_for_mla():
    with pytest.raises(ValueError, match="int8"):
        engines(model="tiny-mla", kv_dtype="int8")
    cfg = tcfg.EngineConfig(model=get_model_config("tiny-mla"),
                            cache=tcfg.CacheConfig(num_blocks=8, dtype="int8"))
    with pytest.raises(ValueError, match="int8"):
        LLMEngine(cfg, device="cpu")
