"""The port's gpt-oss and int8-pool pieces against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, go through the port's plain
PyTorch versions and through the JAX functions:

- the plain versions of the flat (K1) and decode (K3) attention kernels
  with a sliding window, attention sinks and an int8 pool, each alone and
  all three together, at head_dim 64 and 128 and page 4 and 16, against
  JAX's XLA path (``llmd_tpu.ops`` on the CPU) and the TPU kernels in
  interpret mode; windows shorter and longer than the rows' contexts, and
  pad rows, included;
- the plain ``[B, Q]`` attention forms with window, sinks and scales;
- ``rope_tables`` for every rope type;
- gpt-oss's router logit bias, clamped SwiGLU and biased experts.

f32 throughout. Attention holds to atol 2e-5 (the sums run in another
order; the int8 pool folds its scales around the products, where JAX's XLA
path dequantizes first); the rope tables and the MoE pieces to 2e-5.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llmd_tpu.config as jcfg
import llmd_tpu.ops as jops
import llmd_tpu_torch.config as tcfg
from llmd_tpu.models import common as jcommon
from llmd_tpu.models import llama as jllama
from llmd_tpu.models import moe as jmoe
from llmd_tpu.ops.grouped_gemm import moe_apply_grouped as jax_moe_apply_grouped
from llmd_tpu.ops.ragged_paged_attention import (
    decode_paged_attention_full as jax_decode_attention,
    flat_paged_attention_full as jax_flat_attention,
)
from llmd_tpu_torch import ops
from llmd_tpu_torch.models import common, moe

L, K, G = 2, 2, 2
ATOL = 2e-5
WINDOW = 7
# name -> (window, sinks, int8 pool)
VARIANTS = {
    "window": (WINDOW, False, False),
    "sinks": (0, True, False),
    "int8": (0, False, True),
    "all": (WINDOW, True, True),
}
GEOMETRIES = [(64, 4), (64, 16), (128, 4), (128, 16)]  # (head_dim, page)
# The interpret-mode Pallas kernel compiles anew for every variant and
# geometry, 3-12 s a case on the CPU: all 32 cases would add minutes to
# every run of the tests. The port's plain versions are held to JAX's XLA
# path in every case; the interpret kernel is a second witness, run for
# every variant at head_dim 64, page 16 (gpt-oss's geometry) and for all
# three branches at head_dim 128, page 4. The XLA path and the kernel are
# the JAX package's own pair, which its tests hold to each other.
INTERPRET = {(v, 64, 16) for v in VARIANTS} | {("all", 128, 4)}


def t(a):
    """A torch copy of a numpy array (the port's writes are in place)."""
    return torch.from_numpy(np.array(a, copy=True))


def f16_grid(a):
    return a.astype(np.float16).astype(np.float32)


def pool(rng, P, page, D, int8):
    """A random pool: float, or (int8 data, scales on the f16 grid) whose
    dequantized values are about as large as the float pool's."""
    if not int8:
        return rng.normal(size=(L, P, K, page, 2 * D)).astype(np.float32), None
    data = rng.integers(-127, 128, size=(L, P, K, page, 2 * D)).astype(np.int8)
    scales = f16_grid(rng.uniform(0.004, 0.016, size=(L, P, K, page, 2)))
    return data, scales


def extras(rng, variant):
    window, sinks, int8 = VARIANTS[variant]
    sk = rng.normal(size=(K * G,)).astype(np.float32) if sinks else None
    return window, sk, int8


def jax_pool(data, scales):
    return jnp.asarray(data) if scales is None else (jnp.asarray(data), jnp.asarray(scales))


# (pos0, qlen) per row of the flat step: prefill chunks with and without a
# prefix (token contexts 4-11, around the window of 7), a decode row and a
# decode row at context 23, longer than the window.
FLAT_ROWS = ((3, 5), (9, 1), (0, 11), (22, 1))


def flat_step(rng, page, pad=3):
    B = len(FLAT_ROWS) + 2
    max_pages = -(-24 // page) + 1
    P = B * max_pages + 2
    pt = rng.permutation(P)[: B * max_pages].reshape(B, max_pages).astype(np.int32)
    rows, positions = [], []
    for r, (p0, w) in enumerate(FLAT_ROWS):
        rows += [r] * w
        positions += range(p0, p0 + w)
    total = len(rows)
    rows += [len(FLAT_ROWS) - 1] * pad
    positions = np.asarray(positions + [0] * pad, np.int32)
    live = np.arange(total + pad) < total
    return SimpleNamespace(
        P=P, pt=pt, rows=np.asarray(rows, np.int32), positions=positions,
        total=total, T=total + pad, live=live,
        kv_lens=np.where(live, positions + 1, 0).astype(np.int32),
    )


@pytest.mark.parametrize("D,page", GEOMETRIES)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flat_attention_branches_match_jax(variant, D, page):
    """K1's plain version with the window, sinks and int8 branches against
    JAX's XLA path and (see INTERPRET) the interpret-mode TPU kernel, on
    the live tokens; pads come out as zeros."""
    rng = np.random.default_rng(11)
    s = flat_step(rng, page)
    data, scales = pool(rng, s.P, page, D, VARIANTS[variant][2])
    window, sinks, _ = extras(rng, variant)
    q = rng.normal(size=(s.T, 1, K * G, D)).astype(np.float32)
    got = ops.flat_paged_attention_plain(
        t(q), t(data), 1, t(s.rows), t(s.pt), t(s.kv_lens), None, window,
        None if sinks is None else t(sinks), None if scales is None else t(scales),
    ).numpy()
    jw = jnp.int32(window) if window else None
    js = None if sinks is None else jnp.asarray(sinks)
    xla = jops.paged_attention_full_flat(
        jnp.asarray(q), jax_pool(data, scales), jnp.int32(1), jnp.asarray(s.rows),
        jnp.asarray(s.pt), jnp.asarray(s.kv_lens), jnp.asarray(s.positions[:, None]),
        window=jw, sinks=js,
    )
    np.testing.assert_allclose(got[s.live], np.asarray(xla)[s.live], atol=ATOL, rtol=0)
    assert not got[~s.live].any()
    if (variant, D, page) in INTERPRET:
        pallas = jax_flat_attention(
            jnp.asarray(q), jnp.asarray(data), jnp.int32(1), jnp.asarray(s.rows),
            jnp.asarray(s.pt), jnp.asarray(s.kv_lens), interpret=True, window=jw,
            sinks=js, scales=None if scales is None else jnp.asarray(scales),
        )
        np.testing.assert_allclose(got[s.live], np.asarray(pallas)[s.live], atol=ATOL, rtol=0)
        assert not np.asarray(pallas)[~s.live].any()
    # Through the ops entry, on the (data, scales) pair.
    entry = ops.paged_attention_full_flat(
        t(q), t(data) if scales is None else (t(data), t(scales)), 1, t(s.rows),
        t(s.pt), t(s.kv_lens), None, window, None if sinks is None else t(sinks),
    ).numpy()
    np.testing.assert_array_equal(entry, got)


# kv_len per decode row: 0 is a pad row; 3 and 1 are shorter than the window.
DECODE_LENS = (8, 23, 0, 1, 32, 3, 0)


def decode_step(rng, page, kv_lens=DECODE_LENS):
    kv_lens = np.asarray(kv_lens, np.int32)
    B = len(kv_lens)
    max_pages = -(-int(kv_lens.max()) // page) + 1
    P = B * max_pages + 2
    pt = rng.permutation(P)[: B * max_pages].reshape(B, max_pages).astype(np.int32)
    pos = np.maximum(kv_lens - 1, 0)
    valid = (kv_lens > 0).astype(np.int32)
    phys = pt[np.arange(B), pos // page].astype(np.int32)
    phys[valid == 0] = 10_000  # never dereferenced
    return SimpleNamespace(B=B, P=P, pt=pt, kv_lens=kv_lens, pos=pos, valid=valid,
                           phys=phys, offset=(pos % page).astype(np.int32))


@pytest.mark.parametrize("D,page", GEOMETRIES)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_attention_branches_match_jax(variant, D, page):
    """K3's plain version with the window, sinks and int8 branches against
    JAX's XLA path and (see INTERPRET) the interpret-mode TPU kernel. Pad
    rows come out as zeros, with sinks too."""
    rng = np.random.default_rng(12)
    s = decode_step(rng, page)
    data, scales = pool(rng, s.P, page, D, VARIANTS[variant][2])
    window, sinks, _ = extras(rng, variant)
    q = rng.normal(size=(s.B, 1, K * G, D)).astype(np.float32)
    targs = (t(q), t(data), 1, t(s.pt), t(s.kv_lens))
    kw = dict(window=window, sinks=None if sinks is None else t(sinks),
              scales=None if scales is None else t(scales))
    got = ops.decode_paged_attention_plain(*targs, **kw).numpy()
    live = s.kv_lens > 0
    jw = jnp.int32(window) if window else None
    js = None if sinks is None else jnp.asarray(sinks)
    xla = jops.paged_attention_full(
        jnp.asarray(q), jax_pool(data, scales), jnp.int32(1), jnp.asarray(s.pt),
        jnp.asarray(s.kv_lens), jnp.asarray(s.pos[:, None]), window=jw, sinks=js,
    )
    np.testing.assert_allclose(got[live], np.asarray(xla)[live], atol=ATOL, rtol=0)
    assert not got[~live].any()
    if (variant, D, page) in INTERPRET:
        pallas = jax_decode_attention(
            jnp.asarray(q), jnp.asarray(data), jnp.int32(1), jnp.asarray(s.pt),
            jnp.asarray(s.kv_lens), interpret=True, window=jw, sinks=js,
            scales=None if scales is None else jnp.asarray(scales),
        )
        np.testing.assert_allclose(got[live], np.asarray(pallas)[live], atol=ATOL, rtol=0)
        assert not np.asarray(pallas)[~live].any()
    # A bounded gather gives the same; the bucketed entry at Q == 1 too.
    bounded = ops.decode_paged_attention_plain(*targs, live_pages=s.pt.shape[1] - 1, **kw)
    np.testing.assert_allclose(bounded.numpy(), got, atol=1e-6, rtol=0)
    entry = ops.paged_attention_full(
        t(q), t(data) if scales is None else (t(data), t(scales)), 1, t(s.pt),
        t(s.kv_lens), t(s.pos[:, None]), window=window, sinks=kw["sinks"],
    )
    np.testing.assert_array_equal(entry.numpy(), got)


def test_dead_positions_never_enter_a_sum():
    """Pool rows before the window and past kv_len hold NaN data and an
    f16-overflow inf scale: the plain versions read only live positions'
    scales, so the result equals a clean pool's."""
    rng = np.random.default_rng(13)
    page, D = 4, 64
    s = decode_step(rng, page)
    data, scales = pool(rng, s.P, page, D, True)
    fpool, _ = pool(rng, s.P, page, D, False)
    sinks = t(rng.normal(size=(K * G,)).astype(np.float32))
    q = t(rng.normal(size=(s.B, 1, K * G, D)).astype(np.float32))
    bad_scales, bad_pool = scales.copy(), fpool.copy()
    for b, n in enumerate(s.kv_lens):
        lo = max(int(n) - WINDOW, 0)
        for i in [*range(lo), *range(n, s.pt.shape[1] * page)]:
            bad_scales[:, s.pt[b, i // page], :, i % page] = np.inf
            bad_pool[:, s.pt[b, i // page], :, i % page] = np.nan
    args = (q, 1, t(s.pt), t(s.kv_lens))
    for clean, dirty, sc_clean, sc_dirty in (
        (data, data, scales, bad_scales), (fpool, bad_pool, None, None),
    ):
        want = ops.decode_paged_attention_plain(
            args[0], t(clean), *args[1:], window=WINDOW, sinks=sinks,
            scales=None if sc_clean is None else t(sc_clean))
        got = ops.decode_paged_attention_plain(
            args[0], t(dirty), *args[1:], window=WINDOW, sinks=sinks,
            scales=None if sc_dirty is None else t(sc_dirty))
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=0, rtol=0)


# --------------------------------------------------------------------- #
# The plain [B, Q] attention forms with the three branches


@pytest.mark.parametrize("form", ["dense", "blocked"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bucketed_attention_branches_match_jax(variant, form):
    rng = np.random.default_rng(17)
    page, D = 4, 64
    spec = ((0, 11), (5, 9), (13, 1), (0, 0))  # (start, qlen); qlen 0 pads
    B, Q = len(spec), 11
    positions = np.zeros((B, Q), np.int32)
    kvlens = np.zeros(B, np.int32)
    valid = np.zeros((B, Q), bool)
    for i, (p0, w) in enumerate(spec):
        positions[i, :w] = np.arange(p0, p0 + w)
        positions[i, w:] = p0 + max(w - 1, 0)
        kvlens[i] = p0 + w if w else 0
        valid[i, :w] = True
    pt = rng.permutation(40)[: B * 5].reshape(B, 5).astype(np.int32)
    data, scales = pool(rng, 40, page, D, VARIANTS[variant][2])
    window, sinks, _ = extras(rng, variant)
    q = rng.normal(size=(B, Q, K * G, D)).astype(np.float32)
    sl = (data[1], None if scales is None else scales[1])
    jkw = dict(window=jnp.int32(window) if window else None,
               sinks=None if sinks is None else jnp.asarray(sinks),
               scales=None if sl[1] is None else jnp.asarray(sl[1]))
    tkw = dict(window=window, sinks=None if sinks is None else t(sinks),
               scales=None if sl[1] is None else t(sl[1]))
    args = (q, sl[0], pt, kvlens, positions)
    if form == "dense":
        want = jops.paged_attention_xla(*map(jnp.asarray, args), **jkw)
        got = ops.paged_attention_xla(*map(t, args), **tkw)
    else:
        want = jops.paged_attention_xla_blocked(*map(jnp.asarray, args), block_pages=2, **jkw)
        got = ops.paged_attention_xla_blocked(*map(t, args), block_pages=2, **tkw)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=ATOL, rtol=0)


# --------------------------------------------------------------------- #
# Rope, router, GLU and experts

ROPES = {
    "default": None,
    "linear": {"rope_type": "linear", "factor": 4.0},
    "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
    "yarn": {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0, "beta_slow": 1.0,
             "original_max_position_embeddings": 64},
    "yarn_mscale": {"type": "yarn", "factor": 40.0, "mscale": 1.0, "mscale_all_dim": 0.707,
                    "original_max_position_embeddings": 128},
}


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("kind", sorted(ROPES))
def test_rope_tables_match_jax(kind, head_dim):
    """Inverse frequencies within 2 f32 ulp (``theta ** x`` rounds in
    another place in each library) and the same attention factor; the
    tables at positions below 1,024, where one ulp of a frequency moves an
    angle by at most 1.5e-5, to atol 2e-5."""
    jf, jfac = jcommon._inv_freq_and_factor(head_dim, 150000.0, ROPES[kind])
    tf, tfac = common._inv_freq_and_factor(head_dim, 150000.0, ROPES[kind])
    assert tfac == jfac
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=2.5e-7, atol=0)
    positions = np.arange(0, 1023, 7, dtype=np.int32).reshape(-1, 3)
    jc, js = jcommon.rope_tables(jnp.asarray(positions), head_dim, 150000.0, ROPES[kind])
    tc, ts = common.rope_tables(t(positions), head_dim, 150000.0, ROPES[kind])
    assert common.rope_type(ROPES[kind]) == jcommon.rope_type(ROPES[kind])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-5, rtol=0)
    if kind.startswith("yarn"):
        assert tfac != 1.0  # the attention factor scales the tables


OSS_MOE = dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
               moe_activation="swiglu_oss", router_logit_bias=True, swiglu_limit=1.5)


@functools.cache
def oss_layer(seed):
    """One gpt-oss MoE layer from the JAX init, its zero biases replaced by
    seeded random values (a dropped bias would otherwise pass). Built once
    a seed: the tests below share it and do not modify it."""
    jc = jcfg.tiny_model_config(**OSS_MOE)
    lp = jllama.init_params(jc, jax.random.key(seed))["layers"]
    lp = {k: np.array(v[0]) for k, v in lp.items() if k.startswith(("router", "we_"))}
    rng = np.random.default_rng(seed)
    for name in ("router_bias", "we_gate_b", "we_up_b", "we_down_b"):
        assert not lp[name].any()
        lp[name] = (rng.normal(size=lp[name].shape) * 0.5).astype(np.float32)
    return jc, tcfg.tiny_model_config(**OSS_MOE), lp


def test_router_with_logit_bias_matches_jax():
    jc, tc, lp = oss_layer(1)
    h = np.random.default_rng(2).normal(size=(29, jc.hidden_size)).astype(np.float32)
    jw, jids = jmoe.router_topk(jnp.asarray(h), jnp.asarray(lp["router"]), 2, jc,
                                jnp.asarray(lp["router_bias"]))
    tw, tids = moe.router_topk(t(h), t(lp["router"]), 2, tc, t(lp["router_bias"]))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=2e-5, rtol=2e-5)
    plain = moe.router_topk(t(h), t(lp["router"]), 2, tc)[1]
    assert not torch.equal(plain, tids), "the bias changed no selection"


def test_swiglu_oss_matches_jax():
    jc, tc, _ = oss_layer(1)
    rng = np.random.default_rng(3)
    gate, up = (rng.normal(size=(7, 32)).astype(np.float32) * 3 for _ in range(2))
    want = jmoe.expert_glu(jnp.asarray(gate), jnp.asarray(up), jc)
    got = moe.expert_glu(t(gate), t(up), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    # Without a config, or with the silu family, the GLU is SwiGLU.
    silu = moe.expert_glu(t(gate), t(up))
    np.testing.assert_allclose(
        silu.numpy(), np.asarray(jmoe.expert_glu(jnp.asarray(gate), jnp.asarray(up),
                                                 jcfg.tiny_model_config())),
        atol=2e-5, rtol=2e-5)


def test_biased_experts_match_jax():
    jc, tc, lp = oss_layer(1)
    rng = np.random.default_rng(5)
    T = 19
    h = rng.normal(size=(T, jc.hidden_size)).astype(np.float32)
    ids = np.stack([rng.permutation(4)[:2] for _ in range(T)]).astype(np.int32)
    weights = rng.random(size=(T, 2)).astype(np.float32)
    ws = ("we_gate", "we_up", "we_down")
    bs = ("we_gate_b", "we_up_b", "we_down_b")
    want = jax_moe_apply_grouped(
        jnp.asarray(h), jnp.asarray(weights), jnp.asarray(ids),
        *(jnp.asarray(lp[n]) for n in ws), biases=tuple(jnp.asarray(lp[n]) for n in bs), cfg=jc)
    got = moe.moe_apply_grouped(
        t(h), t(weights), t(ids), *(t(lp[n]) for n in ws),
        biases=tuple(t(lp[n]) for n in bs), cfg=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    # The whole block (router with its logit bias, experts, combine).
    hb = rng.normal(size=(3, 5, jc.hidden_size)).astype(np.float32)
    want = jmoe.moe_block_grouped(jnp.asarray(hb), {k: jnp.asarray(v) for k, v in lp.items()}, jc)
    got = moe.moe_block_grouped(t(hb), {k: t(v) for k, v in lp.items()}, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_config_windows_and_int8_match_jax():
    """``window_for_layer`` / ``layer_windows`` follow the three HF
    conventions as in JAX; MLA refuses a window; ``quantized`` reads the
    pool dtype."""
    for kw in (dict(sliding_window=16, layer_types=("sliding_attention", "full_attention")),
               dict(sliding_window=16, max_window_layers=1), dict(sliding_window=16), {}):
        assert tcfg.tiny_model_config(**kw).layer_windows == jcfg.tiny_model_config(**kw).layer_windows
    with pytest.raises(ValueError, match="layer_types"):
        tcfg.tiny_model_config(layer_types=("full_attention",))
    with pytest.raises(ValueError, match="MLA"):
        tcfg.tiny_model_config(sliding_window=8, kv_lora_rank=16)
    assert tcfg.CacheConfig(dtype="int8").quantized and not tcfg.CacheConfig().quantized
