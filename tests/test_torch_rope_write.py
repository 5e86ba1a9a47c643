"""The fused KV writes' plain versions against the JAX package, on the CPU.

``ops.rope_write_kv_flat`` (K2's fused form) and ``ops.rope_write_kv_decode``
(K4's) add the q|k|v biases, rotate q and k and store k|v in one launch on
the card; on the CPU they run their plain versions. The same seeded numpy
inputs go through them and through the JAX chain they replace: the biases
added first, ``llmd_tpu.models.common.apply_rope`` on q and k, then
``llmd_tpu.ops.write_kv_pages_full_flat`` (flat step) or
``write_kv_pages_full`` (``Q == 1`` rows), on the CPU (XLA). Both take the
same cos/sin tables (JAX's ``rope_tables``; the port's are held to them in
``test_torch_oss.py``). Covered: q/k/v as strided views of one q|k|v
projection output and as contiguous (QK-normed) tensors, with and without
biases, the default, llama3 and yarn tables, head_dim 64 and 128, a float
and an int8 pool, flat pads past ``num_live`` and decode rows with
``valid == 0``, whose pool bytes stay as they were. The model routes the
flat step and ``Q == 1`` rows through the fused entries and ``Q > 1`` rows
through ``apply_rope`` and the plain scatter.

f32 throughout. Tolerance: q and the float pool within 1e-6 of the largest
value (XLA may contract a product and a sum into one rounding, PyTorch
rounds each); the int8 pool's data and scales equal.
"""

import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llmd_tpu.ops as jops
from llmd_tpu.models import common as jcommon
from llmd_tpu_torch import ops
from test_torch_oss import FLAT_ROWS, decode_step, f16_grid, flat_step, t

L, K, G = 2, 2, 2
NQ = K * G
RTOL = 1e-6
ROPES = {
    "default": (None, 10000.0),
    "llama3": ({"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                "high_freq_factor": 4.0, "original_max_position_embeddings": 16}, 500000.0),
    "yarn": ({"rope_type": "yarn", "factor": 4.0, "beta_fast": 32.0, "beta_slow": 1.0,
              "original_max_position_embeddings": 32}, 150000.0),
}
# (rope, head_dim, page)
GEOMETRIES = [("default", 64, 4), ("llama3", 128, 16), ("yarn", 64, 16), ("yarn", 128, 4)]


def close(got, want):
    """Within RTOL of the largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * float(np.abs(want).max()))


def pools(rng, P, page, D, int8):
    """(data, scales or None): a float pool, or int8 data with scales on
    the f16 grid."""
    if not int8:
        return rng.normal(size=(L, P, K, page, 2 * D)).astype(np.float32), None
    data = rng.integers(-127, 128, size=(L, P, K, page, 2 * D)).astype(np.int8)
    return data, f16_grid(rng.uniform(0.004, 0.016, size=(L, P, K, page, 2)))


@pytest.fixture(scope="module")
def cases():
    """One case's inputs and JAX results, made once a module: the views
    and contiguous layouts share them."""
    return functools.lru_cache(maxsize=None)(jax_case)


def jax_case(kind, rope, D, page, bias, int8):
    """Seeded inputs of one case and the JAX chain's results: the rotated q
    [N, NQ, D] and the pool (data, scales) after the write."""
    rng = np.random.default_rng(zlib.crc32(repr((kind, rope, D, page, bias, int8)).encode()))
    s = flat_step(rng, page) if kind == "flat" else decode_step(rng, page)
    N = s.T if kind == "flat" else s.B
    positions = s.positions if kind == "flat" else s.pos
    data, scales = pools(rng, s.P, page, D, int8)
    qkv = rng.normal(size=(N, (NQ + 2 * K) * D)).astype(np.float32)
    b = tuple(0.3 * rng.normal(size=(n * D,)).astype(np.float32) for n in (NQ, K, K)) if bias else None
    scaling, theta = ROPES[rope]
    cos, sin = (np.asarray(a) for a in jcommon.rope_tables(jnp.asarray(positions), D, theta, scaling))
    # The JAX chain, on [N, 1, heads, D] rows.
    jq, jk, jv = (jnp.asarray(qkv[:, a * D : (a + n) * D]).reshape(N, 1, n, D)
                  for a, n in ((0, NQ), (NQ, K), (NQ + K, K)))
    if bias:
        jq, jk, jv = (x + jnp.asarray(bb).reshape(n, D) for x, bb, n in zip((jq, jk, jv), b, (NQ, K, K)))
    jc, js = jnp.asarray(cos)[:, None], jnp.asarray(sin)[:, None]
    jq, jk = jcommon.apply_rope(jq, jc, js), jcommon.apply_rope(jk, jc, js)
    pool = jnp.asarray(data) if scales is None else (jnp.asarray(data), jnp.asarray(scales))
    if kind == "flat":
        out = jops.write_kv_pages_full_flat(
            pool, jnp.int32(1), jk, jv, jnp.asarray(s.pt), jnp.asarray(s.rows),
            jnp.asarray(s.positions[:, None]), jnp.asarray(s.live[:, None]), None)
    else:
        out = jops.write_kv_pages_full(
            pool, jnp.int32(1), jk, jv, jnp.asarray(s.pt), jnp.asarray(s.pos[:, None]),
            jnp.asarray(s.valid[:, None].astype(bool)))
    want_pool = tuple(np.asarray(a) for a in (out if scales is not None else (out,)))
    return dict(s=s, N=N, data=data, scales=scales, qkv=qkv, bias=b, cos=cos, sin=sin,
                want_q=np.asarray(jq)[:, 0], want_pool=want_pool)


def port_inputs(c, D, strided):
    """q [N, 1, NQ, D], k, v [N, 1, K, D]: views of one projection output,
    or contiguous tensors."""
    x = t(c["qkv"]).reshape(c["N"], 1, -1)
    q = x[..., : NQ * D].view(c["N"], 1, NQ, D)
    k = x[..., NQ * D : (NQ + K) * D].view(c["N"], 1, K, D)
    v = x[..., (NQ + K) * D :].view(c["N"], 1, K, D)
    if not strided:
        q, k, v = (a.contiguous() for a in (q, k, v))
    else:
        assert not q.is_contiguous() and not k.is_contiguous()
    bias = None if c["bias"] is None else tuple(t(b) for b in c["bias"])
    return q, k, v, bias


def check_pool(c, pool, int8):
    if int8:
        np.testing.assert_array_equal(pool[0].numpy(), c["want_pool"][0])
        np.testing.assert_array_equal(pool[1].numpy(), c["want_pool"][1])
    else:
        close(pool.numpy(), c["want_pool"][0])


def untouched_outside(c, pool, targets):
    """Every pool row but the live targets [(page, slot)] of layer 1 keeps
    its bytes (the pads wrote nothing), and the targets changed."""
    parts = pool if isinstance(pool, tuple) else (pool,)
    before = (c["data"], c["scales"])
    for got, was in zip(parts, before):
        got = got.numpy()
        keep = np.ones(got.shape[:2] + got.shape[3:4], bool)  # [L, P, page]
        for p, sl in targets:
            keep[1, p, sl] = False
        np.testing.assert_array_equal(got.transpose(0, 1, 3, 2, 4)[keep], was.transpose(0, 1, 3, 2, 4)[keep])
        assert (got.transpose(0, 1, 3, 2, 4)[~keep] != was.transpose(0, 1, 3, 2, 4)[~keep]).any()


LAYOUTS = pytest.mark.parametrize("strided", [True, False], ids=["views", "contiguous"])
BIAS = pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
POOL = pytest.mark.parametrize("int8", [False, True], ids=["float_pool", "int8_pool"])


@LAYOUTS
@BIAS
@POOL
@pytest.mark.parametrize("rope,D,page", GEOMETRIES)
def test_fused_flat_write_matches_jax(cases, rope, D, page, int8, bias, strided):
    """The flat step: every token's rotated q (pads too) and the pool after
    the write; the pads past ``num_live`` store nothing."""
    c = cases("flat", rope, D, page, bias, int8)
    s = c["s"]
    q, k, v, b = port_inputs(c, D, strided)
    pool = t(c["data"]) if not int8 else (t(c["data"]), t(c["scales"]))
    got = ops.rope_write_kv_flat(
        pool, 1, q, k, v, t(c["cos"])[:, None], t(c["sin"])[:, None], t(s.pt), t(s.rows),
        t(s.positions[:, None]), torch.tensor([s.total], dtype=torch.int32), b)
    assert got.shape == (s.T, 1, NQ, D)
    close(got[:, 0].numpy(), c["want_q"])
    check_pool(c, pool, int8)
    pos = s.positions[: s.total]
    targets = set(zip(s.pt[s.rows[: s.total], pos // page].tolist(), (pos % page).tolist()))
    assert len(targets) == s.total
    untouched_outside(c, pool, targets)


@LAYOUTS
@BIAS
@POOL
@pytest.mark.parametrize("rope,D,page", GEOMETRIES)
def test_fused_decode_write_matches_jax(cases, rope, D, page, int8, bias, strided):
    """``Q == 1`` rows: every row's rotated q (pad rows too) and the pool
    after the write; rows with ``valid == 0`` (a garbage page) store
    nothing."""
    c = cases("decode", rope, D, page, bias, int8)
    s = c["s"]
    q, k, v, b = port_inputs(c, D, strided)
    pool = t(c["data"]) if not int8 else (t(c["data"]), t(c["scales"]))
    prep = (t(s.phys), t(s.offset), t(s.valid))
    got = ops.rope_write_kv_decode(pool, 1, q, k, v, t(c["cos"])[:, None], t(c["sin"])[:, None],
                                   prep, b)
    assert got.shape == (s.B, 1, NQ, D)
    close(got[:, 0].numpy(), c["want_q"])
    check_pool(c, pool, int8)
    live = s.valid > 0
    assert not live.all()
    untouched_outside(c, pool, set(zip(s.phys[live].tolist(), s.offset[live].tolist())))


@pytest.mark.parametrize("kind", ["flat", "decode", "prefill"])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
def test_the_model_writes_through_the_fused_entries(kind, qk_norm, monkeypatch):
    """A tiny model with q|k|v biases (and QK norm): the flat step and
    ``Q == 1`` rows write through the fused entries, one call a layer, with
    the biases (none with QK norm, which adds them before its norm); ``Q > 1``
    rows through ``write_kv_pages_full``. Each forward equals the one
    before this routing: biases, norm and ``apply_rope`` in the layer, then
    the store-only write."""
    import llmd_tpu_torch.config as tcfg
    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.common import StepInput, apply_rope, rope_tables

    cfg = tcfg.tiny_model_config(attention_bias=True, qk_norm=qk_norm, num_layers=2)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    for name in ("bq", "bk", "bv"):
        params["layers"][name] = 0.1 * torch.randn(params["layers"][name].shape, generator=gen)
    params = llama.fuse_projections(params)
    page, P = 4, 40
    rng = np.random.default_rng(5)
    pt = t(rng.permutation(P)[:32].reshape(4, 8).astype(np.int32))
    if kind == "flat":
        rows = np.asarray([r for r, (_, w) in enumerate(FLAT_ROWS) for _ in range(w)] + [3, 3], np.int32)
        pos = np.asarray([p for p0, w in FLAT_ROWS for p in range(p0, p0 + w)] + [0, 0], np.int32)
        total = len(rows) - 2
        inp = StepInput(token_ids=t(rng.integers(1, 200, size=(len(rows), 1)).astype(np.int64)),
                        positions=t(pos[:, None]), kv_lens=t(np.where(np.arange(len(rows)) < total, pos + 1, 0)),
                        page_table=pt, token_rows=t(rows), num_live=torch.tensor([total], dtype=torch.int32))
    else:
        Q = 1 if kind == "decode" else 3
        pos = np.asarray([[5 + i + q for q in range(Q)] for i in range(4)], np.int32)
        inp = StepInput(token_ids=t(rng.integers(1, 200, size=(4, Q)).astype(np.int64)),
                        positions=t(pos), kv_lens=t(pos[:, -1] + 1), page_table=pt,
                        query_lens=torch.tensor([Q, Q, 0, Q], dtype=torch.int32))
    shape = (cfg.num_layers, P, cfg.num_kv_heads, page, 2 * cfg.head_dim)
    pool = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    calls = []
    for name in ("rope_write_kv_flat", "rope_write_kv_decode", "write_kv_pages_full"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, functools.partial(
            lambda fn, name, *a, **kw: (calls.append((name, a[-1] if "rope" in name else None)), fn(*a, **kw))[1],
            fn, name))
    with torch.inference_mode():
        h, _ = llama.forward_hidden(params, work := pool.clone(), inp, cfg)
    entry = {"flat": "rope_write_kv_flat", "decode": "rope_write_kv_decode",
             "prefill": "write_kv_pages_full"}[kind]
    assert [n for n, _ in calls] == [entry] * cfg.num_layers
    if kind != "prefill":
        assert all((b is None) == qk_norm for _, b in calls)
    monkeypatch.undo()

    # The forward as it ran before the fused entries: the same layer body
    # with the biases, norm and rope in the layer and the store-only writes.
    def unfused_write(kv_cache, layer, q, k, v, bias):
        q, k, v = ops.add_qkv_bias(q, k, v, bias)
        cos, sin = rope_tables(inp.positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if inp.token_rows is not None:
            ops.write_kv_pages_full_flat(kv_cache, layer, k, v, inp.page_table, inp.token_rows,
                                         inp.positions, inp.num_live)
        else:
            ops.write_kv_pages_full(kv_cache, layer, k, v, inp.page_table, inp.positions, inp.valid)
        return q

    real = llama._write_attend

    def unfused(inp_, page_, cos, sin):
        _, attend = real(inp_, page_, cos, sin)
        return unfused_write, attend

    monkeypatch.setattr(llama, "_write_attend", unfused)
    with torch.inference_mode():
        h_ref, _ = llama.forward_hidden(params, ref := pool.clone(), inp, cfg)
    assert torch.equal(h, h_ref) and torch.equal(work, ref)
    assert not torch.equal(work, pool)
