"""The port's MLA pieces and MoE/MLA forward against the JAX package's, on
the CPU.

The same inputs, made from a seed with numpy, go through the port's plain
PyTorch versions and the JAX functions: the latent decode attention against
JAX's Pallas kernel in interpret mode (``LLMD_PALLAS=interpret`` on the JAX
side only) at the geometry of ``tests/test_mla.py`` (rank 128, latent 256,
page 8), with and without a pad row; the ``Q > 1`` dense form; one MLA
attention layer at tiny-mla (decode and a prefill chunk); and the whole
forward (hidden states, logits, the written pool) of tiny-moe and tiny-mla
from the JAX ``init_params`` tree through ``params_from_jax``. f32
throughout; attention 2e-5, the forward 1e-4 (matmul and reduction order
over several layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llmd_tpu.ops as jops
from llmd_tpu.models import llama as jllama
from llmd_tpu.models import mla as jmla
from llmd_tpu.models.common import StepInput as JaxStepInput
from llmd_tpu.models.common import rope_tables as jax_rope_tables
from llmd_tpu.models.registry import get_model_config as jax_model
from llmd_tpu.ops.mla_attention import mla_paged_attention_xla as jax_mla_xla
from llmd_tpu_torch import ops
from llmd_tpu_torch.models import llama, mla
from llmd_tpu_torch.models.common import StepInput, rope_tables
from llmd_tpu_torch.models.registry import get_model_config

L, H, RANK, DL, PAGE, MAX_PAGES, NUM_PAGES = 2, 4, 128, 256, 8, 4, 32


def latent_inputs(seed=11, B=3, Q=1):
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((L, NUM_PAGES, 1, PAGE, DL)).astype(np.float32)
    q_eff = rng.standard_normal((B, Q, H, DL)).astype(np.float32)
    pt = (np.arange(B * MAX_PAGES).reshape(B, MAX_PAGES) % NUM_PAGES).astype(np.int32)
    return cache, q_eff, pt


@pytest.mark.parametrize("kv_lens", [(5, 17, 32), (0, 9, 32)], ids=["live", "pad_row"])
def test_mla_decode_matches_jax_interpret_kernel(monkeypatch, kv_lens):
    cache, q_eff, pt = latent_inputs()
    kv = np.asarray(kv_lens, np.int32)
    monkeypatch.setenv("LLMD_PALLAS", "interpret")
    want = np.asarray(jops.mla_paged_attention_full(
        jnp.asarray(q_eff), jnp.asarray(cache), jnp.int32(1), jnp.asarray(pt),
        jnp.asarray(kv), jnp.asarray((np.maximum(kv, 1) - 1)[:, None]),
        rank=RANK, sm_scale=0.11,
    ))
    t = [torch.from_numpy(a) for a in (q_eff, cache, pt, kv)]
    plain = ops.mla_decode_paged_attention_plain(t[0], t[1], 1, t[2], t[3], RANK, 0.11)
    full = ops.mla_paged_attention_full(
        t[0], t[1], 1, t[2], t[3], torch.from_numpy(np.maximum(kv, 1) - 1)[:, None], RANK, 0.11
    )
    assert plain.shape == (3, 1, H, RANK)
    np.testing.assert_allclose(plain.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(full.numpy(), want, rtol=2e-5, atol=2e-5)
    assert not plain[kv == 0].any()  # a pad row is exactly zero
    # Live pages only: the same result from a gather of the live columns.
    bounded = ops.mla_decode_paged_attention_plain(t[0], t[1], 1, t[2], t[3], RANK, 0.11, 4)
    np.testing.assert_array_equal(bounded.numpy(), plain.numpy())


def test_mla_prefill_form_matches_jax():
    """``Q > 1`` rows: the dense form, as JAX computes it outside any
    kernel; the entry's ``live_pages`` bound gives the same values."""
    cache, q_eff, pt = latent_inputs(B=2, Q=5)
    kv = np.asarray([9, 30], np.int32)
    positions = (kv[:, None] - 5 + np.arange(5)[None, :]).astype(np.int32)
    want = np.asarray(jax_mla_xla(
        jnp.asarray(q_eff), jnp.asarray(cache[1]), jnp.asarray(pt), jnp.asarray(kv),
        jnp.asarray(positions), rank=RANK, sm_scale=0.09,
    ))
    t = [torch.from_numpy(a) for a in (q_eff, cache, pt, kv, positions)]
    got = ops.mla_paged_attention_xla(t[0], t[1][1], t[2], t[3], t[4], RANK, 0.09)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    live = ops.mla_paged_attention_full(t[0], t[1], 1, t[2], t[3], t[4], RANK, 0.09, live_pages=4)
    np.testing.assert_allclose(live.numpy(), want, rtol=2e-5, atol=2e-5)


def bucketed_step(rng, rows, page, vocab, max_pages):
    """Bucketed [B, Q] step of (start, width) rows with distinct pages."""
    B, Q = len(rows), max(w for _, w in rows)
    tokens = np.zeros((B, Q), np.int32)
    positions = np.zeros((B, Q), np.int32)
    qlens = np.zeros(B, np.int32)
    kvlens = np.zeros(B, np.int32)
    pt = np.zeros((B, max_pages), np.int32)
    perm = rng.permutation(B * max_pages)
    for i, (start, w) in enumerate(rows):
        tokens[i, :w] = rng.integers(0, vocab, size=w)
        positions[i, :w] = np.arange(start, start + w)
        positions[i, w:] = start + w - 1
        qlens[i], kvlens[i] = w, start + w
        pt[i] = perm[i * max_pages : (i + 1) * max_pages]
    return dict(token_ids=tokens, positions=positions, query_lens=qlens,
                kv_lens=kvlens, page_table=pt)


def inputs(s, live_pages=None):
    j = JaxStepInput(**{k: jnp.asarray(v) for k, v in s.items()})
    t = StepInput(**{k: torch.from_numpy(v.copy()) for k, v in s.items()}, live_pages=live_pages)
    return j, t


def jax_tree(name, seed=0):
    cfg = jax_model(name)
    params = jllama.init_params(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed + 1)
    # Non-trivial values for the leaves that initialise as ones.
    for stack in ("layers", "dense_layers"):
        if stack in params:
            params[stack] = {
                k: (1.0 + 0.1 * rng.normal(size=v.shape)).astype(np.float32) if "norm" in k else v
                for k, v in params[stack].items()
            }
    return cfg, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("rows", [((7, 1), (0, 1), (12, 1)), ((0, 6), (9, 3))], ids=["decode", "prefill"])
def test_mla_attention_matches_jax(rows):
    cfg, tree = jax_tree("tiny-mla")
    tcfg = get_model_config("tiny-mla")
    rng = np.random.default_rng(5)
    page, max_pages, P = 4, 8, 32
    s = bucketed_step(rng, rows, page, cfg.vocab_size, max_pages)
    s["page_table"] %= P
    jinp, tinp = inputs(s)
    lp = {k: v[0] for k, v in tree["layers"].items()}
    h = rng.normal(size=(*s["token_ids"].shape, cfg.hidden_size)).astype(np.float32)
    pool = rng.normal(size=(cfg.num_layers, P, 1, page, cfg.kv_cache_entry_dim)).astype(np.float32)
    cos, sin = jax_rope_tables(jinp.positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    jout, jpool = jax.jit(lambda h, lp, pool, inp, cos, sin: jmla.mla_attention(
        h, lp, pool, jnp.int32(1), inp, cfg, cos, sin,
    ))(jnp.asarray(h), {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(pool), jinp, cos, sin)
    tcos, tsin = rope_tables(tinp.positions, tcfg.qk_rope_head_dim, tcfg.rope_theta)
    tout, tpool = mla.mla_attention(
        torch.from_numpy(h), {k: torch.from_numpy(v.copy()) for k, v in lp.items()},
        torch.from_numpy(pool.copy()), 1, tinp, tcfg, tcos, tsin,
    )
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["tiny-moe", "tiny-mla"])
@pytest.mark.parametrize("rows", [((5, 6), (12, 1), (0, 9)), ((7, 1), (15, 1), (0, 1))],
                         ids=["mixed", "decode"])
def test_forward_and_logits_match_jax(name, rows):
    """The bucketed forward (MLA's only layout) with JAX's default MoE
    backend, "grouped"; hidden states, logits and the written pool."""
    cfg, tree = jax_tree(name)
    tcfg = get_model_config(name)
    rng = np.random.default_rng(2)
    page, max_pages, P = 4, 8, 40
    s = bucketed_step(rng, rows, page, cfg.vocab_size, max_pages)
    s["page_table"] %= P
    jinp, tinp = inputs(s, live_pages=int(-(-s["kv_lens"].max() // page)))
    shape = (cfg.num_layers, P, cfg.kv_cache_heads, page, cfg.kv_cache_entry_dim)
    pool = rng.normal(size=shape).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    jh, jpool, jlogits = jax.jit(lambda params, pool, inp: (
        lambda h, pool: (h, pool, jllama.compute_logits(params, h.reshape(-1, cfg.hidden_size), cfg))
    )(*jllama.forward_hidden(params, pool, inp, cfg, moe_backend="grouped")))(
        jparams, jnp.asarray(pool), jinp)
    params = llama.params_from_jax(tree)
    th, tpool = llama.forward_hidden(params, torch.from_numpy(pool.copy()), tinp, tcfg)
    tlogits = llama.compute_logits(params, th.reshape(-1, tcfg.hidden_size), tcfg)
    live = (np.arange(s["token_ids"].shape[1])[None, :] < s["query_lens"][:, None]).reshape(-1)
    np.testing.assert_allclose(
        th.reshape(-1, tcfg.hidden_size).numpy()[live],
        np.asarray(jh).reshape(-1, cfg.hidden_size)[live], atol=1e-4, rtol=0,
    )
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tlogits.numpy()[live], np.asarray(jlogits)[live], atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["tiny-moe", "tiny-mla"])
def test_init_params_tree_matches_jax(name):
    """The port draws the JAX tree: the same leaves (``dense_layers``, MLA
    and expert leaves included) at the same shapes, reproducible from a
    seed."""
    _, jtree = jax_tree(name)
    cfg = get_model_config(name)
    a = llama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = llama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert a.keys() == jtree.keys()
    for stack in ("layers", "dense_layers"):
        if stack not in jtree:
            continue
        assert a[stack].keys() == jtree[stack].keys()
        for k, leaf in jtree[stack].items():
            assert tuple(a[stack][k].shape) == leaf.shape, (stack, k)
            assert torch.equal(a[stack][k], b[stack][k])


def test_params_from_jax_carries_dense_layers():
    """tiny-mla's dense first layer lives under ``dense_layers``: the copy
    recurses into it, leaf for leaf."""
    _, tree = jax_tree("tiny-mla")
    params = llama.params_from_jax(tree)
    assert set(params) == set(tree) and "dense_layers" in params
    for stack in ("layers", "dense_layers"):
        assert params[stack].keys() == tree[stack].keys()
        for k, leaf in tree[stack].items():
            np.testing.assert_array_equal(params[stack][k].numpy(), leaf)
    assert "w_gate" in params["dense_layers"] and "we_gate" in params["layers"]
