"""The port's dense flat forward against the JAX package's, on the CPU.

The JAX ``init_params`` tree (made from a seed; biases and norm weights
randomised where the config carries them) is carried over with
``params_from_jax``; both packages then run ``forward_hidden`` on the same
flattened-token step over the same pool, and ``compute_logits`` on the
result. Tolerance: atol 1e-4 (f32; matmul and reduction order differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llmd_tpu.config as jcfg
from llmd_tpu.engine.runner import _fuse_projection_tree
from llmd_tpu.models import llama as jllama
from llmd_tpu.models.common import StepInput as JaxStepInput
import llmd_tpu_torch.config as tcfg
from llmd_tpu_torch.models import llama
from llmd_tpu_torch.models.common import StepInput

PAGE, NUM_PAGES = 4, 40
ROWS = ((5, 6), (12, 1), (0, 9), (3, 1))  # (pos0, qlen): prefills + decodes

CASES = {
    "base": {},
    "fused": {},
    "qk_norm": {"qk_norm": True},
    "attention_bias": {"attention_bias": True},
    "tied": {"tie_word_embeddings": True},
}


def jax_tree(case):
    cfg = jcfg.tiny_model_config(**CASES[case])
    params = jllama.init_params(cfg, jax.random.key(0))
    rng = np.random.default_rng(1)
    layers = dict(params["layers"])
    for name in ("bq", "bk", "bv", "attn_q_norm", "attn_k_norm", "input_norm"):
        if name in layers:  # non-trivial values for leaves that init as 0/1
            shape = layers[name].shape
            base = 1.0 if "norm" in name else 0.0
            layers[name] = jnp.asarray(base + 0.1 * rng.normal(size=shape), jnp.float32)
    params = {**params, "layers": layers}
    if case == "fused":
        params = _fuse_projection_tree(params)
    return cfg, jax.tree.map(np.asarray, params)


def step(rng, cfg):
    B = len(ROWS)
    tok_rows, positions = [], []
    for r, (p0, w) in enumerate(ROWS):
        tok_rows += [r] * w
        positions += range(p0, p0 + w)
    total = len(tok_rows)
    T = total + 5  # pad tokens after the live ones
    tok_rows += [B - 1] * (T - total)
    positions += [0] * (T - total)
    positions = np.asarray(positions, np.int32)
    live = np.arange(T) < total
    ids = np.where(live, rng.integers(0, cfg.vocab_size, size=T), 0).astype(np.int32)
    max_pages = cfg.max_model_len // PAGE
    pt = np.zeros((B, max_pages), np.int32)
    pt[:, :5] = rng.permutation(NUM_PAGES)[: B * 5].reshape(B, 5)
    return dict(
        ids=ids, positions=positions, live=live, total=total,
        kv_lens=np.where(live, positions + 1, 0).astype(np.int32),
        rows=np.asarray(tok_rows, np.int32), page_table=pt,
    )


@pytest.mark.parametrize("case", sorted(CASES))
def test_params_from_jax_is_a_copy(case):
    _, tree = jax_tree(case)
    params = llama.params_from_jax(tree)
    assert params.keys() == tree.keys()
    assert params["layers"].keys() == tree["layers"].keys()
    for name, leaf in tree["layers"].items():
        np.testing.assert_array_equal(params["layers"][name].numpy(), leaf)
    np.testing.assert_array_equal(params["embed"].numpy(), tree["embed"])
    assert ("wqkv" in params["layers"]) == (case == "fused")


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_logits_match_jax(case):
    cfg, tree = jax_tree(case)
    tconfig = tcfg.tiny_model_config(**CASES[case])
    rng = np.random.default_rng(2)
    s = step(rng, cfg)
    pool = rng.normal(size=(
        cfg.num_layers, NUM_PAGES, cfg.num_kv_heads, PAGE, 2 * cfg.head_dim
    )).astype(np.float32)

    jinp = JaxStepInput(
        token_ids=jnp.asarray(s["ids"][:, None]),
        positions=jnp.asarray(s["positions"][:, None]),
        query_lens=jnp.asarray(s["live"].astype(np.int32)),
        kv_lens=jnp.asarray(s["kv_lens"]),
        page_table=jnp.asarray(s["page_table"]),
        token_rows=jnp.asarray(s["rows"]),
    )
    jparams = jax.tree.map(jnp.asarray, tree)
    jh, jpool = jllama.forward_hidden(jparams, jnp.asarray(pool), jinp, cfg)
    jlogits = jllama.compute_logits(jparams, jh[:, 0], cfg)

    params = llama.params_from_jax(tree)
    inp = StepInput(
        token_ids=torch.from_numpy(s["ids"][:, None]),
        positions=torch.from_numpy(s["positions"][:, None]),
        kv_lens=torch.from_numpy(s["kv_lens"]),
        page_table=torch.from_numpy(s["page_table"]),
        token_rows=torch.from_numpy(s["rows"]),
        num_live=s["total"],
    )
    th, tpool = llama.forward_hidden(params, torch.from_numpy(pool.copy()), inp, tconfig)
    tlogits = llama.compute_logits(params, th[:, 0], tconfig)

    live = s["live"]
    np.testing.assert_allclose(th.numpy()[live], np.asarray(jh)[live], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        tlogits.numpy()[live], np.asarray(jlogits)[live], atol=1e-4, rtol=0
    )
    assert tlogits.dtype == torch.float32


def test_params_from_jax_keeps_bf16_bits():
    """A bf16 tree (the JAX engine's default dtype) arrives as torch
    bf16 with the same bits."""
    _, tree = jax_tree("fused")
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
    params = llama.params_from_jax(tree)
    for name, leaf in tree["layers"].items():
        got = params["layers"][name]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), leaf.view(np.int16))


def test_fuse_projections_is_exact():
    _, tree = jax_tree("base")
    params = llama.params_from_jax(tree)
    fused = llama.fuse_projections(params)
    lf = fused["layers"]
    assert "wq" not in lf and "w_gate" not in lf
    torch.testing.assert_close(
        lf["wqkv"], torch.cat([params["layers"][n] for n in ("wq", "wk", "wv")], -1),
        rtol=0, atol=0,
    )
    # The JAX runner's fusion of the same tree gives the same leaves.
    jf = jax.tree.map(np.asarray, _fuse_projection_tree(tree))
    np.testing.assert_array_equal(lf["w_gu"].numpy(), jf["layers"]["w_gu"])


def test_init_params_tree_and_seed():
    cfg = tcfg.tiny_model_config()
    jtree = jllama.init_params(jcfg.tiny_model_config(), jax.random.key(0))
    a = llama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = llama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert a["layers"].keys() == jtree["layers"].keys()
    for name, leaf in jtree["layers"].items():
        assert tuple(a["layers"][name].shape) == leaf.shape
        torch.testing.assert_close(a["layers"][name], b["layers"][name], rtol=0, atol=0)
    assert a["lm_head"].shape == (cfg.hidden_size, cfg.vocab_size)
