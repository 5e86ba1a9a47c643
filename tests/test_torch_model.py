"""The port's dense flat forward against the JAX package's, on the CPU.

The JAX ``init_params`` tree (made from a seed; biases and norm weights
randomised where the config carries them) is carried over with
``params_from_jax``; both packages then run ``forward_hidden`` on the same
flattened-token step over the same pool, and ``compute_logits`` on the
result. Tolerance: atol 1e-4 (f32; matmul and reduction order differ).
The same holds for ``tiny-swa`` and a tiny gpt-oss configuration (sliding
windows, sinks, q|k|v and o biases, yarn rope, biased clamped-SwiGLU
experts with a router logit bias), each on a float and an int8 pool, on
the flat step and on a bucketed decode step.
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


# A gpt-oss-shaped tiny configuration (no registry entry; the same kwargs
# build either package's config): alternating sliding (window 8) and full
# layers, sinks, q|k|v and o biases, yarn rope from 32 positions, 4
# experts top-2 with clamped SwiGLU, expert biases and a router logit bias.
TINY_OSS = dict(
    name="tiny-oss", sliding_window=8,
    layer_types=("sliding_attention", "full_attention"),
    attention_bias=True, attention_out_bias=True, attention_sinks=True,
    rope_scaling={"rope_type": "yarn", "factor": 4.0, "beta_fast": 32.0,
                  "beta_slow": 1.0, "original_max_position_embeddings": 32},
    num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64,
    moe_activation="swiglu_oss", router_logit_bias=True,
)
# Leaves the JAX init draws as zeros or ones; the trees here carry seeded
# random values instead, so a dropped bias or norm shows.
RANDOMISED = ("bq", "bk", "bv", "bo", "router_bias", "we_gate_b", "we_up_b",
              "we_down_b", "attn_q_norm", "attn_k_norm", "input_norm")


def randomise(params, seed=1):
    rng = np.random.default_rng(seed)
    layers = dict(params["layers"])
    for name in RANDOMISED:
        if name in layers:  # non-trivial values for leaves that init as 0/1
            shape = layers[name].shape
            base = 1.0 if "norm" in name else 0.0
            layers[name] = jnp.asarray(base + 0.1 * rng.normal(size=shape), jnp.float32)
    return {**params, "layers": layers}


def jax_tree(case):
    cfg = jcfg.tiny_model_config(**CASES[case])
    params = randomise(jllama.init_params(cfg, jax.random.key(0)))
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
        num_live=torch.tensor([s["total"]], dtype=torch.int32),
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


def test_fuse_projections_keeps_sinks_in_f32():
    """The sinks leaf leaves ``fuse_projections`` in f32, the attention
    kernels' type, with the bf16 values unchanged: the forward then casts
    nothing per layer."""
    cfg = tcfg.tiny_model_config(attention_sinks=True, dtype="bfloat16")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sinks = params["layers"]["sinks"]
    assert sinks.dtype == torch.bfloat16
    fused = llama.fuse_projections(params)["layers"]["sinks"]
    assert fused.dtype == torch.float32
    assert torch.equal(fused, sinks.float())
    layer_sinks = fused[1]
    assert layer_sinks.float() is layer_sinks and layer_sinks.is_contiguous()


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


OSS_CONFIGS = {"tiny-swa": dict(name="tiny-swa", sliding_window=8,
                                layer_types=("sliding_attention", "full_attention")),
               "tiny-oss": TINY_OSS}


def oss_pool(rng, cfg, int8):
    shape = (cfg.num_layers, NUM_PAGES, cfg.num_kv_heads, PAGE, 2 * cfg.head_dim)
    if not int8:
        return rng.normal(size=shape).astype(np.float32), None
    data = rng.integers(-127, 128, size=shape).astype(np.int8)
    scales = rng.uniform(0.004, 0.016, size=(*shape[:4], 2))
    return data, scales.astype(np.float16).astype(np.float32)


@pytest.mark.parametrize("pool_dtype", ["float32", "int8"])
@pytest.mark.parametrize("config", sorted(OSS_CONFIGS))
def test_window_sink_int8_forward_matches_jax(config, pool_dtype):
    """Flat step and bucketed decode step (Q = 1) with windows shorter
    than the rows' contexts: hidden states, logits and the written pool
    (int8 data bit-equal, scales equal) against JAX's."""
    kw = OSS_CONFIGS[config]
    cfg, tconfig = jcfg.tiny_model_config(**kw), tcfg.tiny_model_config(**kw)
    assert tconfig.layer_windows == cfg.layer_windows == (8, 0)
    tree = randomise(jllama.init_params(cfg, jax.random.key(3)), seed=4)
    if "sinks" in tree["layers"]:
        assert tree["layers"]["sinks"].any()
    tree = jax.tree.map(np.asarray, _fuse_projection_tree(tree))
    params = llama.params_from_jax(tree)
    rng = np.random.default_rng(5)
    s = step(rng, cfg)
    data, scales = oss_pool(rng, cfg, pool_dtype == "int8")

    def jpool():
        return jnp.asarray(data) if scales is None else (jnp.asarray(data), jnp.asarray(scales))

    def tpool():
        d = torch.from_numpy(data.copy())
        return d if scales is None else (d, torch.from_numpy(scales.copy()))

    # The flat step.
    jinp = JaxStepInput(
        token_ids=jnp.asarray(s["ids"][:, None]), positions=jnp.asarray(s["positions"][:, None]),
        query_lens=jnp.asarray(s["live"].astype(np.int32)), kv_lens=jnp.asarray(s["kv_lens"]),
        page_table=jnp.asarray(s["page_table"]), token_rows=jnp.asarray(s["rows"]),
    )
    inp = StepInput(
        token_ids=torch.from_numpy(s["ids"][:, None]), positions=torch.from_numpy(s["positions"][:, None]),
        kv_lens=torch.from_numpy(s["kv_lens"]), page_table=torch.from_numpy(s["page_table"]),
        token_rows=torch.from_numpy(s["rows"]), num_live=torch.tensor([s["total"]], dtype=torch.int32),
    )
    # A bucketed decode step: one token a row at contexts 3-20, a pad row.
    kv_lens = np.array([12, 3, 20, 0], np.int32)
    pos = np.maximum(kv_lens - 1, 0).astype(np.int32)[:, None]
    ids = rng.integers(0, cfg.vocab_size, size=(4, 1)).astype(np.int32)
    qlens = (kv_lens > 0).astype(np.int32)
    jdec = JaxStepInput(token_ids=jnp.asarray(ids), positions=jnp.asarray(pos),
                        query_lens=jnp.asarray(qlens), kv_lens=jnp.asarray(kv_lens),
                        page_table=jnp.asarray(s["page_table"]))
    dec = StepInput(token_ids=torch.from_numpy(ids), positions=torch.from_numpy(pos),
                    kv_lens=torch.from_numpy(kv_lens), page_table=torch.from_numpy(s["page_table"]),
                    query_lens=torch.from_numpy(qlens))
    jparams = jax.tree.map(jnp.asarray, tree)
    for (ji, ti, live) in ((jinp, inp, s["live"]), (jdec, dec, kv_lens > 0)):
        jh, jp = jllama.forward_hidden(jparams, jpool(), ji, cfg, moe_backend="grouped")
        jlogits = jllama.compute_logits(jparams, jh.reshape(-1, jh.shape[-1]), cfg)
        th, tp = llama.forward_hidden(params, tpool(), ti, tconfig)
        tlogits = llama.compute_logits(params, th.reshape(-1, th.shape[-1]), tconfig)
        np.testing.assert_allclose(
            th.reshape(-1, th.shape[-1]).numpy()[live],
            np.asarray(jh).reshape(-1, jh.shape[-1])[live], atol=1e-4, rtol=0)
        np.testing.assert_allclose(tlogits.numpy()[live], np.asarray(jlogits)[live],
                                   atol=1e-4, rtol=0)
        if scales is None:
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4, rtol=0)
        else:
            # Quantized from K|V that agree to ~1e-6 (a row could land on a
            # neighbouring level; these inputs land on the same ones).
            np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp[0]))
            np.testing.assert_array_equal(tp[1].numpy(), np.asarray(jp[1]))
