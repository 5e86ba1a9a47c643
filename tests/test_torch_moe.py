"""The port's MoE pieces against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, go through the port's plain
PyTorch versions and the JAX functions: the router in every variant the
configs use, the grouped matmul against JAX's ``grouped_matmul`` in
``megablox.gmm``'s interpret mode (``LLMD_PALLAS=interpret`` on the JAX side
only) and against ``lax.ragged_dot``, and the whole grouped MoE block at
tiny-moe (JAX's ragged_dot path) and at a lane-tiled geometry where JAX runs
the interpret kernel. f32 throughout. Tolerances: the router and the
ragged_dot block 2e-5 (matmul order), the interpret kernel 2e-4 (it tiles
the contraction, as ``tests/test_wide_ep.py`` holds it to ``ragged_dot``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llmd_tpu.config as jcfg
import llmd_tpu_torch.config as tcfg
from llmd_tpu.models import llama as jllama
from llmd_tpu.models import moe as jmoe
from llmd_tpu.ops.grouped_gemm import grouped_matmul as jax_grouped_matmul
from llmd_tpu.ops.grouped_gemm import moe_apply_grouped as jax_moe_apply_grouped
from llmd_tpu_torch import ops
from llmd_tpu_torch.models import moe

# The router variants of tests/test_wide_ep.py (Mixtral softmax top-k,
# with a shared expert, DeepSeek-V3 sigmoid with group top-2) and DeepSeek-
# V2's group max without renormalisation.
VARIANTS = {
    "softmax": {},
    "shared_expert": {"shared_expert_intermediate_size": 32},
    "sigmoid_group_top2": {
        "router_scoring": "sigmoid", "topk_method": "group_top2",
        "n_group": 2, "topk_group": 1, "routed_scaling_factor": 2.5,
    },
    "group_max_unnormalised": {
        "topk_method": "group_max", "n_group": 4, "topk_group": 2,
        "norm_topk_prob": False, "routed_scaling_factor": 1.5,
    },
}


def configs(variant, **geometry):
    kw = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
              **geometry, **VARIANTS[variant])
    return jcfg.tiny_model_config(**kw), tcfg.tiny_model_config(**kw)


def layer_params(jc, seed):
    """One MoE layer's leaves (router, experts, shared expert) from the JAX
    init, as numpy; a sigmoid router gets a random correction bias."""
    lp = jllama.init_params(jc, jax.random.key(seed))["layers"]
    lp = {k: np.array(v[0]) for k, v in lp.items() if k.startswith(("router", "we_", "ws_"))}
    if jc.router_scoring == "sigmoid":
        lp["router_bias"] = (np.random.default_rng(seed).normal(size=jc.num_experts) * 0.1).astype(np.float32)
    return lp


def both(lp):
    return ({k: jnp.asarray(v) for k, v in lp.items()},
            {k: torch.from_numpy(v.copy()) for k, v in lp.items()})


@pytest.mark.parametrize("variant", sorted(VARIANTS) + ["no_config"])
def test_router_topk_matches_jax(variant):
    jc, tc = configs("softmax" if variant == "no_config" else variant)
    lp = layer_params(jc, 1)
    h = np.random.default_rng(2).normal(size=(23, jc.hidden_size)).astype(np.float32)
    bias = lp.get("router_bias")
    if variant == "no_config":
        jw, jids = jmoe.router_topk(jnp.asarray(h), jnp.asarray(lp["router"]), 2)
        tw, tids = moe.router_topk(torch.from_numpy(h), torch.from_numpy(lp["router"]), 2)
    else:
        jw, jids = jmoe.router_topk(jnp.asarray(h), jnp.asarray(lp["router"]), 2, jc,
                                    None if bias is None else jnp.asarray(bias))
        tw, tids = moe.router_topk(torch.from_numpy(h), torch.from_numpy(lp["router"]), 2, tc,
                                   None if bias is None else torch.from_numpy(bias))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=2e-5, atol=2e-5)
    assert tw.dtype == torch.float32


def group_sizes(rng, rows, G, empty=()):
    sizes = np.zeros(G, np.int64)
    live = [g for g in range(G) if g not in empty]
    for i in rng.integers(0, len(live), rows):
        sizes[live[i]] += 1
    return sizes


# rows of the grouped matmul (4 < sublane, 30 unaligned, 192 > one
# 128-row tile), and one layout whose middle groups are empty.
GMM_CASES = {"4": (4, ()), "30": (30, ()), "48": (48, ()), "192": (192, ()),
             "empty_groups": (40, (1, 2))}


@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_grouped_matmul_plain_matches_jax_interpret_kernel(monkeypatch, case):
    rows, empty = GMM_CASES[case]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((rows, 128)).astype(np.float32)
    w = rng.standard_normal((4, 128, 128)).astype(np.float32)
    sizes = group_sizes(rng, rows, 4, empty)
    gs = jnp.asarray(sizes, jnp.int32)
    ref = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), gs)
    monkeypatch.setenv("LLMD_PALLAS", "interpret")
    kernel = jax_grouped_matmul(jnp.asarray(x), jnp.asarray(w), gs)
    got = ops.grouped_matmul(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(sizes.astype(np.int32))
    )
    assert got.shape == (rows, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    assert ops.grouped_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(sizes)).equal(got)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_block_grouped_matches_jax_at_tiny_moe(variant):
    """tiny-moe widths (H 64, F 64): JAX takes ``lax.ragged_dot``."""
    jc, tc = configs(variant)
    jlp, tlp = both(layer_params(jc, 4))
    h = np.random.default_rng(6).normal(size=(3, 5, jc.hidden_size)).astype(np.float32)
    want = jmoe.moe_block_grouped(jnp.asarray(h), jlp, jc)
    got = moe.moe_block_grouped(torch.from_numpy(h), tlp, tc)
    assert got.shape == h.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("variant", ["softmax", "shared_expert"])
def test_moe_block_grouped_matches_jax_interpret_kernel(monkeypatch, variant):
    """The lane-tiled geometry of tests/test_wide_ep.py (H = F = 128, top-3
    of 4, 65 tokens): JAX runs ``megablox.gmm`` in interpret mode."""
    geometry = dict(hidden_size=128, num_heads=4, num_kv_heads=2, intermediate_size=128)
    kw = dict(geometry, num_experts=4, num_experts_per_tok=3, moe_intermediate_size=128,
              **VARIANTS[variant])
    jc, tc = jcfg.tiny_model_config(**kw), tcfg.tiny_model_config(**kw)
    jlp, tlp = both(layer_params(jc, 8))
    h = np.random.default_rng(9).normal(size=(5, 13, 128)).astype(np.float32)
    monkeypatch.setenv("LLMD_PALLAS", "interpret")
    want = jmoe.moe_block_grouped(jnp.asarray(h), jlp, jc)
    got = moe.moe_block_grouped(torch.from_numpy(h), tlp, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_moe_apply_combines_in_jax_order(monkeypatch):
    """With the same expert outputs on both sides, the port's sort, group
    count and combine give JAX's f32 sums bit for bit: each token's rows
    are added in ascending sorted position, from zero, as JAX's scatter-add
    adds them on the CPU."""
    import llmd_tpu.ops.grouped_gemm as jgg
    import llmd_tpu_torch.ops.grouped_gemm as tgg

    rng = np.random.default_rng(3)
    T, k, E, H, Fm = 17, 3, 5, 16, 8
    ht = rng.normal(size=(T, H)).astype(np.float32)
    ids = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    weights = rng.random(size=(T, k)).astype(np.float32)
    we = [rng.normal(size=s).astype(np.float32) for s in ((E, H, Fm), (E, H, Fm), (E, Fm, H))]
    ys = rng.normal(size=(T * k, H)).astype(np.float32)  # rows in sorted order
    seen = {}

    def fixed(framework, to):
        def expert_mlp_grouped(x_sorted, sizes, *args, **kwargs):
            seen[framework] = np.asarray(sizes)
            return to(ys)
        return expert_mlp_grouped

    monkeypatch.setattr(jgg, "expert_mlp_grouped", fixed("jax", jnp.asarray))
    monkeypatch.setattr(tgg, "expert_mlp_grouped", fixed("torch", torch.from_numpy))
    want = jax_moe_apply_grouped(*(jnp.asarray(a) for a in (ht, weights, ids, *we)))
    got = moe.moe_apply_grouped(*(torch.from_numpy(a) for a in (ht, weights, ids, *we)))
    np.testing.assert_array_equal(seen["torch"], seen["jax"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
