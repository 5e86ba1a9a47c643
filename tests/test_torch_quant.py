"""int8 weights (W8A8, ``llmd_tpu_torch/ops/quant.py``) against the JAX
package's (``llmd_tpu/ops/quant.py``), on the CPU.

The same numpy inputs from a seed go through both packages. Bit for bit
(``torch.equal`` on the float outputs, f32 and bf16): ``quantize_weight``,
``quantize_activations``, ``qdot``, ``grouped_matmul_q`` (an empty group
included) and ``dequantize``; the host quantizer against the device one;
the int8 trees (names, shapes, dtypes; the port's ``init_params`` under
int8 is ``quantize_param_tree`` of its float draw, fused or not) and the
fused scales against ``_fuse_projection_tree``. The port keeps its int8
leaves K-major (``[..., out, in]``), JAX ``[..., in, out]``: every int8
leaf is held to JAX's through ``.mT`` (``jax_layout``). The forward of an int8
model from the JAX int8 tree (``params_from_jax``): tiny (flat step),
tiny-moe and tiny gpt-oss (flat step), tiny-mla (bucketed), logits within
the forward tests' 1e-4. The greedy and seeded streams of the int8
engines equal the JAX int8 engines' on tiny, tiny-moe, tiny-mla and tiny
gpt-oss, in the step layouts each runs, and once on the int8 KV pool. The
int8 loader is in ``tests/test_torch_loader.py`` (its checkpoints are
saved there once a module), the server flag in
``tests/test_torch_serve_flags.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llmd_tpu.config as jcfg
import llmd_tpu_torch.config as tcfg
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine import SamplingParams as JaxSP
from llmd_tpu.engine.runner import _fuse_projection_tree
from llmd_tpu.models import llama as jllama
from llmd_tpu.models.common import StepInput as JaxStepInput
from llmd_tpu.models.registry import get_model_config as jax_model_config
from llmd_tpu.ops import quant as jquant
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.models import llama
from llmd_tpu_torch.models.common import StepInput
from llmd_tpu_torch.models.registry import get_model_config
from llmd_tpu_torch.ops import quant
from test_torch_mla import bucketed_step
from test_torch_model import NUM_PAGES, PAGE, TINY_OSS, step

FWD_ATOL = 1e-4  # the forward tests' tolerance (f32; summation order)
MODELS = {"tiny": "tiny", "tiny-moe": "tiny-moe", "tiny-mla": "tiny-mla", "tiny-oss": TINY_OSS}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(model, **over):
    """(JAX config, port config) of a registry name or tiny kwargs."""
    if isinstance(model, dict):
        return (jcfg.tiny_model_config(**model, **over), tcfg.tiny_model_config(**model, **over))
    return jax_model_config(model, **over), get_model_config(model, **over)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def to_np(x: torch.Tensor) -> np.ndarray:
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def from_jax(a) -> torch.Tensor:
    """A JAX array as a torch tensor with the same bits (bf16 included)."""
    return llama.params_from_jax({"x": np.asarray(a)})["x"]


def assert_same(got: torch.Tensor, want) -> None:
    want = from_jax(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def jax_layout(leaves: dict) -> dict:
    """Flat leaves (tensors or numpy arrays) in JAX's layout: each int8
    leaf beside a ``_scale`` read through ``.mT``."""
    def mt(k, v):
        if str(v.dtype).split(".")[-1] != "int8" or k + "_scale" not in leaves:
            return v
        return v.mT if isinstance(v, torch.Tensor) else np.swapaxes(v, -1, -2)
    return {k: mt(k, v) for k, v in leaves.items()}


def activations(rng, shape, dtype):
    """Rows at scales from 1e-3 to 1e2 with exact ties (k + 0.5 times the
    row's scale), an all-zero row and the row maximum at both signs."""
    x = rng.normal(size=shape).astype(np.float32) * rng.uniform(1e-3, 1e2, size=(*shape[:-1], 1))
    x = x.astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    amax = np.abs(flat[1]).max()
    s = np.float32(amax) / np.float32(127.0)
    flat[1, :4] = [s * 2.5, -s * 2.5, s * 126.5, -amax]
    return jnp.asarray(x, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 96), (3, 32, 48)])
def test_quantize_weight_matches_jax(shape, dtype):
    rng = np.random.default_rng(1)
    w = np.asarray(rng.normal(size=shape), np.float32)
    w[..., 5] = 0.0  # an all-zero column: scale 1e-30 / 127, data 0
    jw = jnp.asarray(w, dtype)
    jq, js = jquant.quantize_weight(jw)
    q, s = quant.quantize_weight(from_jax(jw))
    assert_same(q, jq)
    assert_same(s, js)
    back = quant.dequantize(q, s, dtype=getattr(torch, dtype))
    assert_same(back, jquant.dequantize(jq, js, dtype=getattr(jnp, dtype)))
    # Written K-major into (non-contiguous) views a few columns at a time,
    # from w as it lies or through the .T of its [out, in] copy: the same bits.
    so = torch.zeros((*shape[:-2], shape[-1]), dtype=torch.float32)
    for w_in in (from_jax(jw), from_jax(jw).mT.contiguous().mT):
        qo = torch.zeros((*shape[:-2], shape[-1] + 16, shape[-2]), dtype=torch.int8)[..., 8 : 8 + shape[-1], :]
        quant.quantize_weight_into(w_in, qo, so, block=5 * shape[-2])
        assert torch.equal(qo.mT, q) and torch.equal(so, s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_matches_jax(dtype):
    x = activations(np.random.default_rng(2), (2, 7, 64), dtype)
    jq, js = jquant.quantize_activations(x)
    q, s = quant.quantize_activations(from_jax(x))
    assert_same(q, jq)
    assert_same(s, js)
    assert (q.reshape(-1, 64)[0] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qdot_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = activations(rng, (5, 3, 80), dtype)
    jq, js = jquant.quantize_weight(jnp.asarray(rng.normal(size=(80, 48)), dtype))
    want = jquant.qdot(x, jq, js)
    got = quant.qdot(from_jax(x), from_jax(jq).mT.contiguous(), from_jax(js))
    assert_same(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_q_matches_jax(dtype):
    rng = np.random.default_rng(4)
    sizes = np.array([3, 0, 7, 1, 5], np.int32)  # group 1 empty
    x = activations(rng, (int(sizes.sum()), 64), dtype)
    jq, js = jquant.quantize_weight(jnp.asarray(rng.normal(size=(5, 64, 32)), dtype))
    want = jquant.grouped_matmul_q(x, jq, js, jnp.asarray(sizes))
    gs = t(sizes)
    wq = from_jax(jq).mT.contiguous()  # K-major [G, N, K]
    got = quant.grouped_matmul_q(from_jax(x), wq, from_jax(js), gs)
    assert_same(got, want)
    # The pair: one quantized input, two weight tensors; each as one call.
    xq, a_scale = quant.quantize_rows(from_jax(x))
    pair = quant.grouped_gemm.grouped_matmul_q8_pair(
        xq, a_scale, wq, from_jax(js), wq.flip(1).contiguous(),
        from_jax(js).flip(1).contiguous(), gs, getattr(torch, dtype))
    assert torch.equal(pair[0], got)
    assert torch.equal(pair[1], quant.grouped_matmul_q(
        from_jax(x), wq.flip(1).contiguous(), from_jax(js).flip(1).contiguous(), gs))


def jax_float_tree(model, seed=0):
    jc, _ = configs(model)
    return jax.tree.map(np.asarray, jllama.init_params(jc, jax.random.key(seed)))


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("model", sorted(MODELS))
def test_quantized_trees_match_jax(model):
    """The JAX int8 ``init_params`` tree and the port's have the same leaves
    (a ``_scale`` beside each QUANT_NAMES leaf, MLA's ``wkv_b`` float) at
    the same shapes and dtypes; the port's int8 draw is
    ``quantize_param_tree`` of its float draw, unfused and fused (then
    ``fuse_projections`` of it, whose sinks are f32); the host
    quantizer equals the device one and the JAX package's."""
    jc8, tc8 = configs(MODELS[model], quantization="int8")
    jtree = dict(flat(jax.eval_shape(lambda k: jllama.init_params(jc8, k), jax.random.key(0))))
    _, tc = configs(MODELS[model])
    for fused in (False, True):
        got = llama.init_params(tc8, torch.Generator().manual_seed(5), "cpu", fused=fused)
        ref = quant.quantize_param_tree(
            llama.init_params(tc, torch.Generator().manual_seed(5), "cpu"))
        if fused and not tc.is_mla:  # the fused draw is fuse_projections' tree
            ref = llama.fuse_projections(ref)
        assert dict(flat(got)).keys() == dict(flat(ref)).keys()
        for k, v in flat(ref):
            assert torch.equal(dict(flat(got))[k], v), k
        if not fused:
            got = jax_layout(dict(flat(got)))
            assert got.keys() == jtree.keys()
            for k, v in jtree.items():
                assert (tuple(got[k].shape), str(got[k].dtype).split(".")[-1]) == (v.shape, v.dtype.name), k
    assert ("layers.wkv_b_scale" in jtree) is False
    tree = jax_float_tree(MODELS[model])
    host, jhost = quant.quantize_param_tree_host(tree), jquant.quantize_param_tree_host(tree)
    dev = quant.quantize_param_tree(llama.params_from_jax(tree))
    host, dev = jax_layout(dict(flat(host))), jax_layout(dict(flat(dev)))
    assert host.keys() == dev.keys() == dict(flat(jhost)).keys()
    for k, v in flat(jhost):
        assert host[k].shape == v.shape and host[k].dtype == v.dtype, k
        np.testing.assert_array_equal(host[k], v)
        assert torch.equal(dev[k], t(v)), k


def test_fused_scales_match_jax():
    """``fuse_projections`` of an int8 tree concatenates the scales as
    ``_fuse_projection_tree`` does, and quantizing the fused float leaf
    gives the same bits (the scales are per column)."""
    tree = jax_float_tree("tiny")
    jfused = jax.tree.map(np.asarray, _fuse_projection_tree(
        jquant.quantize_param_tree(jax.tree.map(jnp.asarray, tree))))
    got = llama.fuse_projections(llama.params_from_jax(jquant.quantize_param_tree_host(tree)))
    flat_got = jax_layout(dict(flat(got)))
    assert flat_got.keys() == dict(flat(jfused)).keys()
    for k, v in flat(jfused):
        assert torch.equal(flat_got[k], t(v)), k
    assert "layers.wqkv_scale" in flat_got and "layers.w_gu_scale" in flat_got
    fused_first = quant.quantize_param_tree(llama.fuse_projections(llama.params_from_jax(tree)))
    for name in ("wqkv", "w_gu"):
        q, s = quant.quantize_weight(llama.fuse_projections(llama.params_from_jax(tree))["layers"][name])
        assert torch.equal(q.mT, got["layers"][name]) and torch.equal(s, got["layers"][name + "_scale"])
    assert "wqkv" not in quant.QUANT_NAMES and "wqkv_scale" not in fused_first["layers"]


def test_square_int8_leaves_cross_from_jax_transposed():
    """A square int8 leaf (gpt-oss's 2,880 x 2,880 experts, llama's wo)
    looks the same in both layouts, so the wrappers cannot refuse JAX's:
    ``params_from_jax`` transposes every int8 leaf beside a ``_scale``,
    square or not, and leaves an int8 leaf without one as it is."""
    rng = np.random.default_rng(9)
    tree = {"layers": {"wo": rng.normal(size=(2, 48, 48)).astype(np.float32),
                       "w_down": rng.normal(size=(2, 80, 48)).astype(np.float32)},
            "ids": rng.integers(-127, 128, size=(48, 48)).astype(np.int8)}
    jtree = jquant.quantize_param_tree_host(tree)
    got = llama.params_from_jax(jtree)
    for name in ("wo", "w_down"):
        jleaf = jtree["layers"][name]
        assert got["layers"][name].shape == jleaf.shape[:-2] + jleaf.shape[::-1][:2]
        assert torch.equal(got["layers"][name], t(np.swapaxes(jleaf, -1, -2)))
        assert torch.equal(got["layers"][name + "_scale"], t(jtree["layers"][name + "_scale"]))
    assert not torch.equal(got["layers"]["wo"], t(jtree["layers"]["wo"]))  # square, yet transposed
    assert torch.equal(got["ids"], t(tree["ids"]))
    assert torch.equal(got["layers"]["wo"], quant.quantize_param_tree(llama.params_from_jax(tree))["layers"]["wo"])


def int8_tree(model):
    jc8, tc8 = configs(MODELS[model], quantization="int8")
    tree = jllama.init_params(jc8, jax.random.key(0))
    if not jc8.is_mla:
        tree = _fuse_projection_tree(tree)
    return jc8, tc8, jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_int8_forward_matches_jax(model):
    """One step of the int8 model from the JAX int8 tree: the flat step
    (tiny, tiny-moe, tiny gpt-oss) or a bucketed prefill step (tiny-mla);
    hidden states and logits within the forward tests' tolerance."""
    jc, tc, tree = int8_tree(model)
    rng = np.random.default_rng(6)
    if jc.is_mla:
        s = bucketed_step(rng, ((5, 6), (12, 1), (0, 9)), PAGE, jc.vocab_size, 8)
        s["page_table"] %= NUM_PAGES
        jinp = JaxStepInput(**{k: jnp.asarray(v) for k, v in s.items()})
        tinp = StepInput(**{k: t(v) for k, v in s.items()})
        live = (np.arange(s["token_ids"].shape[1])[None, :] < s["query_lens"][:, None]).reshape(-1)
    else:
        s = step(rng, jc)
        jinp = JaxStepInput(
            token_ids=jnp.asarray(s["ids"][:, None]), positions=jnp.asarray(s["positions"][:, None]),
            query_lens=jnp.asarray(s["live"].astype(np.int32)), kv_lens=jnp.asarray(s["kv_lens"]),
            page_table=jnp.asarray(s["page_table"]), token_rows=jnp.asarray(s["rows"]))
        tinp = StepInput(
            token_ids=t(s["ids"][:, None]), positions=t(s["positions"][:, None]),
            kv_lens=t(s["kv_lens"]), page_table=t(s["page_table"]), token_rows=t(s["rows"]),
            num_live=torch.tensor([s["total"]], dtype=torch.int32))
        live = s["live"]
    shape = (jc.num_layers, NUM_PAGES, jc.kv_cache_heads, PAGE, jc.kv_cache_entry_dim)
    pool = rng.normal(size=shape).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    # JAX's engine runs MoE layers on its grouped backend, as the port does.
    backend = {"moe_backend": "grouped"} if jc.is_moe else {}
    jh, jlogits = jax.jit(lambda params, pool, inp: (
        lambda h: (h, jllama.compute_logits(params, h.reshape(-1, jc.hidden_size), jc))
    )(jllama.forward_hidden(params, pool, inp, jc, **backend)[0]))(jparams, jnp.asarray(pool), jinp)
    jlogits = np.asarray(jlogits)
    params = llama.params_from_jax(tree)
    assert params["layers"]["wo"].dtype == torch.int8 and "lm_head_scale" in params
    # Every int8 leaf K-major, JAX's leaf transposed bit for bit.
    got, want = dict(flat(params)), dict(flat(tree))
    int8 = [k for k, v in want.items() if v.dtype == np.int8]
    assert int8 and all(k + "_scale" in want for k in int8)
    for k in int8:
        assert got[k].is_contiguous() and torch.equal(got[k].mT, t(want[k])), k
    th, _ = llama.forward_hidden(params, t(pool), tinp, tc)
    tlogits = llama.compute_logits(params, th.reshape(-1, tc.hidden_size), tc)
    np.testing.assert_allclose(th.reshape(-1, tc.hidden_size).numpy()[live],
                               np.asarray(jh).reshape(-1, jc.hidden_size)[live], atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(tlogits.numpy()[live], jlogits[live], atol=FWD_ATOL, rtol=0)


def int8_engines(model, kv_dtype="float32", **sched):
    """The JAX int8 engine and the port's on its tree (``params_from_jax``)."""
    jc8, tc8 = configs(MODELS[model], quantization="int8")
    cache = dict(page_size=4, num_blocks=64, dtype=kv_dtype)
    sch = dict(max_num_seqs=8, max_num_batched_tokens=16, **sched)
    j = JaxEngine(jcfg.EngineConfig(model=jc8, cache=jcfg.CacheConfig(**cache),
                                    scheduler=jcfg.SchedulerConfig(**sch),
                                    parallel=jcfg.ParallelConfig(tensor_parallel_size=1)))
    params = llama.params_from_jax(jax.tree.map(np.asarray, j.runner.params))
    p = LLMEngine(tcfg.EngineConfig(model=tc8, cache=tcfg.CacheConfig(**cache),
                                    scheduler=tcfg.SchedulerConfig(**sch)),
                  params=params, device="cpu")
    return j, p


PROMPTS = [[1, 5, 9, 13, 2, 8, 4, 4, 4, 4, 6, 6, 6, 6, 11, 3, 9, 27, 1, 2], [3, 3, 7, 1]]
LAYOUTS = {"flat": {}, "window": dict(unified_step=False, decode_window=4),
           "bucketed": dict(ragged_qlens=False)}
STREAM_CASES = [("tiny", "flat", "float32"), ("tiny", "window", "float32"), ("tiny", "bucketed", "float32"),
                ("tiny", "flat", "int8"), ("tiny-moe", "flat", "float32"),
                ("tiny-moe", "window", "float32"), ("tiny-mla", "flat", "float32"),
                ("tiny-mla", "window", "float32"), ("tiny-oss", "flat", "float32"),
                ("tiny-oss", "window", "float32")]


@pytest.mark.parametrize("model,layout,kv_dtype", STREAM_CASES,
                         ids=["-".join(c) for c in STREAM_CASES])
def test_int8_streams_match_jax(model, layout, kv_dtype):
    """Greedy and seeded streams of the int8 engines, and their step
    counters (tiny-mla's "flat" is its default engine, the bucketed
    unified step, as in JAX)."""
    j, p = int8_engines(model, kv_dtype, **LAYOUTS[layout])
    assert p.runner.params["layers"]["wo_scale"].dtype == torch.float32
    for sp in (dict(temperature=0.0, max_tokens=6, ignore_eos=True),
               dict(temperature=0.8, max_tokens=6, seed=7, ignore_eos=True)):
        want = list(j.generate(PROMPTS, JaxSP(**sp)).values())
        assert list(p.generate(PROMPTS, SamplingParams(**sp)).values()) == want
    for name in ("engine_steps_total", "step_dispatches_total", "decode_dispatches_total",
                 "unified_steps_total"):
        assert getattr(p.stats, name) == getattr(j.stats, name), name


def test_int8_wrappers_never_take_the_plain_version_off_the_cpu():
    """The int8 kernels dispatch by device like the others: a tensor off
    the CPU goes to the kernel or the call raises; there is no dequantized
    or plain path for it."""
    meta = dict(device="meta")
    x = torch.empty((10, 64), **meta)
    xq = torch.empty((10, 64), dtype=torch.int8, **meta)
    s = torch.empty((10,), **meta)
    w = torch.empty((2, 64, 64), dtype=torch.int8, **meta)
    ws = torch.empty((2, 64), **meta)
    sizes = torch.empty((2,), dtype=torch.int32, **meta)
    for call in (lambda: quant.quantize_rows(x),
                 lambda: quant.qdot(x, w[0], ws[0]),
                 lambda: quant.grouped_matmul_q(x, w, ws, sizes),
                 lambda: quant.grouped_gemm.matmul_q8(xq, s, w[0], ws[0], torch.float32),
                 lambda: quant.grouped_gemm.grouped_matmul_q8(xq, s, w, ws, sizes, torch.float32),
                 lambda: quant.grouped_gemm.grouped_matmul_q8_pair(
                     xq, s, w, ws, w, ws, sizes, torch.float32)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
