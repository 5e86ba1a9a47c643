"""The port's HF checkpoint loader (``llmd_tpu_torch/models/loader.py``)
against the JAX package's and against transformers, on the CPU.

For each architecture case of ``tests/test_weights.py`` a tiny random
transformers model (f32) is saved to a temp directory once a module; then:
(a) the port's ``config_from_hf`` equals the JAX one over the port's
fields; (b) the port's ``load_params(..., device="cpu")`` equals
``fuse_projections(params_from_jax(...))`` of the JAX ``load_params`` (the
runner's form; MLA unfused) key for key, dtype for dtype, bit for bit; (c) an
``LLMEngine`` built from the directory (``EngineConfig.weights_path``)
streams transformers' greedy tokens, and the port's forward over the prompt
gives transformers' logits within 1e-4 + 1e-4 x |logit| (f32; both sum in
another order). Rejections raise as in JAX. The port's safetensors reader
equals the ``safetensors`` package. About 15 s serial, most of it the
transformers import and the engines.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")  # transformers: skip the TensorFlow import
import safetensors.torch  # noqa: E402
import transformers  # noqa: E402

import llmd_tpu.models.common as jcommon  # noqa: E402
import llmd_tpu.models.loader as jloader  # noqa: E402
from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig  # noqa: E402
from llmd_tpu_torch.engine import LLMEngine, SamplingParams  # noqa: E402
from llmd_tpu_torch.models import common, llama, loader  # noqa: E402
from llmd_tpu_torch.models.common import StepInput  # noqa: E402
from llmd_tpu_torch.models.registry import get_model_config  # noqa: E402

PROMPT = [3, 17, 91, 4, 55, 23, 7, 120, 9, 33, 61, 2]
NEW_TOKENS = 16
LOGIT_ATOL = LOGIT_RTOL = 1e-4


def rand_prompt(seed, n):
    return [int(x) for x in np.random.default_rng(seed).integers(1, 255, n)]


def _v3_bias(model):
    # Make DeepSeek-V3's selection-only correction bias matter.
    with torch.no_grad():
        for layer in model.model.layers[1:]:
            layer.mlp.gate.e_score_correction_bias.uniform_(-0.2, 0.2)


SMALL = dict(vocab_size=256, hidden_size=64, num_attention_heads=4, rope_theta=10000.0)
MLA = dict(SMALL, intermediate_size=128, moe_intermediate_size=48, num_key_value_heads=4,
           kv_lora_rank=32, q_lora_rank=24, qk_rope_head_dim=8, qk_nope_head_dim=16,
           v_head_dim=16, first_k_dense_replace=1, tie_word_embeddings=False)

# name -> (model class, config class, config kwargs, torch seed, prompt, post-init hook);
# the architectures and sizes of tests/test_weights.py.
CASES = {
    "llama": ("LlamaForCausalLM", "LlamaConfig", dict(
        SMALL, intermediate_size=128, num_hidden_layers=2, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, tie_word_embeddings=False,
        attention_bias=False), 0, PROMPT, None),
    "llama3_rope": ("LlamaForCausalLM", "LlamaConfig", dict(
        SMALL, intermediate_size=128, num_hidden_layers=2, num_key_value_heads=2,
        max_position_embeddings=256, tie_word_embeddings=True,
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 64}),
        1, rand_prompt(2, 90), None),
    "llama_yarn": ("LlamaForCausalLM", "LlamaConfig", dict(
        SMALL, intermediate_size=128, num_hidden_layers=2, num_key_value_heads=2,
        max_position_embeddings=256, tie_word_embeddings=True,
        rope_scaling={"rope_type": "yarn", "factor": 4.0,
                      "original_max_position_embeddings": 64}),
        8, rand_prompt(9, 90), None),
    "mistral_window": ("MistralForCausalLM", "MistralConfig", dict(
        SMALL, intermediate_size=128, num_hidden_layers=2, num_key_value_heads=2,
        max_position_embeddings=256, sliding_window=16, tie_word_embeddings=False),
        7, rand_prompt(5, 56), None),
    "qwen2_bias": ("Qwen2ForCausalLM", "Qwen2Config", dict(
        SMALL, intermediate_size=128, num_hidden_layers=2, num_key_value_heads=2,
        max_position_embeddings=128, tie_word_embeddings=False), 2, PROMPT, None),
    "qwen3_qk_norm": ("Qwen3ForCausalLM", "Qwen3Config", dict(
        SMALL, intermediate_size=128, num_hidden_layers=2, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=128, tie_word_embeddings=True), 3, PROMPT, None),
    "mixtral": ("MixtralForCausalLM", "MixtralConfig", dict(
        SMALL, intermediate_size=96, num_hidden_layers=2, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2, max_position_embeddings=128,
        tie_word_embeddings=False), 4, PROMPT, None),
    "qwen3_moe": ("Qwen3MoeForCausalLM", "Qwen3MoeConfig", dict(
        SMALL, intermediate_size=128, num_hidden_layers=2, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=128, num_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=48, norm_topk_prob=True, tie_word_embeddings=False,
        decoder_sparse_step=1, mlp_only_layers=[]), 9, PROMPT, None),
    "deepseek_v2_mla": ("DeepseekV2ForCausalLM", "DeepseekV2Config", dict(
        MLA, num_hidden_layers=2, n_routed_experts=4, num_experts_per_tok=2,
        n_shared_experts=1, topk_method="group_limited_greedy", n_group=2, topk_group=1,
        norm_topk_prob=False, routed_scaling_factor=1.0, max_position_embeddings=128),
        5, PROMPT, None),
    "deepseek_v3_yarn": ("DeepseekV3ForCausalLM", "DeepseekV3Config", dict(
        MLA, num_hidden_layers=3, n_routed_experts=8, num_experts_per_tok=2, n_group=2,
        topk_group=1, n_shared_experts=1, norm_topk_prob=True, routed_scaling_factor=2.5,
        max_position_embeddings=256,
        rope_scaling={"rope_type": "yarn", "factor": 4.0,
                      "original_max_position_embeddings": 64, "beta_fast": 32,
                      "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}),
        7, rand_prompt(8, 90), _v3_bias),
    "gpt_oss": ("GptOssForCausalLM", "GptOssConfig", dict(
        SMALL, intermediate_size=96, num_hidden_layers=2, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=256, num_local_experts=4,
        num_experts_per_tok=2, sliding_window=8,
        layer_types=["sliding_attention", "full_attention"], tie_word_embeddings=False,
        rope_scaling=None), 11, rand_prompt(9, 40), None),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: faster on these tiny models than many, above
    all while test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass
class Saved:
    model_dir: str
    prompt: list[int]
    greedy: list[int]
    logits: np.ndarray  # [len(prompt), V] f32


@pytest.fixture(scope="module", params=sorted(CASES))
def saved(request, tmp_path_factory):
    """The case's transformers model saved as an HF directory, with its
    greedy continuation and prompt logits."""
    model_cls, cfg_cls, kw, seed, prompt, hook = CASES[request.param]
    torch.manual_seed(seed)
    model = getattr(transformers, model_cls)(getattr(transformers, cfg_cls)(**kw)).eval()
    if hook:
        hook(model)
    d = tmp_path_factory.mktemp(request.param) / "ckpt"
    model.save_pretrained(d, safe_serialization=True)
    with torch.no_grad():
        out = model.generate(torch.tensor([prompt]), max_new_tokens=NEW_TOKENS,
                             do_sample=False, pad_token_id=0)
        logits = model(torch.tensor([prompt])).logits[0].float().numpy()
    return Saved(str(d), prompt, out[0, len(prompt):].tolist(), logits)


def flat_tree(tree, prefix=""):
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from flat_tree(leaf, f"{prefix}{key}.")
        else:
            yield prefix + key, leaf


def assert_trees_equal(got: dict, want: dict) -> None:
    got, want = dict(flat_tree(got)), dict(flat_tree(want))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert torch.equal(got[key], want[key]), key


def test_config_matches_jax(saved):
    port = loader.config_from_hf(saved.model_dir, dtype="float32")
    ref = jloader.config_from_hf(saved.model_dir, dtype="float32")
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert loader.is_model_dir(saved.model_dir) and not loader.is_model_dir(saved.model_dir + "x")


def runner_form(cfg, jtree: dict) -> dict:
    """The JAX tree as the runner keeps it: q|k|v and gate|up fused but for
    MLA (the form the port's ``load_params`` returns)."""
    tree = llama.params_from_jax(jtree)
    return tree if cfg.is_mla else llama.fuse_projections(tree)


def test_tree_matches_jax_bit_for_bit(saved):
    cfg = loader.config_from_hf(saved.model_dir, dtype="float32")
    jcfg = jloader.config_from_hf(saved.model_dir, dtype="float32")
    tree = loader.load_params(cfg, saved.model_dir, device="cpu")
    assert_trees_equal(tree, runner_form(cfg, jloader.load_params(jcfg, saved.model_dir)))
    # bf16, converted from the f32 checkpoint on load: the same rounding.
    bcfg = loader.config_from_hf(saved.model_dir)
    jb = jloader.load_params(jloader.config_from_hf(saved.model_dir), saved.model_dir)
    assert_trees_equal(loader.load_params(bcfg, saved.model_dir, device="cpu"),
                       runner_form(bcfg, jb))


def prompt_logits(cfg, params, prompt: list[int]) -> np.ndarray:
    """The port's forward over the prompt as one bucketed prefill row."""
    n, page = len(prompt), 16
    pages = -(-n // page)
    pool = torch.zeros((cfg.num_layers, pages, cfg.kv_cache_heads, page,
                        cfg.kv_cache_entry_dim), dtype=torch.float32)
    inp = StepInput(
        token_ids=torch.tensor([prompt], dtype=torch.int32),
        positions=torch.arange(n, dtype=torch.int32)[None],
        kv_lens=torch.tensor([n], dtype=torch.int32),
        page_table=torch.arange(pages, dtype=torch.int32)[None],
        query_lens=torch.tensor([n], dtype=torch.int32),
        live_pages=pages,
    )
    hidden, _ = llama.forward_hidden(params, pool, inp, cfg)
    return llama.compute_logits(params, hidden[0], cfg).numpy()


def test_greedy_and_logits_match_transformers(saved):
    cfg = loader.config_from_hf(saved.model_dir, dtype="float32")
    engine = LLMEngine(EngineConfig(
        model=cfg,
        cache=CacheConfig(page_size=4, num_blocks=128, dtype="float32"),
        scheduler=SchedulerConfig(max_num_seqs=2, max_num_batched_tokens=64),
        weights_path=saved.model_dir,
    ), device="cpu")
    sp = SamplingParams(temperature=0.0, max_tokens=NEW_TOKENS, ignore_eos=True)
    (tokens,) = engine.generate([saved.prompt], sp).values()
    assert tokens == saved.greedy
    logits = prompt_logits(cfg, engine.runner.params, saved.prompt)
    np.testing.assert_allclose(logits, saved.logits, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def write_config(d, **hf):
    d.mkdir(exist_ok=True)
    base = {"architectures": ["MistralForCausalLM"], "vocab_size": 64, "hidden_size": 32,
            "intermediate_size": 64, "num_hidden_layers": 1, "num_attention_heads": 2,
            "num_key_value_heads": 1}
    (d / "config.json").write_text(json.dumps({**base, **hf}))
    return str(d)


@pytest.mark.parametrize("hf, match", [
    (dict(architectures=["FalconForCausalLM"]), "unsupported architecture"),
    (dict(rope_scaling={"rope_type": "longrope", "factor": 2.0}), "longrope"),
])
def test_rejections_match_jax(tmp_path, hf, match):
    d = write_config(tmp_path / "m", **hf)
    with pytest.raises(ValueError, match=match):
        jloader.config_from_hf(d)
    with pytest.raises(ValueError, match=match):
        loader.config_from_hf(d)


def test_config_fields_match_jax_for_each_window_convention(tmp_path):
    """Uniform windows, Qwen2's max_window_layers (with HF's default when
    absent), gpt-oss's layer_types, the yarn length default and the f16 ->
    bf16 rule."""
    for hf in (dict(sliding_window=4096),
               dict(architectures=["Qwen2ForCausalLM"], sliding_window=64, use_sliding_window=True),
               dict(architectures=["Qwen2ForCausalLM"], sliding_window=64, use_sliding_window=True,
                    max_window_layers=1, torch_dtype="float16"),
               dict(sliding_window=8, layer_types=["sliding_attention"], dtype="float32"),
               dict(rope_scaling={"type": "yarn", "factor": 4.0}, max_position_embeddings=512)):
        d = write_config(tmp_path / "m", **hf)
        port, ref = loader.config_from_hf(d), jloader.config_from_hf(d)
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), (hf, f.name)


def test_missing_tensor_and_unported_fields_raise(tmp_path):
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1, tie_word_embeddings=True))
    d = str(tmp_path / "ckpt")
    model.save_pretrained(d, safe_serialization=True)
    # The config claims one more layer than the checkpoint holds.
    with pytest.raises(KeyError, match="model.layers.1"):
        jloader.load_params(jloader.config_from_hf(d, num_layers=2), d)
    with pytest.raises(KeyError, match="model.layers.1"):
        loader.load_params(loader.config_from_hf(d, num_layers=2), d, device="cpu")
    with pytest.raises(ValueError, match="queue 1 item 3"):
        loader.config_from_hf(d, quantization="int8")
    with pytest.raises(ValueError, match="queue 1 item 8"):
        loader.config_from_hf(d, num_lora_adapters=2)
    with pytest.raises(FileNotFoundError):
        loader.load_params(loader.config_from_hf(d), str(tmp_path), device="cpu")


def test_unmapped_tensors_are_reported(tmp_path, caplog):
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, tie_word_embeddings=True))
    d = str(tmp_path / "ckpt")
    model.save_pretrained(d, safe_serialization=True)
    with caplog.at_level("WARNING"):
        loader.load_params(loader.config_from_hf(d, num_layers=1), d, device="cpu")
    assert "not mapped (9)" in caplog.text and "model.layers.1." in caplog.text


def reader_tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "f16": torch.randn(7, generator=g).to(torch.float16),
        "f32": torch.randn(2, 3, 4, generator=g),
        "i8": torch.randint(-128, 128, (9, 2), generator=g, dtype=torch.int8),
        "i32": torch.randint(-2**31, 2**31 - 1, (5,), generator=g, dtype=torch.int32),
        "i64": torch.randint(-2**62, 2**62, (3,), generator=g, dtype=torch.int64),
        "bool": torch.rand(4, generator=g) > 0.5,
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 3),
    }


def test_reader_equals_the_safetensors_package(tmp_path):
    """One file of every dtype the reader maps, and a checkpoint in two
    shards: each tensor as ``safetensors.torch.load_file`` reads it."""
    one = reader_tensors(0)
    safetensors.torch.save_file(one, tmp_path / "model.safetensors", metadata={"format": "pt"})
    shards = tmp_path / "sharded"
    shards.mkdir()
    two = {f"a.{k}": v for k, v in reader_tensors(1).items()}
    half = sorted(two)[: len(two) // 2]
    safetensors.torch.save_file({k: two[k] for k in half}, shards / "model-00001-of-00002.safetensors")
    safetensors.torch.save_file({k: v for k, v in two.items() if k not in half},
                                shards / "model-00002-of-00002.safetensors")
    for d in (tmp_path, shards):
        ckpt = loader._Checkpoint(str(d))
        want = {}
        for f in sorted(d.glob("*.safetensors")):
            want.update(safetensors.torch.load_file(f))
        assert ckpt.names() == set(want)
        for name, w in want.items():
            got = ckpt.get(name)
            assert got.dtype == w.dtype and got.shape == w.shape and torch.equal(got, w), name
            assert ckpt.shape(name) == tuple(w.shape)
        assert ckpt.used == set(want)
    with pytest.raises(KeyError, match="not found"):
        loader._Checkpoint(str(tmp_path)).get("missing")


def test_reader_refuses_an_unmapped_dtype(tmp_path):
    safetensors.torch.save_file({"x": torch.zeros(2, dtype=torch.float64)}, tmp_path / "m.safetensors")
    with pytest.raises(ValueError, match="F64"):
        loader._Checkpoint(str(tmp_path))


@pytest.mark.parametrize("name", ["tiny", "tiny-swa", "tiny-moe", "tiny-mla"])
def test_fused_init_is_the_fused_tree_of_the_same_draw(name):
    """The runner's tree, drawn straight into the fused leaves, equals
    ``fuse_projections`` of the unfused draw from the same seed."""
    cfg = get_model_config(name)
    unfused = llama.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    fused = llama.init_params(cfg, torch.Generator().manual_seed(5), "cpu", fused=True)
    assert_trees_equal(fused, unfused if cfg.is_mla else llama.fuse_projections(unfused))
    assert ("wqkv" in fused["layers"]) != cfg.is_mla


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "linear", "factor": 2.0},
    {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64},
    {"rope_type": "yarn", "factor": 40.0, "mscale": 1.0, "mscale_all_dim": 0.707},
    {"type": "yarn", "factor": 4.0, "mscale": 0.707, "mscale_all_dim": 0.707},
])
def test_yarn_sm_scale_mult_matches_jax(scaling):
    assert common.yarn_sm_scale_mult(scaling) == jcommon.yarn_sm_scale_mult(scaling)
    assert common.SUPPORTED_ROPE_TYPES == jcommon.SUPPORTED_ROPE_TYPES


@pytest.mark.parametrize("overrides", [
    dict(dtype="bfloat16"), dict(qk_norm=True, tie_word_embeddings=True),
    dict(attention_bias=True, dtype="bfloat16"),
], ids=["llama-bf16", "qwen3-f32", "qwen2-bf16"])
def test_smoke_writer_round_trip(tmp_path, overrides):
    """The checkpoint ``chip_smoke.py`` writes (its own safetensors writer)
    reads back through the JAX loader (the safetensors package) and the
    port's, both equal to the tree it was written from, and its config is
    the tree's config but the name."""
    import chip_smoke as smoke

    cfg = get_model_config("tiny", head_dim=32, **overrides)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu", fused=True)
    d = str(tmp_path / "ckpt")
    smoke.write_hf_checkpoint(cfg, params, d)
    hf_cfg = loader.config_from_hf(d)
    assert dataclasses.replace(hf_cfg, name=cfg.name) == cfg
    want = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert_trees_equal(loader.load_params(hf_cfg, d, device="cpu"), params)
    jtree = jloader.load_params(jloader.config_from_hf(d), d)
    assert_trees_equal(llama.params_from_jax(jtree), want)
