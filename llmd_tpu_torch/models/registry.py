"""Named model configurations: the entries of the JAX registry that the
port runs (dense, MoE, MLA and gpt-oss), copied field for field.

Hyperparameters follow the public HF configs of each model, as the JAX
entries do. One known difference from the HF config, kept for parity with
the reference: ``deepseek-v2-lite`` leaves ``norm_topk_prob`` at its default
``True`` where deepseek-ai/DeepSeek-V2-Lite sets it ``false``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from llmd_tpu_torch.config import ModelConfig, tiny_model_config

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {
    "tiny": tiny_model_config,
    "tiny-moe": lambda: tiny_model_config(
        name="tiny-moe", num_experts=8, num_experts_per_tok=2,
        moe_intermediate_size=64,
    ),
    # Alternating sliding and full layers in miniature (gpt-oss's layout).
    "tiny-swa": lambda: tiny_model_config(
        name="tiny-swa", sliding_window=64,
        layer_types=("sliding_attention", "full_attention"),
    ),
    # DeepSeek architecture in miniature: MLA, MoE, a shared expert and a
    # dense first layer.
    "tiny-mla": lambda: tiny_model_config(
        name="tiny-mla", kv_lora_rank=32, q_lora_rank=24,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
        shared_expert_intermediate_size=32, first_dense_layers=1,
        num_layers=3,
    ),
    "llama-3.2-3b": lambda: ModelConfig(
        name="llama-3.2-3b", vocab_size=128256, hidden_size=3072,
        intermediate_size=8192, num_layers=28, num_heads=24, num_kv_heads=8,
        head_dim=128, rope_theta=500000.0, max_model_len=8192,
        tie_word_embeddings=True,
    ),
    "llama-3-8b": lambda: ModelConfig(
        name="llama-3-8b", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        rope_theta=500000.0, max_model_len=8192,
    ),
    # Qwen3-30B-A3B: 128 experts, top-8, QK-norm.
    "qwen3-30b-a3b": lambda: ModelConfig(
        name="qwen3-30b-a3b", vocab_size=151936, hidden_size=2048,
        intermediate_size=6144, num_layers=48, num_heads=32, num_kv_heads=4,
        head_dim=128, rope_theta=1000000.0, max_model_len=40960,
        qk_norm=True,
        num_experts=128, num_experts_per_tok=8, moe_intermediate_size=768,
    ),
    "mixtral-8x7b": lambda: ModelConfig(
        name="mixtral-8x7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        rope_theta=1000000.0, max_model_len=32768,
        num_experts=8, num_experts_per_tok=2, moe_intermediate_size=14336,
    ),
    "mixtral-8x22b": lambda: ModelConfig(
        name="mixtral-8x22b", vocab_size=32768, hidden_size=6144,
        intermediate_size=16384, num_layers=56, num_heads=48, num_kv_heads=8,
        rope_theta=1000000.0, max_model_len=65536,
        num_experts=8, num_experts_per_tok=2, moe_intermediate_size=16384,
    ),
    # gpt-oss-20b (HF openai/gpt-oss-20b): alternating sliding (window 128)
    # and full attention with per-head sinks and o bias, 32 experts top-4
    # with clamped-SwiGLU biased experts and a router logit bias, yarn rope.
    "gpt-oss-20b": lambda: ModelConfig(
        name="gpt-oss-20b", vocab_size=201088, hidden_size=2880,
        intermediate_size=2880, num_layers=24, num_heads=64,
        num_kv_heads=8, head_dim=64, rope_theta=150000.0,
        max_model_len=131072,
        sliding_window=128,
        layer_types=tuple(
            "sliding_attention" if i % 2 == 0 else "full_attention"
            for i in range(24)
        ),
        attention_bias=True, attention_out_bias=True, attention_sinks=True,
        num_experts=32, num_experts_per_tok=4, moe_intermediate_size=2880,
        moe_activation="swiglu_oss", router_logit_bias=True,
        norm_topk_prob=True,
        rope_scaling={
            "rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
            "beta_slow": 1.0, "original_max_position_embeddings": 4096,
        },
    ),
    # DeepSeek-V2-Lite (HF deepseek-ai/DeepSeek-V2-Lite): MLA without a
    # query LoRA, 64 routed + 2 shared experts, first layer dense.
    "deepseek-v2-lite": lambda: ModelConfig(
        name="deepseek-v2-lite", vocab_size=102400, hidden_size=2048,
        intermediate_size=10944, num_layers=27, num_heads=16,
        num_kv_heads=16, rope_theta=10000.0, max_model_len=32768,
        kv_lora_rank=512, q_lora_rank=0,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        num_experts=64, num_experts_per_tok=6, moe_intermediate_size=1408,
        shared_expert_intermediate_size=2816, first_dense_layers=1,
    ),
    # DeepSeek-V3/R1 (HF deepseek-ai/DeepSeek-R1): q LoRA 1536, latent
    # 512 + 64, 256 routed + 1 shared expert, top-8, 3 dense layers.
    "deepseek-r1": lambda: ModelConfig(
        name="deepseek-r1", vocab_size=129280, hidden_size=7168,
        intermediate_size=18432, num_layers=61, num_heads=128,
        num_kv_heads=128, rope_theta=10000.0, max_model_len=163840,
        kv_lora_rank=512, q_lora_rank=1536,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        num_experts=256, num_experts_per_tok=8, moe_intermediate_size=2048,
        shared_expert_intermediate_size=2048, first_dense_layers=3,
    ),
}


def get_model_config(name: str, **overrides) -> ModelConfig:
    """The registry's entry with ``overrides``. As in the JAX registry, the
    derived fields (``head_dim``, ``moe_intermediate_size``) are derived
    again from their overridden bases unless they were set apart from
    them or are overridden themselves."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    if not overrides:
        return cfg
    kw = dataclasses.asdict(cfg)
    if cfg.head_dim == cfg.hidden_size // cfg.num_heads and "head_dim" not in overrides:
        kw["head_dim"] = None
    if (
        cfg.moe_intermediate_size == cfg.intermediate_size
        and "moe_intermediate_size" not in overrides
    ):
        kw["moe_intermediate_size"] = None
    kw.update(overrides)
    return ModelConfig(**kw)

