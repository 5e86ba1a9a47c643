"""Engine configuration (the fields the flat-step slice reads).

Field names and defaults are those of ``llmd_tpu.config``, so one kwargs
dict builds a configuration for either package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any


@dataclasses.dataclass
class ModelConfig:
    """Architecture hyperparameters for a dense Llama-class decoder."""

    name: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int | None = None  # defaults to hidden_size // num_heads
    rope_theta: float = 500000.0  # default (unscaled) rope only
    rms_norm_eps: float = 1e-5
    max_model_len: int = 8192
    dtype: str = "bfloat16"
    tie_word_embeddings: bool = False
    # Qwen2-style attention bias on QKV projections.
    attention_bias: bool = False
    # Qwen3-style per-head RMS norm on Q and K (applied before RoPE).
    qk_norm: bool = False

    def __post_init__(self) -> None:
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_heads
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_heads={self.num_heads} is not a multiple of "
                f"num_kv_heads={self.num_kv_heads}"
            )


@dataclasses.dataclass
class CacheConfig:
    """Paged KV cache geometry: ``num_blocks`` pages of ``page_size`` tokens
    in one pool ``[L, num_blocks, K, page_size, 2D]``."""

    page_size: int = 16
    num_blocks: int = 512
    dtype: str = "bfloat16"
    enable_prefix_caching: bool = True

    def max_pages_per_seq(self, max_model_len: int) -> int:
        return math.ceil(max_model_len / self.page_size)


@dataclasses.dataclass
class SchedulerConfig:
    """Continuous batching knobs (vLLM flag names)."""

    max_num_seqs: int = 64
    # Per-step token budget; longer prompts prefill in chunks of at most
    # this many tokens, so decodes are never starved.
    max_num_batched_tokens: int = 1024


@dataclasses.dataclass
class EngineConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    # Seed of the random weights and of the engine's sampling stream.
    seed: int = 0


def tiny_model_config(**overrides: Any) -> ModelConfig:
    """A toy config small enough for CPU unit tests."""
    base = dict(
        name="tiny-llama",
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        rope_theta=10000.0,
        max_model_len=128,
        dtype="float32",
    )
    base.update(overrides)
    return ModelConfig(**base)
