"""Engine configuration (the fields the port's engines read).

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
    # Shape buckets of the bucketed programs, under the JAX package's names
    # so one set of keyword arguments builds either package's config; ()
    # derives powers of two up to the limit (the runner's ``_buckets``).
    # ``prefill_token_buckets`` groups prompt chunks into programs by width
    # and ``decode_batch_buckets`` pads the decode batch with pad rows.
    # ``prefill_batch_buckets`` pads no array here: it only sizes a prefill
    # group's draw from the seed stream (the runner's ``_seed_rows``).
    prefill_token_buckets: tuple[int, ...] = ()
    decode_batch_buckets: tuple[int, ...] = ()
    prefill_batch_buckets: tuple[int, ...] = ()
    # Fused decode window: K decode iterations per dispatch with on-device
    # token feedback and one readback. 1 = one step per token. A larger K
    # spreads the readback and the scheduling pass over K tokens, at the
    # cost of K-token streaming granularity and a bounded overrun past
    # stop tokens.
    decode_window: int = 1
    # One program for a whole window-1 step (prefill chunks and decode
    # rows together, one readback). Off: the split engine, one program per
    # prefill Q-bucket group plus the decode program.
    unified_step: bool = True
    # The unified step runs over the packed token stream (the flat step).
    # Off: the bucketed [B, Q] unified program.
    ragged_qlens: bool = True


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
