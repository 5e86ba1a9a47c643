"""Named model configurations: the dense entries of the JAX registry.

Hyperparameters follow the public HF configs of each model.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from llmd_tpu_torch.config import ModelConfig, tiny_model_config

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {
    "tiny": tiny_model_config,
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
}


def get_model_config(name: str, **overrides) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return dataclasses.replace(_REGISTRY[name](), **overrides)

