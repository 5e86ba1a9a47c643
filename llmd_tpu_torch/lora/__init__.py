"""LoRA adapters: a fixed set of device slots over an unbounded registry.

The port of ``llmd_tpu/lora``: ``AdapterPool`` (``pool.py``) holds the
resident working set in the model's ``num_lora_adapters`` slots, LRU with
pin-while-referenced; ``AdapterRegistry`` (``registry.py``) every loadable
adapter in host memory; ``source.py`` fetches adapter weights from a PEFT
directory, a ``LORA1`` frame in a file, a URL or the KV store. Rows carry
only their slot id (``Request.lora_id``), so a batch mixes adapters in one
dispatch, and an adapter's streams are the same resident or cold-loaded.
"""

from llmd_tpu_torch.lora.pool import AdapterPool
from llmd_tpu_torch.lora.registry import AdapterRecord, AdapterRegistry
from llmd_tpu_torch.lora.source import (
    FACTOR_KEYS,
    AdapterDecodeError,
    AdapterFetchError,
    decode_adapter,
    encode_adapter,
    fetch_adapter,
)

__all__ = [
    "FACTOR_KEYS",
    "AdapterPool",
    "AdapterRecord",
    "AdapterRegistry",
    "AdapterDecodeError",
    "AdapterFetchError",
    "decode_adapter",
    "encode_adapter",
    "fetch_adapter",
]
