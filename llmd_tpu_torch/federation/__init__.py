"""Cross-replica KV federation: the host tiers, the cross-slice store and
the KV events as one fleet-wide prefix cache (``core.py``), and the
page framing on the store's wire (``wire.py``). The port's copy of
``llmd_tpu/federation``."""

from llmd_tpu_torch.federation.core import PUBLISH_POLICIES, KVFederation  # noqa: F401
from llmd_tpu_torch.federation.wire import (  # noqa: F401
    PageDecodeError,
    decode_page,
    encode_page,
)
