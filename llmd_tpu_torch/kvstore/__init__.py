"""The cross-slice shared KV store: the master (metadata, leases,
eviction, snapshots; ``master.py``, ``python -m llmd_tpu_torch.kvstore``)
and the engines' client, whose bytes ride the shipper (``client.py``)."""

from llmd_tpu_torch.kvstore.client import CrossSliceStoreClient
from llmd_tpu_torch.kvstore.master import MasterState, build_app

__all__ = ["CrossSliceStoreClient", "MasterState", "build_app"]
