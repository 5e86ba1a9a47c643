"""KV page tiers beside the device pool: the tiered offload to host DRAM
and files (``offload.py``)."""
