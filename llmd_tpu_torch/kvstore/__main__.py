"""`python -m llmd_tpu_torch.kvstore`: the cross-slice KV store's master.

The flags are ``python -m llmd_tpu.kvstore``'s, whose names follow the
Mooncake master's configmap (``helpers/mooncake-master-store/base/
configmap.yaml``): ``--host``, ``--port`` (50051), the eviction's
``--eviction-high-watermark-ratio`` (0.95) and ``--eviction-ratio`` (0.05),
the read lease ``--default-kv-lease-ttl`` (ms), the soft pin
``--default-kv-soft-pin-ttl`` (ms), and ``--enable-snapshot``,
``--snapshot-path``, ``--snapshot-interval-seconds``."""

from __future__ import annotations

import argparse
import logging

from aiohttp import web

from llmd_tpu_torch.kvstore.master import MasterState, build_app


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(prog="python -m llmd_tpu_torch.kvstore")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=50051)
    p.add_argument("--eviction-high-watermark-ratio", type=float, default=0.95)
    p.add_argument("--eviction-ratio", type=float, default=0.05)
    p.add_argument("--default-kv-lease-ttl", type=int, default=5000,
                   help="read lease TTL in ms")
    p.add_argument("--default-kv-soft-pin-ttl", type=int, default=1_800_000)
    p.add_argument("--enable-snapshot", action="store_true")
    p.add_argument("--snapshot-path", default="/data/kvstore-snapshot.json")
    p.add_argument("--snapshot-interval-seconds", type=float, default=60.0)
    args = p.parse_args(argv)

    state = MasterState(
        eviction_high_watermark_ratio=args.eviction_high_watermark_ratio,
        eviction_ratio=args.eviction_ratio,
        default_kv_lease_ttl_ms=args.default_kv_lease_ttl,
        default_kv_soft_pin_ttl_ms=args.default_kv_soft_pin_ttl,
        snapshot_path=args.snapshot_path if args.enable_snapshot else None,
    )
    app = build_app(state, snapshot_interval_s=args.snapshot_interval_seconds)
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
