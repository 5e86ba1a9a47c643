"""`python -m llmd_tpu_torch.serve` — the port's model-server entry point.

Where ``python -m llmd_tpu.serve`` has a flag, the port uses its name
(``--model``, ``--host``, ``--port``, ``--max-num-seqs``,
``--max-num-batched-tokens``, ``--seed``, ``--decode-window``,
``--unified-step``, ``--ragged-qlens``, ``--kv-cache-dtype``,
``--kv-swa-ring``, ``--skip-warmup``, ``--step-watchdog-s``). The model's weights are random, drawn on the device
from ``--seed``; the byte tokenizer keeps the server hermetic. Before it
serves, the engine builds its kernels and captures its decode steps as
CUDA graphs (``LLMEngine.warmup``) unless ``--skip-warmup`` is given; a
step the warmup did not capture is captured at its first use. Runs on the
GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m llmd_tpu_torch.serve")
    p.add_argument("--model", default="tiny", help="registry name")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument(
        "--dtype", default=None,
        help="weights and KV pool dtype (default: the registry's)",
    )
    p.add_argument("--num-blocks", type=int, default=2048, help="KV pool pages")
    p.add_argument(
        "--kv-cache-dtype", default=None,
        help="KV pool dtype: the weights' dtype (default), or int8 for the "
             "quantized pool (per-row int8 K|V with f32 scales; not for MLA "
             "models)",
    )
    p.add_argument(
        "--kv-swa-ring", action="store_true",
        help="sliding-window layers keep a fixed ring of pages per sequence "
             "in a second, smaller pool (about half the KV bytes of a long "
             "sequence on gpt-oss-class models); prefix caching becomes "
             "hybrid; no effect on models without sliding layers",
    )
    p.add_argument("--max-num-seqs", type=int, default=64)
    p.add_argument("--max-num-batched-tokens", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--decode-window", type=int, default=1,
        help="fused decode window: K decode iterations per dispatch with "
             "on-device token feedback and one readback (1 = one step per "
             "token)",
    )
    p.add_argument(
        "--unified-step", action=argparse.BooleanOptionalAction, default=True,
        help="run each window-1 engine step as one program with one "
             "readback; --no-unified-step selects the split engine (prefill "
             "groups plus the decode program)",
    )
    p.add_argument(
        "--ragged-qlens", action=argparse.BooleanOptionalAction, default=True,
        help="the unified step runs over the packed token stream (the flat "
             "step); --no-ragged-qlens selects the bucketed [B, Q] unified "
             "program",
    )
    p.add_argument(
        "--skip-warmup", action="store_true",
        help="serve without preparing the decode steps' programs first; "
             "each is then captured at its first use",
    )
    p.add_argument(
        "--step-watchdog-s", type=float, default=0.0,
        help="fail in-flight streams and turn /health and /ready 503 when "
             "an engine step runs longer than this many seconds (0 = off; "
             "armed after the first step)",
    )
    p.add_argument("--device", default="cuda")
    return p


def make_engine_config(args):
    from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from llmd_tpu_torch.models.registry import get_model_config

    overrides = {} if args.dtype is None else {"dtype": args.dtype}
    model = get_model_config(args.model, **overrides)
    return EngineConfig(
        model=model,
        cache=CacheConfig(num_blocks=args.num_blocks,
                          dtype=args.kv_cache_dtype or model.dtype,
                          swa_ring=args.kv_swa_ring),
        scheduler=SchedulerConfig(
            max_num_seqs=args.max_num_seqs,
            max_num_batched_tokens=args.max_num_batched_tokens,
            decode_window=args.decode_window,
            unified_step=args.unified_step,
            ragged_qlens=args.ragged_qlens,
        ),
        seed=args.seed,
    )


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from aiohttp import web

    from llmd_tpu_torch.engine import LLMEngine
    from llmd_tpu_torch.serve.api import build_app
    from llmd_tpu_torch.serve.async_engine import AsyncEngine
    from llmd_tpu_torch.serve.tokenizer import ByteTokenizer

    config = make_engine_config(args)
    engine = LLMEngine(config, device=args.device)
    if not args.skip_warmup:
        n = engine.warmup()
        logging.info("warmup prepared %d decode programs (CUDA graphs on the card)", n)
    app = build_app(
        AsyncEngine(engine, watchdog_s=args.step_watchdog_s), ByteTokenizer(), args.model, config.model.max_model_len
    )
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
