"""`python -m llmd_tpu_torch.serve` — the port's model-server entry point.

Where ``python -m llmd_tpu.serve`` has a flag, the port uses its name and
its default (``--model``, ``--served-model-name``, ``--tokenizer``,
``--weights-path``, ``--host``, ``--port``, ``--max-model-len``,
``--block-size``, ``--num-gpu-blocks-override``,
``--no-enable-prefix-caching``, ``--kv-swa-ring``, ``--max-num-seqs``,
``--max-num-batched-tokens``, ``--decode-window``, ``--async-scheduling``,
``--unified-step``, ``--ragged-qlens``, ``--speculative-ngram``,
``--spec-ngram-k``, ``--spec-ngram-min-match``, ``--spec-verify-window``,
the batch tier's ``--batch-backfill`` / ``--no-batch-backfill``,
``--batch-max-seqs`` and ``--batch-kv-watermark``, the tiered offload's
``--kv-offload-chunks`` (host-DRAM pages; 0, the default, turns offload
off) and ``--kv-offload-fs-dir`` (the file tier), ``--seed``,
``--skip-warmup``,
``--quantization int8``
(int8 weights, ``ops/quant.py``), and the tracing flags
``--otlp-traces-endpoint``, ``--trace-file`` and ``--trace-sample-ratio``,
which the chart passes when tracing is on, and P/D's
``--kv-transfer-config`` (vLLM-style JSON: ``kv_role`` kv_producer,
kv_consumer or kv_both, ``transfer_port`` (default 9100; 0 any free port),
``transfer_dtype`` auto, int8 or adaptive, ``stream_groups`` (default 4);
other keys, such as ``kv_connector``, are ignored) and
``--advertised-address`` (host:port this server is reached at; its host
is what a producer tells consumers, and it defaults to ``--host``:``--port``,
which is wrong when binding 0.0.0.0), the chart's ``--tensor-parallel-size``
(1 only: the port serves from one card) and ``--moe-backend`` (grouped
only), the KV events' ``--kv-events-endpoint`` (the publisher's
``tcp://HOST:PORT``; the events carry the advertised address as their
pod), and the store tier's ``--kv-store-master-url`` (with
``--kv-offload-chunks``: the cross-slice store behind host DRAM and files),
``--kv-store-segment-bytes``, ``--kv-store-data-port``,
``--kv-publish-policy`` (save, evict-hot or off) and
``--kv-publish-min-hits``. ``--model`` is a
registry name, whose weights are random, drawn on the device from
``--seed``, and whose tokenizer is the byte tokenizer unless
``--tokenizer`` names one; or an HF model directory (``config.json`` and
``*.safetensors``), from which the architecture, the weights and the
tokenizer all come, and whose ``max_position_embeddings`` is the default
``--max-model-len`` (8,192 for a registry name). The port's own flags:
``--dtype``, ``--num-blocks`` (the same as ``--num-gpu-blocks-override``),
``--kv-cache-dtype`` (default: the weights' dtype), ``--step-watchdog-s``
(default: ``LLMD_STEP_WATCHDOG_S``, as the reference's watchdog reads it)
and ``--device``. Before it serves, the engine builds its kernels and
captures its decode steps as CUDA graphs (``LLMEngine.warmup``) unless
``--skip-warmup`` is given; a step the warmup did not capture is captured
at its first use. Runs on the GPU unless ``--device cpu`` is given.

With ``--otlp-traces-endpoint`` (a collector's base URL) or ``--trace-file``
(a JSONL span log) every generate request continues its caller's
``traceparent`` in an ``engine.generate`` span, sampled parent-first, else
at ``--trace-sample-ratio``. A request with the ``x-llmd-priority: batch``
header rides the batch tier. ``LLMD_FAULT_PLAN`` (a fault plan's JSON, read
at import of ``llmd_tpu_torch.faults``) arms the fault sites, and
``LLMD_REQUEST_DEADLINE_S`` bounds a request that carries no
``x-request-deadline-s`` header.
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m llmd_tpu_torch.serve")
    p.add_argument("--model", default="tiny", help="registry name or HF model directory")
    p.add_argument(
        "--served-model-name", default=None,
        help="the model's name on the API (default: --model)",
    )
    p.add_argument(
        "--tokenizer", default=None,
        help="HF tokenizer directory or name, or 'byte' (default: the model "
             "directory's tokenizer, else the byte tokenizer)",
    )
    p.add_argument(
        "--weights-path", default=None,
        help="HF checkpoint directory to load the weights from (default: "
             "the model directory's, else random weights from --seed)",
    )
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument(
        "--max-model-len", type=int, default=None,
        help="default: the checkpoint's max_position_embeddings (model "
             "directories) or 8192",
    )
    p.add_argument("--block-size", type=int, default=16, help="KV page size in tokens")
    p.add_argument(
        "--num-gpu-blocks-override", "--num-blocks", dest="num_gpu_blocks_override",
        type=int, default=None, help="KV pool pages (default 2048)",
    )
    p.add_argument("--no-enable-prefix-caching", action="store_true")
    p.add_argument(
        "--dtype", default=None,
        help="weights and KV pool dtype (default: the model's)",
    )
    p.add_argument(
        "--quantization", default=None, choices=["int8"],
        help="weight quantization: int8 W8A8 (per-output-channel int8 "
             "weights, per-token int8 activations, int8 products through "
             "the int8 branch of the grouped GEMM kernel)",
    )
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
    p.add_argument("--max-num-batched-tokens", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--decode-window", type=int, default=1,
        help="fused decode window: K decode iterations per dispatch with "
             "on-device token feedback and one readback (1 = one step per "
             "token)",
    )
    p.add_argument(
        "--async-scheduling", action="store_true",
        help="overlap host scheduling with device execution: the next step "
             "is scheduled and staged while the current one runs; tokens "
             "stream one step late",
    )
    p.add_argument(
        "--speculative-ngram", action="store_true",
        help="speculative decoding with n-gram drafts from each sequence's "
             "own history, verified in one [B, 1+k] pass; greedy and seeded "
             "streams are those of the engine without it",
    )
    p.add_argument(
        "--spec-ngram-k", type=int, default=4,
        help="most draft tokens a sequence a verify iteration (the k of "
             "the [B, 1+k] verify rows)",
    )
    p.add_argument(
        "--spec-ngram-min-match", type=int, default=2,
        help="shortest trailing n-gram that must recur in the sequence's "
             "history before a draft is proposed",
    )
    p.add_argument(
        "--spec-verify-window", type=int, default=0,
        help="most verify iterations fused into one dispatch, acceptance "
             "on the device and one readback (0 inherits --decode-window; "
             "1 keeps one-shot verify steps)",
    )
    p.add_argument(
        "--batch-backfill", action=argparse.BooleanOptionalAction, default=True,
        help="batch tier: requests at or below PriorityClass.BATCH (the "
             "x-llmd-priority: batch header) ride the same continuous batch "
             "but only backfill the budget and pages interactive rows left, "
             "never displace an interactive admission, and are preempted "
             "first when interactive load returns; --no-batch-backfill makes "
             "them plain low-priority rows",
    )
    p.add_argument(
        "--batch-max-seqs", type=int, default=0,
        help="most batch rows running at once (0: no cap of their own)",
    )
    p.add_argument(
        "--batch-kv-watermark", type=float, default=0.85,
        help="admit new batch rows only while the KV pool's used share is "
             "at or below this fraction",
    )
    p.add_argument(
        "--kv-offload-chunks", type=int, default=0,
        help="host-DRAM KV page budget of the tiered offload (0 turns it "
             "off): committed pages are saved to host memory and restored "
             "for a prompt whose prefix the device cache lost",
    )
    p.add_argument(
        "--kv-offload-fs-dir", default=None,
        help="directory of the offload's file tier: pages the host tier "
             "evicts go there and load back from there, across restarts",
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
        "--step-watchdog-s", type=float, default=None,
        help="fail in-flight streams and turn /health and /ready 503 when "
             "an engine step runs longer than this many seconds (0 = off; "
             "armed after the first step; default: LLMD_STEP_WATCHDOG_S, "
             "else off)",
    )
    p.add_argument(
        "--otlp-traces-endpoint", default=None,
        help="OTLP/HTTP collector base URL (e.g. http://otel:4318)",
    )
    p.add_argument("--trace-file", default=None, help="JSONL span log path")
    p.add_argument("--trace-sample-ratio", type=float, default=0.1)
    p.add_argument("--kv-transfer-config", default=None, help="JSON, vLLM-style")
    p.add_argument("--kv-events-endpoint", default=None, help="ZMQ pub endpoint")
    p.add_argument(
        "--advertised-address", default=None,
        help="host:port this pod is reachable at (pod IP in-cluster); used "
             "to attribute KV events and kv-transfer params. Defaults to "
             "host:port, which is wrong when binding 0.0.0.0.",
    )
    p.add_argument(
        "--tensor-parallel-size", type=int, default=1,
        help="cards a model is sharded over; the port serves from one card (1)",
    )
    p.add_argument(
        "--moe-backend", default="grouped", choices=["grouped", "dense", "ep"],
        help="MoE path: grouped GEMM (DeepGEMM role, default), dense "
             "combine (oracle), or shard_map all-to-all (wide-EP); the port "
             "runs grouped",
    )
    p.add_argument(
        "--kv-store-master-url", default=None,
        help="cross-slice KV store master URL (Mooncake-Store role); "
             "enables the shared tier behind host-DRAM/FS",
    )
    p.add_argument(
        "--kv-store-segment-bytes", type=int, default=8 << 30,
        help="DRAM this host contributes to the shared pool",
    )
    p.add_argument("--kv-store-data-port", type=int, default=9200)
    p.add_argument(
        "--kv-publish-policy", default="save", choices=["save", "evict-hot", "off"],
        help="federation publish policy: save = publish every host-tier "
             "save (eager); evict-hot = publish only device-evicted pages "
             "used >= --kv-publish-min-hits times; off = read-only store "
             "participation",
    )
    p.add_argument(
        "--kv-publish-min-hits", type=int, default=2,
        help="hotness gate for --kv-publish-policy evict-hot: distinct uses "
             "of a page's hash chain before eviction earns a store copy",
    )
    p.add_argument("--device", default="cuda")
    return p


def make_engine_config(args):
    import json

    from llmd_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        OffloadConfig,
        ParallelConfig,
        SchedulerConfig,
    )
    from llmd_tpu_torch.models.loader import config_from_hf, is_model_dir
    from llmd_tpu_torch.models.registry import get_model_config

    overrides = {}
    if args.max_model_len is not None:
        overrides["max_model_len"] = args.max_model_len
    if args.dtype is not None:
        overrides["dtype"] = args.dtype
    if args.quantization:
        overrides["quantization"] = args.quantization
    weights_path, tokenizer_path = args.weights_path, args.tokenizer
    if is_model_dir(args.model):
        model = config_from_hf(args.model, **overrides)
        weights_path = weights_path or args.model
        tokenizer_path = tokenizer_path or args.model
    else:
        overrides.setdefault("max_model_len", 8192)
        model = get_model_config(args.model, **overrides)
    kv_cfg = json.loads(args.kv_transfer_config) if args.kv_transfer_config else {}
    return EngineConfig(
        model=model,
        cache=CacheConfig(
            page_size=args.block_size,
            num_blocks=args.num_gpu_blocks_override or 2048,
            dtype=args.kv_cache_dtype or model.dtype,
            enable_prefix_caching=not args.no_enable_prefix_caching,
            swa_ring=args.kv_swa_ring,
        ),
        scheduler=SchedulerConfig(
            max_num_seqs=args.max_num_seqs,
            max_num_batched_tokens=args.max_num_batched_tokens,
            decode_window=args.decode_window,
            async_scheduling=args.async_scheduling,
            unified_step=args.unified_step,
            ragged_qlens=args.ragged_qlens,
            speculative_ngram=args.speculative_ngram,
            spec_ngram_k=args.spec_ngram_k,
            spec_ngram_min_match=args.spec_ngram_min_match,
            spec_verify_window=args.spec_verify_window,
            batch_backfill=args.batch_backfill,
            batch_max_seqs=args.batch_max_seqs,
            batch_kv_watermark=args.batch_kv_watermark,
        ),
        parallel=ParallelConfig(
            tensor_parallel_size=args.tensor_parallel_size, moe_backend=args.moe_backend),
        seed=args.seed,
        weights_path=weights_path,
        tokenizer_path=tokenizer_path,
        kv_events_endpoint=args.kv_events_endpoint,
        offload=(OffloadConfig(
            cpu_chunks=args.kv_offload_chunks, fs_dir=args.kv_offload_fs_dir,
            store_master_url=args.kv_store_master_url,
            store_segment_bytes=args.kv_store_segment_bytes,
            store_data_port=args.kv_store_data_port,
            publish_policy=args.kv_publish_policy,
            publish_min_hits=args.kv_publish_min_hits,
        ) if args.kv_offload_chunks else None),
        kv_role=kv_cfg.get("kv_role"),
        kv_transfer_port=int(kv_cfg.get("transfer_port", 9100)),
        kv_transfer_dtype=str(kv_cfg.get("transfer_dtype", "auto")),
        kv_stream_groups=int(kv_cfg.get("stream_groups", 4)),
    )


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from aiohttp import web

    from llmd_tpu_torch.engine import LLMEngine
    from llmd_tpu_torch.serve.api import build_app
    from llmd_tpu_torch.serve.async_engine import AsyncEngine
    from llmd_tpu_torch.serve.tokenizer import load_tokenizer

    if args.otlp_traces_endpoint or args.trace_file:
        from llmd_tpu_torch.obs.tracing import configure_tracing

        configure_tracing(
            "llmd-engine",
            otlp_endpoint=args.otlp_traces_endpoint,
            trace_file=args.trace_file,
            sample_ratio=args.trace_sample_ratio,
        )
    config = make_engine_config(args)
    advertised = args.advertised_address or f"{args.host}:{args.port}"
    if advertised.startswith("0.0.0.0"):
        logging.warning(
            "advertised address %s binds all interfaces; set --advertised-address to the "
            "pod IP or KV-event attribution and P/D transfers will not resolve", advertised)
    config.kv_host = advertised.rsplit(":", 1)[0]
    # The tokenizer first: a bad path fails before the weights load.
    tokenizer = load_tokenizer(config.tokenizer_path)
    event_sink = None
    if config.kv_events_endpoint:
        from llmd_tpu_torch.events import ZMQEventSink

        event_sink = ZMQEventSink(endpoint=config.kv_events_endpoint, pod=advertised)
    try:
        engine = LLMEngine(config, device=args.device, event_sink=event_sink)
    except BaseException:
        if event_sink is not None:
            event_sink.close()
        raise
    if not args.skip_warmup:
        n = engine.warmup()
        logging.info("warmup prepared %d decode programs (CUDA graphs on the card)", n)
    app = build_app(
        AsyncEngine(engine, watchdog_s=args.step_watchdog_s), tokenizer,
        args.served_model_name or args.model, config.model.max_model_len,
    )

    async def _close_engine(app):
        # After the engine thread stops (the app's cleanup context).
        engine.close()
        if event_sink is not None:
            event_sink.close()

    app.on_cleanup.append(_close_engine)
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
