#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``llmd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``llmd_tpu_torch/ops/csrc`` and drives
its main paths at the full width of llama-3-8b, deepseek-v2-lite,
gpt-oss-20b and qwen3-32b (random weights from a seed; llama-3-8b's also
through an HF checkpoint):

1. ``device``  the card's name, and its name and power limit from nvidia-smi.
2. ``build``   nvcc of every kernel source, all started together.
3. ``kernels`` each kernel at llama-3-8b shapes (bf16, 32-layer pool)
               against its plain PyTorch version on the same inputs, and
               timed beside its bound, the plain version and one PyTorch
               library call computing the same function: the flat pair on
               one mixed flat step (3 prefill chunks + 32 decode rows), K1'
               and K2' also on a prefill-only step (one 1,024-token chunk
               over a 3,072-token prefix; K1' bound by operations), the
               decode pair on one decode step (batch bucket 64: 48 live rows
               at 1k-4k context, 16 pad rows). K2' and K4' run their fused
               form (q|k|v bias, rope and store in one launch, q, k and v
               views of one projection output), held bit for bit to the
               plain version in the rotated q and the pool, and timed beside
               the unfused path it replaces (plain bias and rope, then the
               store-only kernel: "unfused_ms") and the store-only kernel
               alone ("store_only_ms"). K1' is timed with the step's query
               tiles built once, as a forward builds them for all layers;
               the K1'/K3' rows carry their tiles ("items"), spans a row
               ("spans") and share of the bound ("bound_share"). Every
               kernel row's "ms" is device time (``device_ms``: 20 calls in
               a CUDA graph), beside the single-call event time
               ("event_ms") and the wrapper's host cost ("host_us"). The
               speculative path's shapes: K1' on a decode-only flat step
               (64 rows of one token, "@decode64") and K1' and K2' on a
               verify-shaped one (64 rows of 1 + 4 tokens, "@verify64x5"),
               whose launches come from the ``spec`` runs below.
4. ``forward`` one mixed flat step and one bucketed decode step (Q = 1, 64
               rows) of the 32-layer model through the kernels and through
               the plain versions on the card, both held to an f32 run.
3b. ``oss_kernels`` the window, sink and int8 branches: K1' on the mixed
               flat step and K3' on the decode step at gpt-oss-20b shapes
               (H 64, K 8, D 64, 24-layer pool), on a sliding layer (window
               128, sinks) and a full layer (sinks), on a bf16 and an int8
               pool, the fused K2' and K4' with the model's q|k|v biases
               on both pools at those shapes; K1'-K4' on an int8 pool at
               llama-3-8b shapes. Each is held to its plain
               version (one bf16 ulp; writes bit-equal) and timed beside its
               bound (the live, in-window positions; int8 at half the bytes
               plus the scales), the plain version and a library call.
3c. ``qwen_kernels`` K1'-K4' at qwen3-32b shapes (H 64, K 8, D 128,
               64-layer pool) on the steps of 3 (K1' and K2' on the mixed and
               the prefill-only flat step, K3' and K4' on the decode step),
               q and k of the fused writes coming out of Qwen3's QK norm;
               held and timed as in 3.
3d. ``quant_kernels`` int8 weights (W8A8): K6''s int8 branch as llama-3-8b's
               dense products (q|k|v, o, gate|up, down, lm_head; G = 1) at
               decode steps of 32 and 64 rows and a 1,024-token prefill,
               qwen3-32b's at a 32-row decode step, deepseek-v2-lite's
               dense-layer down at a 128-token step, and as the experts of
               deepseek-v2-lite and gpt-oss-20b (pair and down, decode and
               prefill), each row with the form ``q8_plan`` gave it (K-major
               int8 weights); ``quantize_rows`` on the rows before them.
               Each bit-equal to its plain version, timed beside its
               bound (bytes, or int8 operations at 1,979 TOP/s), the plain
               version and, for a dense product, ``torch._int_mm`` plus the
               plain epilogue (no PyTorch call computes a grouped int8
               product or quantizes rows). The fused forms of
               ``quantize_rows`` at the same models' shapes:
               ``add_rms_norm_quant`` (llama-3-8b's 4,096 at 32, 64 and
               1,024 rows, qwen3-32b's 5,120, gpt-oss-20b's 2,880 with bo
               and h written) and ``glu_quant`` (llama-3-8b's 14,336 and
               qwen3-32b's 25,600 halves of gate|up, gpt-oss-20b's biased
               clamped SwiGLU over unsorted expert ids at decode and
               prefill, deepseek-v2-lite's experts and shared expert),
               each held to its contract (``norm_quant_case``,
               ``glu_quant_case``) and timed beside the unfused chain it
               replaces ("unfused_ms").
5. ``engine``  ``LLMEngine`` serving 8 greedy requests (chunked prefill and
               a prefix-cache hit included), four times: on the flat step
               (the flat pair must launch layers x steps times each); as
               the split engine with fused decode windows of 8 (the decode
               pair must launch layers x the windows' iterations, the flat
               pair not at all); on the flat step with windows of 8 (the
               flat pair layers x flat steps, the decode pair layers x the
               windows' iterations); and the same on the int8 pool, whose
               greedy tokens are compared with the bf16 pool's, with a
               first-token witness: one flat prefill of the prompts on a
               bf16 pool, and on an int8 pool through the kernels and the
               plain versions (the kernels must pick the plain path's
               first tokens but at a tie). Each engine first runs
               ``warmup`` on a pool of random bytes, which must keep them;
               every decode-only step (each decode window, each flat step
               with no prefill) must then be a CUDA graph replay, its
               staging and replay under ``set_sync_debug_mode("error")``,
               the first one held to its body run eagerly on the same
               inputs and a copy of the pool (tokens, logprobs and pool
               bytes equal), each graph's launches a replay checked per
               kernel branch; captures and replays are counted by key.
               Launches are checked per kernel branch from a log of every
               eager forward and the replays' keys. Every step must read
               back once. Then the host µs a step that the engine's stats
               update costs, on the flat step, alone and with a /metrics
               page rendered every millisecond (``stats_update_cost``).
               Async stepping (``async_scheduling=True``) runs again on
               the flat step, with windows of 8 and on int8 weights (5a),
               on deepseek-v2-lite's int8 default engine (9b) and on
               gpt-oss-20b's ring engine: the same checks, greedy tokens
               beside the same phase's sync tokens (``compare_sync_async``),
               the overlapped calls (scheduling, staging, output assembly)
               under ``set_sync_debug_mode("error")`` (``check_overlap``),
               and at the end nothing in flight, the pool empty and staged
               rows rolled back (``check_async_end``).
5a. int8 weights on llama-3-8b: ``runner_init`` (the int8 tree drawn one
               layer at a time; peak device memory at most the int8 tree
               and pool plus 2 GB), ``forward`` (``q8_forward_phase``: a
               mixed flat step and a decode step through the kernels and the
               plain versions, every int8 product on the int8 kernels, layer
               0's pool bytes equal, held to an f32 run of the int8 tree as
               the bf16 forwards are, the int8 logits beside the bf16
               model's, reported), and ``engine`` on the flat step and with
               windows of 8 (graph replays held to their eager bodies, the
               int8 kernels' launches counted by ``q8_launches``).
5b. ``checkpoint`` llama-3-8b's tree written as an HF checkpoint directory
               (``write_hf_checkpoint``: config.json, safetensors shards of
               at most 5 GB, under ``build/``) and loaded back with the
               port's ``load_params(..., device="cuda")``: every leaf
               bit-equal, write and load seconds, GB/s, the host's peak
               RSS; a runner built from the directory holds its tree bit
               for bit, and its peak device memory to the tree and pool
               plus 2 GB.
6. ``layouts`` the tiny f32 model on the card: the flat step, the split
               engine with windows, the flat step with windows and the
               bucketed unified step give identical greedy and seeded
               streams.
7. ``moe_mla_kernels`` the grouped GEMM at deepseek-v2-lite's expert
               shapes (a 48-row decode step and a 1024-token prefill step)
               and qwen3-30b-a3b's, and the latent decode attention (batch
               bucket 64: 48 live rows at 1k-4k context, 16 pad rows, a
               27-layer latent pool) and the store-only K4' on the latent
               rows of such a step, each against its plain version and
               timed beside its bound, the plain version and a library call.
8. ``forward`` (deepseek-v2-lite) a bucketed prefill forward and a Q = 1
               decode forward of the 27-layer model through the kernels and
               the plain versions; f32 reference on the first 4 layers.
9. ``engine``  (deepseek-v2-lite) ``LLMEngine`` serving 8 greedy requests
               on the default engine (the bucketed unified step: MLA has no
               flat step) and as the split engine with windows of 8; launch
               counts from a log of every eager forward's Q and the graph
               replays, one readback a step, every decode window a graph
               replay, checked as in 5.
9b. int8 weights on deepseek-v2-lite: ``forward`` (a bucketed prefill and
               a decode step, as in 5a) and ``engine`` (the default engine).
10. ``forward`` (gpt-oss-20b) a mixed flat step and a Q = 1 decode
               forward of the 24-layer model (bias leaves filled with small
               seeded values) through the kernels and the plain versions,
               on a bf16 and an int8 pool, launches checked per branch,
               layer 0's pool bytes equal; f32 reference on 4 layers.
11. ``engine`` (gpt-oss-20b) as in 5, on the flat step, as the split
               engine with windows of 8, and on the int8 pool with windows
               of 8 (window, sinks and int8 in one kernel call; its tokens
               beside the flat bf16 run's, and the first-token witness).
11b. int8 weights on gpt-oss-20b: ``runner_init``, ``forward`` and
               ``engine`` on the flat step, as in 5a.
    The SWA ring (``CacheConfig.swa_ring``) on gpt-oss-20b:
    ``ring_kernels`` K1' on the mixed flat step and K3' on the decode
               step (window 128, sinks, bf16 and int8 pools) through a ring
               pool holding each row's latest pages and its ring-view
               table, bit-equal to the call through the full table;
    ``engine`` each of the three layouts on the 8 requests and one of
               8,192 tokens (7 ring wraps), without the ring and then with
               it, as in 5 (both pools checked at replays): tokens and
               logprobs equal;
    ``hybrid_prefix`` a 4,096-token prompt twice: the ring engine's
               repeat seeds its ring from a retained section (one hit,
               4,080 tokens skipped) and equals the no-ring engine's
               repeat, as the cold runs equal each other;
    ``capacity`` 12 requests of 16,384 + 128 tokens at equal KV bytes
               (3.27 GB) with and without the ring: more sequences must
               decode at once with it.
    qwen3-32b (64 layers, 65.5 GB of bf16 weights) at full width and
    depth: ``runner_init`` (peak device memory of a runner drawing the tree
    from the seed, as in 5b), then ``engine`` on the flat step and as the
    split engine with windows of 8, as in 5, on a 1,024-page pool; then
    its int8 tree (32.8 GB, drawn from the same seed a layer at a time)
    through ``runner_init`` and ``engine`` on the flat step, whose int8
    launches are the qwen3-32b rows' of 3d.
12. ``serve``  ``python -m llmd_tpu_torch.serve`` answering three
               ``/v1/completions`` requests (one streamed), then a second
               server with ``--no-unified-step --decode-window 4`` whose
               streamed completion carries one chunk per token and the
               unstreamed completion's text, one with
               ``--async-scheduling`` (its texts the first server's, its
               ``llmd:async_rollbacks_total`` positive), then deepseek-v2-lite,
               gpt-oss-20b (and again with ``--kv-swa-ring``) and
               llama-3-8b with ``--kv-cache-dtype int8`` servers; the
               llama-3-8b checkpoint directory served with the chart's
               flags (``--served-model-name``, ``--max-model-len``,
               ``--block-size``, ``--tokenizer byte``), whose answers must
               equal the first llama server's text for text, and again
               with ``--quantization int8`` (completions, chat, /metrics); and
               qwen3-32b. ``/v1/models`` must report each server's name
               and 8,192 tokens. Each server runs ``warmup`` (its decode
               steps are graph replays) before it answers.
    ``surface`` on the first llama-3-8b server: the routes llm-d's router
               and operators drive (``surface_phase``): /metrics, chat
               completions streamed and not, /v1/cache/probe, the admin
               pause, resume and drain; it reports the scrape latency, the
               chat TTFT and the stats update's cost. The gpt-oss ring
               engine's /metrics page carries the ring's series and the
               binding pool's usage (``ring_metrics``, hybrid_prefix phase).
    The same server runs with ``--otlp-traces-endpoint`` at a stdlib
    collector thread (``OtlpSink``), ``--trace-sample-ratio 1.0`` and
    ``LLMD_FAULT_PLAN`` cutting six chosen request ids
    (``failover_fault_plan``); this script plays llm-d's router:
    ``failover`` a greedy and a seeded chat stream (about 600 prompt
               tokens, 64 output tokens) uncut, then cut after 1, 17 and 63
               frames and resumed with ``resume_token_ids`` and
               ``x-llmd-resume``: 64 tokens stitched, one role preamble, the
               history counted in usage, the resume and fault counters on
               /metrics; reports the tokens agreeing with the uncut stream
               (the top-2 gap of a prefill at the first disagreement) and
               the resumed leg's TTFT and prefix hit.
    ``deadline`` a 0.05 s ``x-request-deadline-s``: 504 ``timeout_error``,
               a terminal 504 frame streamed, the request aborted (the
               engine drains); 60 s answers the undeadlined text.
    ``tracing`` eight requests with sampled ``traceparent``s reach the sink
               as one span each with the caller's ids and the reply's
               usage; eight unsampled ones export nothing; both medians.
    ``responses`` and ``grpc``: /v1/responses (create, retrieve, chain,
               delete, a conversation, the streamed events; greedy text as
               the chat route's) and /vllm.Generation/Generate (streamed and
               not: the completion route's annotated token ids).

    ``spec`` speculative decoding (``SchedulerConfig.speculative_ngram``,
               ``spec_phase``): llama-3-8b on bf16 and on int8 weights (the
               flat step, sync and async, and a fused verify window of 4,
               sync and async), deepseek-v2-lite on int8 weights (its
               bucketed unified step with one-shot verify steps, sync and
               async, and the split engine) and gpt-oss-20b in its ring
               (the flat step and a verify window of 4; the ring's pages
               with the chunk term), each beside the same engine without
               it, on 8 prompts of a 16-token block repeated 8 times, 48
               greedy tokens each: llama-3-8b's widths cut to 4 layers in
               f32 first, and gpt-oss-20b's cut to 6 layers in f32 in its
               ring, whose streams must equal token for token; on bf16
               and int8 a step that batches other positions rounds them
               otherwise, so a stream may part at a tie; every run's every
               token is held to the model in one teacher-forced prefill of
               its stream (``spec_rescore``): within ``SPEC_TOP_GAP_TOL``
               of the top logprob at its position; every token in the vocabulary;
               drafts accepted, one readback a step (a fused verify window
               is one step), every verify step, verify window, decode
               window and decode-only flat step a CUDA graph replay (one a
               dispatch, the first held to its eager body), the pool empty
               at the end. A ``--speculative-ngram`` server answers as the
               plain server did and counts accepted drafts on /metrics.

    ``batch`` the batch tier (``PriorityClass.BATCH``,
               ``batch_phase``) on llama-3-8b's flat step: 8 interactive
               requests (256 prompt tokens, 32 greedy tokens) alone, and
               again arriving when 16 batch requests (512 and 24) hold
               every one of 16 slots, so their admission preempts batch
               rows; every batch row finishes; TTFT and TPOT of the
               interactive requests both ways, the batch counters and the
               ``batch_backfill_utilization`` gauge each step; first on
               llama-3-8b's widths cut to 4 layers in f32, whose
               interactive streams must equal the run without the backlog
               token for token, then at full depth in bf16, where the
               backlog's rows change the flat step's size and so K1''s
               spans (streams may part at a tie): every token is held to
               the model (``spec_rescore``), as in ``spec``.
    ``offload`` the tiered KV offload (``offload_phase``): a 160-page
               device pool, a host tier of 256 pages and a file tier in a
               temporary directory; one 1,000-token prompt P computed cold
               (a recompute), then again (a device hit), 3 other prompts
               that push it out of the device pool, a prompt Q twice, 3
               more that push Q out of the device and P out of host DRAM
               into files; then Q (restored from host DRAM) and P (from
               files): TTFT of each, every restore counted (62 pages a
               prompt, P's from files), each restored stream equal to its
               device-hit run's token for token (the same page bytes and
               the same step), the cold run's reported; Q's restored pages
               on the device equal the plain arithmetic of
               ``scatter_pages`` on its host pages (a float pool's cast,
               the int8 pool's ``quantize_pages``); on llama-3-8b's bf16
               pool (sync, then async: streams and host tiers equal the
               sync run's) and int8 pool, and deepseek-v2-lite's latent
               pool; the host RSS before and after. The async server runs
               with the tiered-prefix-cache guide's
               ``--kv-offload-chunks=25000`` (its start's seconds and
               resident set beside the plain server's),
               ``--kv-offload-fs-dir`` and a 160-page pool: a prompt
               restored after eviction answers as its device hit did, and
               ``x-llmd-priority: batch`` requests count on
               ``llmd:batch_tokens_total``.
    ``pd_exact``, ``pd``, ``pd_serve`` P/D disaggregation
               (``kvtransfer/connector.py``): a producer engine exports a
               finished one-token prefill's KV (answering once the
               prefill is dispatched), a consumer imports it and decodes. ``pd_exact``: llama-3-8b's
               widths cut to 4 layers in f32, the in-process fast path on
               and off, 1 and 4 layer groups: streams equal the aggregated
               engine's token for token, imported pages equal the
               producer's bit for bit. ``pd``: llama-3-8b bf16 full size,
               the consumer with windows of 8, 8 prompts of 1,000 tokens
               and 32 greedy tokens one at a time, over TCP on the v3 wire,
               exact and int8: TTFT against the aggregated engine's and its
               split (the producer's answer and whether the card was
               still busy then, ``last_stage_ms``, ``last_fetch_ms``,
               ``last_apply_ms``), the staging legs' GB/s, exported and imported bytes equal to their
               arithmetic, the q8 codec's device ms against its bound,
               each engine's launches; streams held to the model
               (``spec_rescore``), int8 wire pages within rel 0.01 of the
               producer's; then deepseek-v2-lite's latent pool and
               gpt-oss-20b in its ring (sections exported, pages and ring
               preloaded), each cut to 4 layers. ``pd_serve``: two servers
               in the chart's roles (bound to every interface, each
               advertising 127.0.0.1), this script as the routing sidecar:
               both phases, the streamed decodes held to the model against
               the producer's own answers, the transfer series on both
               /metrics pages, and with the producer stopped the decoder
               answers alone.
    ``events_store`` the KV events and the cross-slice store
               (``events_store_phase``): the port's master
               (``python -m llmd_tpu_torch.kvstore``) as a process; two
               llama-3-8b bf16 engines with 160 device pages, a host tier
               and the store: A (128 host pages, policy ``save``, its
               events on a ``ZMQEventSink`` at ``tcp://127.0.0.1:0``) serves
               4 prompts of 1,000 tokens (16 greedy tokens each), each
               twice (a recompute, then a device hit), the later ones
               evicting the earlier ones' pages from the device and its
               host tier; B (512 host pages, policy ``off``, its tiers
               empty) serves the same prompts from the store, then the
               first again from host DRAM. B's tokens must equal A's
               device hits' (the same steps on the same page bytes), and
               each must be the model's top within the gaps of A's
               recompute (``held_to_model``: a hit's stream may part from
               a recompute's at a bf16 tie);
               ``recompute_avoided_tokens`` the pages B restored from the
               store times 16, as many as its store hits and pulls. A SUB
               reader in this script (``ZmtpSubReader``, on
               ``events/zmtp.py``'s framing) must see every batch of A's,
               numbered with no gap: ``BlockStored`` of media gpu, cpu and
               store, and ``BlockRemoved``. TTFT of a recompute, a store
               hit and a host-DRAM hit, the store pull's GB/s, events a
               second and publish-to-receive ms. Then ``python -m
               llmd_tpu_torch.serve`` with the chart's whole decode-tier
               argv (``--tensor-parallel-size=1``, ``--kv-events-endpoint``,
               ``--moe-backend=grouped``, the consumer's
               ``--kv-transfer-config``, windows of 8) and the store guide's
               flags on the same master (``--skip-warmup``): it answers one
               prompt A published from the store, and ``/metrics`` counts
               the pulls, hits and avoided tokens; its events reach a
               reader under its advertised address. The phase reports the
               host ms of framing and decoding pages, of the publisher's
               puts and of A's saves.
    ``lora``  LoRA on llama-3-8b, bf16 and int8 weights (``lora_phase``):
               four rank-16 PEFT directories written here (one with B all
               zero) loaded into 4 slots after warmup; one batch of the
               base model and the adapters through the flat step and the
               decode windows' graphs: the zero-B row equals the base row
               bit for bit, each adapter's stream is held to its model
               (the adapter merged into q|k|v in f32, ``spec_rescore``),
               a slot written again after capture serves the next replays,
               and the decode step's ms with and without adapters. Then
               ``lora_serve``: a server with ``--lora-pool-slots 2`` over
               the four adapters (cold loads and evictions on /metrics,
               ``vllm:lora_requests_info``, the load and unload routes).
    ``pager`` the decode pager on Mistral-7B-v0.1's shape
               (``pager_phase``: its ``config.json`` written here, random
               weights): ``pager_kernels`` (K1' and K3' with the window
               branch at a 12,288-token context), ``pager`` (4 x 12,288 +
               128 tokens: the pager off, on 4,096 pages and on 1,024
               pages; resident pages within the bound, spill-only streams
               bit-equal, the 1,024-page run held to the model),
               ``pager_park`` (8 x 2,560 + 256: victims park and are
               restored, held to the model) and ``pager_serve`` (a server
               with ``--kv-decode-paging`` on a 2-layer cut).

Each phase prints one JSON line. Any failure raises and exits non-zero
without printing a result. On success the line before the last is the
kernel table, one row per kernel and branch with its launches on its main
path, and the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of ``llmd_tpu``.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# Published H100 SXM peaks (NVIDIA data sheet; at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
MODEL = "llama-3-8b"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase(name: str, info: dict):
    t0 = time.perf_counter()
    yield info
    emit({"phase": name, "seconds": round(time.perf_counter() - t0, 3), **info})


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` single-call times from CUDA events, after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int = 20, reps: int = 7) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, the median of ``reps`` replays over ``calls``. Unlike
    ``cuda_ms`` it leaves out the host's enqueue, which a single-call event
    pair takes in whenever the card waits for it (a Python wrapper's tens of
    microseconds); that host time is reported apart (``host_us``)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def kernel_times(fn) -> dict:
    """A kernel row's times: its device time (``device_ms``, the row's
    "ms"), the single-call event time (``event_ms``, which takes in the
    wrapper's enqueue whenever the card waits for it) and the wrapper's
    host cost a call (``host_us``)."""
    return {"ms": device_ms(fn), "event_ms": cuda_ms(fn), "host_us": host_us(fn)}


# Attention in bf16: the kernel and its plain version both reduce in f32 and
# round the output to bf16 once. Their f32 values agree to 1e-5 (the sums
# run in another order), so the rounded outputs may land one bf16 ulp apart,
# and an ulp is at most 2^-7 of the value: |got - want| must stay within
# BF16_ATOL + BF16_ULP * |want|. At the decode step's outputs (about 0.03)
# that is 2.6e-4, a hundredth of the values, so a dropped position shows.
BF16_ATOL, BF16_ULP = 2e-5, 2.0**-7


def outside_one_ulp(got: torch.Tensor, want: torch.Tensor) -> tuple[float, bool]:
    """(max abs error, whether any output is further than one bf16 ulp from
    the plain version's or is not finite)."""
    diff = (got.float() - want.float()).abs()
    bad = (diff > BF16_ATOL + BF16_ULP * want.float().abs()).any().item()
    return diff.max().item(), bad or not torch.isfinite(got).all().item()


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mixed_step(cfg, page, max_pages, prefills, decode_ctx, gen, dev):
    """A packed flat step: prefill chunks (prefix, chunk) then one-token
    decode rows at context lengths ``decode_ctx``; every row gets its own
    physical pages (a random permutation of the pool). Returns the
    per-token tensors, the page table, the live count (``total``, and as
    the flat KV write takes it, ``num_live``) and the pool size in pages."""
    rows_spec = [(p0, w) for p0, w in prefills] + [(c - 1, 1) for c in decode_ctx]
    need = [-(-(p0 + w) // page) for p0, w in rows_spec]
    num_pages = sum(need) + 8
    perm = torch.randperm(num_pages, generator=gen, device="cpu").to(torch.int32)
    page_table = torch.zeros((len(rows_spec), max_pages), dtype=torch.int32)
    rows, positions, off = [], [], 0
    for r, ((p0, w), n) in enumerate(zip(rows_spec, need)):
        page_table[r, :n] = perm[off : off + n]
        off += n
        rows += [r] * w
        positions += list(range(p0, p0 + w))
    total = len(rows)
    T = -(-total // 16) * 16
    rows += [len(rows_spec) - 1] * (T - total)
    positions += [0] * (T - total)
    rows_t = torch.tensor(rows, dtype=torch.int32, device=dev)
    pos_t = torch.tensor(positions, dtype=torch.int32, device=dev)
    live = torch.arange(T, device=dev) < total
    kv_lens = torch.where(live, pos_t + 1, 0).to(torch.int32)
    return {
        "rows": rows_t, "positions": pos_t, "kv_lens": kv_lens,
        "page_table": page_table.to(dev), "total": total, "T": T,
        "num_live": torch.tensor([total], dtype=torch.int32, device=dev),
        "num_pages": num_pages, "rows_spec": rows_spec,
    }


def attention_plan(kind: str, step: dict, H: int, K: int, page: int, window: int = 0) -> dict:
    """How K1' ("flat") or K3' ("decode") cuts this step, as the wrappers
    cut it: the flat step's query tiles (built once, as a forward builds
    them for all its layers, and passed to every timed call), the tiles'
    count and the spans a row's pages are cut into."""
    from llmd_tpu_torch.ops import ragged_paged_attention as rpa

    live = rpa.live_pages_bound(step["page_table"].shape[1], page, window)
    sms = rpa._sm_count(0)
    if kind == "decode":
        return {"items": step["B"], "spans": rpa.spans_for(step["B"] * K, live, sms)}
    items = rpa.flat_work_items(step["rows"], step["kv_lens"], H // K)
    grid = rpa.flat_grid(step["T"], step["page_table"].shape[0], H // K)
    return {"tiles": items, "items": int((items[:, 1] > 0).sum().item()),
            "spans": rpa.spans_for(grid * K, live, sms)}


def flat_attention_row(name: str, q, pool, layer: int, s: dict, page: int) -> dict:
    """K1' on the flat step ``s``: within one bf16 ulp
    of the plain version (outside_one_ulp), pads zero; timed with the
    step's query tiles built once, beside its bound, the plain version and
    SDPA. The bound: every row's distinct live K|V read once, q read, out
    written; operations: QK and PV, 2 flops per multiply-add, per (token,
    position) pair."""
    from llmd_tpu_torch import ops

    H, K = q.shape[2], pool.shape[2]
    plan = attention_plan("flat", s, H, K, page)
    aargs = (q, pool, layer, s["rows"], s["page_table"], s["kv_lens"])
    got = ops.flat_paged_attention_full(*aargs)
    want = ops.flat_paged_attention_plain(*aargs)
    torch.cuda.synchronize()
    err, bad = outside_one_ulp(got[: s["total"]], want[: s["total"]])
    if bad or got[s["total"]:].any():
        raise AssertionError(f"{name}: max abs err {err} vs plain, or a pad is not zero")
    del got, want
    es, D = pool.element_size(), q.shape[3]
    ctx = [p0 + w for p0, w in s["rows_spec"]]
    kv_bytes = sum(ctx) * K * 2 * D * es
    qo_bytes = 2 * s["total"] * H * D * es
    b_ms, b_by = bound(kv_bytes + qo_bytes, 4.0 * H * D * s["kv_lens"].sum().item())
    tiles = plan["tiles"]
    times = kernel_times(lambda: ops.flat_paged_attention_full(*aargs, items=tiles))
    ms = times["ms"]
    return {
        "name": name, "route": "cuda",
        "source": "llmd_tpu_torch/ops/csrc/flat_paged_attention.cu",
        "replaces": "llmd_tpu/ops/ragged_paged_attention.py:344",
        "max_abs_err": err, **times,
        "plain_ms": cuda_ms(lambda: ops.flat_paged_attention_plain(*aargs), reps=10, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": _sdpa_yardstick(q, pool, layer, s, page),
        "bound_share": b_ms / ms, "items": plan["items"], "spans": plan["spans"],
        "items_ms": cuda_ms(lambda: ops.flat_work_items(s["rows"], s["kv_lens"], H // K)),
    }


# The kernel rows' keys a phase's line carries.
WRITE_KEYS = ("max_abs_err", "ms", "event_ms", "host_us", "plain_ms", "bound_ms", "library_ms",
              "bound_share", "unfused_ms", "store_only_ms")
# The fused forms' entries live in these files (their body in
# rope_kv_write.cuh, which both include).
WRITE_SOURCES = {
    "flat": ("llmd_tpu_torch/ops/csrc/flat_kv_write.cu", "llmd_tpu/ops/kv_write.py:212"),
    "decode": ("llmd_tpu_torch/ops/csrc/decode_kv_write.cu", "llmd_tpu/ops/kv_write.py:298"),
}


def rope_write_case(name: str, kind: str, cfg, data, scales, layer: int, step: dict,
                    bias: bool, g, qk_norm: bool = False) -> dict:
    """The fused K2' ("flat", on a flat step) or K4' ("decode", on a decode
    batch) at ``cfg``'s widths: q, k and v are views of one bf16 q|k|v
    projection output, with seeded biases (scale 0.02) where ``bias``, the
    cos/sin of ``cfg``'s rope at the step's positions; with ``qk_norm``, q
    and k come out of Qwen3's per-head RMS norm (seeded weights) as tensors
    of their own, as the model passes them. Held bit for bit to
    its plain version (bias, ``apply_rope``, the plain store) in the rotated
    q of every row, the pool's bytes and an int8 pool's scales, and so is
    the unfused path it replaces (plain bias and rope, then the store-only
    kernel: what the model ran before the fused form). Timed in device time
    (``device_ms``, 20 calls in a CUDA graph) beside the unfused path's
    device time ("unfused_ms", the yardstick), the store-only kernel's alone
    ("store_only_ms"), the plain version and ``index_put_`` of the stored
    rows (the library column; int8: the plainly quantized rows and their
    scales). The byte bound counts every row's q in and out, the live rows'
    k and v in and their pool rows out (int8: a byte an element and 8 bytes
    of scales a head), the biases, the cos/sin rows and the addressing."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.models.common import apply_rope, rms_norm, rope_tables

    dev, dt = data.device, torch.bfloat16
    K, page, D = data.shape[2], data.shape[3], data.shape[4] // 2
    Nq = cfg.num_heads
    if kind == "flat":
        N, n_live, positions = step["T"], step["total"], step["positions"]
        addr = (step["page_table"], step["rows"], positions, step["num_live"])
        kernel_fn, plain_fn = ops.rope_write_kv_flat_full, ops.rope_write_kv_flat_plain
    else:
        N, n_live, positions = step["B"], step["n_live"], step["positions"][:, 0]
        addr = (step["phys"], step["offset"], step["valid"])
        kernel_fn, plain_fn = ops.rope_write_kv_decode_full, ops.rope_write_kv_decode_plain
    qkv = torch.randn((N, (Nq + 2 * K) * D), generator=g, device=dev, dtype=dt)
    q = qkv[:, : Nq * D].view(N, Nq, D)
    k = qkv[:, Nq * D : (Nq + K) * D].view(N, K, D)
    v = qkv[:, (Nq + K) * D :].view(N, K, D)
    b = (tuple(torch.randn((n * D,), generator=g, device=dev).mul_(0.02).to(dt) for n in (Nq, K, K))
         if bias else None)
    if qk_norm:
        wq, wk = (1 + 0.1 * torch.randn((2, D), generator=g, device=dev)).to(dt)
        q, k = rms_norm(q, wq, cfg.rms_norm_eps), rms_norm(k, wk, cfg.rms_norm_eps)
    cos, sin = rope_tables(positions, D, cfg.rope_theta, cfg.rope_scaling)
    pool = data if scales is None else (data, scales)

    def kernel():
        return kernel_fn(data, layer, q, k, v, cos, sin, *addr, b, scales)

    def plain():
        return plain_fn(data, layer, q, k, v, cos, sin, *addr, b, scales)

    c4, s4 = cos[:, None], sin[:, None]

    def unfused():
        qb, kb, vb = ops.add_qkv_bias(q[:, None], k[:, None], v[:, None], b)
        qr, kr = apply_rope(qb, c4, s4), apply_rope(kb, c4, s4)
        if kind == "flat":
            ops.write_kv_pages_full_flat(pool, layer, kr, vb, *addr[:2], positions[:, None], addr[3])
        else:
            ops.write_kv_pages_full(pool, layer, kr, vb, step["page_table"], step["positions"],
                                    step["valid"][:, None] > 0, addr)
        return qr[:, 0]

    # Only the layer's plane is written: it alone is saved and compared.
    plane = tuple(t[layer] for t in pool_parts(pool))
    before = tuple(t.clone() for t in plane)
    outs = []
    for fn in (kernel, plain, unfused):
        for t, src in zip(plane, before):
            t.copy_(src)
        outs.append((fn(), tuple(t.clone() for t in plane)))
    torch.cuda.synchronize()
    (got, got_pool), (want, want_pool), (old, old_pool) = outs
    if not (torch.equal(got, want) and all(map(torch.equal, got_pool, want_pool))):
        raise AssertionError(f"{name}: rotated q or pool bytes differ from the plain version")
    if not (torch.equal(old, want) and all(map(torch.equal, old_pool, want_pool))):
        raise AssertionError(f"{name}: the unfused path differs from the plain version")
    if all(map(torch.equal, got_pool, before)):
        raise AssertionError(f"{name}: the write stored nothing")
    del outs, got_pool, want_pool, old_pool, before
    # The stored rows, rotated, for the store-only kernel and index_put_.
    qb, kb, vb = ops.add_qkv_bias(q, k, v, b)
    kr = apply_rope(kb[:, None], c4, s4)[:, 0].contiguous()
    vr = vb.contiguous()
    if kind == "flat":
        store_only = lambda: ops.write_kv_pages_flat_full(  # noqa: E731
            data, layer, kr[:, None], vr[:, None], *addr, scales)
        pos = positions[:n_live].long()
        phys = step["page_table"][step["rows"][:n_live].long(), pos // page].long()
        slot = pos % page
    else:
        kv_new = torch.cat([kr, vr], dim=-1)
        store_only = lambda: ops.write_kv_pages_decode_full(data, kv_new, layer, *addr, scales)  # noqa: E731
        phys, slot = step["phys"][:n_live].long(), step["offset"][:n_live].long()
    heads = torch.arange(K, device=dev)
    idx = (phys[:, None], heads[None, :], slot[:, None])
    dl = data[layer]
    if scales is None:
        kv = torch.cat([kr[:n_live], vr[:n_live]], dim=-1)
        out_bytes = kv.numel() * kv.element_size()
        library = lambda: dl.index_put_(idx, kv)  # noqa: E731
    else:
        k8, v8, srow = ops.quantize_kv_rows(kr[:n_live], vr[:n_live])
        kv, sl = torch.cat([k8, v8], dim=-1), scales[layer]
        out_bytes = kv.numel() + srow.numel() * 4
        library = lambda: (dl.index_put_(idx, kv), sl.index_put_(idx, srow))  # noqa: E731
    es = q.element_size()
    nbytes = (2 * N * Nq * D + 2 * n_live * K * D) * es + out_bytes + 2 * N * (D // 2) * 4
    nbytes += (Nq + 2 * K) * D * es if bias else 0
    nbytes += 3 * 4 * (n_live if kind == "flat" else N)
    b_ms, b_by = bound(nbytes, 0.0)
    times = kernel_times(kernel)
    source, replaces = WRITE_SOURCES[kind]
    key = ops.write_branch(scales is not None, rope=True, bias=bias)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "max_abs_err": 0.0, **times, "plain_ms": cuda_ms(plain, reps=10, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(library),
        "bound_share": b_ms / times["ms"], "unfused_ms": device_ms(unfused),
        "store_only_ms": device_ms(store_only), "rows": N, "live_rows": n_live,
        "wrapper": f"write_kv_pages_{kind}_full", "branch": key, "model": cfg.name,
    }



def kernels_phase(info: dict) -> dict:
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(MODEL)
    dev, dt = torch.device("cuda"), torch.bfloat16
    L, K, H, D, page = cfg.num_layers, cfg.num_kv_heads, cfg.num_heads, cfg.head_dim, 16
    max_pages = -(-cfg.max_model_len // page)
    gen = torch.Generator().manual_seed(1234)
    # 3 prefill chunks of 128-512 tokens at prefixes 0-2k, 32 decode rows
    # at contexts 1k-4k: T = 928 live tokens of a 1024-token budget.
    decode_ctx = torch.randint(1024, 4097, (32,), generator=gen).tolist()
    s = mixed_step(cfg, page, max_pages, [(0, 512), (1024, 256), (2000, 128)],
                   decode_ctx, gen, dev)
    T, total = s["T"], s["total"]
    layer = L // 2
    g = torch.Generator(device=dev).manual_seed(99)
    pool = torch.randn((L, s["num_pages"], K, page, 2 * D), generator=g, device=dev, dtype=dt)
    q = torch.randn((T, 1, H, D), generator=g, device=dev, dtype=dt)
    info.update(T=T, live_tokens=total, pool_pages=s["num_pages"], layers=L)
    out = []

    # --- K2' in its fused form (bias-free, as llama has no q|k|v bias): the
    # rotated q and the pool bytes must equal the plain version's exactly.
    out.append(rope_write_case("flat_kv_write[rope]", "flat", cfg, pool, None, layer, s,
                               False, g))

    # --- K1': flat paged attention on the mixed step, and on a prefill-only
    # step (one 1,024-token chunk over a 3,072-token prefix: 3.67 M
    # (token, position) pairs, bound by operations) that shows the tensor
    # cores the mixed step hides behind its decode rows' bytes.
    out.append(flat_attention_row("flat_paged_attention", q, pool, layer, s, page))
    del pool
    torch.cuda.empty_cache()
    pre = mixed_step(cfg, page, max_pages, [(3072, 1024)], [], gen, dev)
    pool = torch.randn((L, pre["num_pages"], K, page, 2 * D), generator=g, device=dev, dtype=dt)
    qp = torch.randn((pre["T"], 1, H, D), generator=g, device=dev, dtype=dt)
    out.append(flat_attention_row("flat_paged_attention@prefill", qp, pool, layer, pre, page))
    # K2' fused on the same prefill step: 1,024 tokens, bound by bytes.
    out.append(rope_write_case("flat_kv_write[rope]@prefill", "flat", cfg, pool, None, layer,
                               pre, False, g))
    del pool
    torch.cuda.empty_cache()
    # The speculative path's shapes: a decode-only flat step (64 rows of
    # one token) and a verify-shaped one (64 rows of 1 + 4 draft tokens,
    # a stream of 320), at contexts 1k-4k.
    for label, width in (("decode64", 1), ("verify64x5", 5)):
        ctx = torch.randint(1024, 4097, (64,), generator=gen).tolist()
        st = mixed_step(cfg, page, max_pages, [(c - width, width) for c in ctx], [], gen, dev)
        pool = torch.randn((L, st["num_pages"], K, page, 2 * D), generator=g, device=dev, dtype=dt)
        qs = torch.randn((st["T"], 1, H, D), generator=g, device=dev, dtype=dt)
        out.append(flat_attention_row(f"flat_paged_attention@{label}", qs, pool, layer, st, page))
        if width > 1:
            out.append(rope_write_case(f"flat_kv_write[rope]@{label}", "flat", cfg, pool, None,
                                       layer, st, False, g))
        del pool, qs
        torch.cuda.empty_cache()
    for e in out:
        info[e["name"]] = {key: e[key] for key in WRITE_KEYS + (
            "items", "spans", "items_ms") if key in e}
    return {e["name"]: e for e in out}


def decode_batch(cfg, page, lo, hi, gen, dev) -> dict:
    """One decode step (one token per row) of the batch bucket 64: 48 live
    rows at contexts drawn from [lo, hi], each writing its last position,
    then 16 pad rows (kv_len = 0, valid = 0, a garbage physical page).
    Every live row gets its own physical pages."""
    B, n_live = 64, 48
    ctx = torch.randint(lo, hi + 1, (n_live,), generator=gen).tolist()
    need = [-(-c // page) for c in ctx]
    num_pages = sum(need) + 8
    perm = torch.randperm(num_pages, generator=gen).to(torch.int32)
    page_table = torch.zeros((B, -(-cfg.max_model_len // page)), dtype=torch.int32)
    off = 0
    for r, n in enumerate(need):
        page_table[r, :n] = perm[off : off + n]
        off += n
    kv_lens = torch.tensor(ctx + [0] * (B - n_live), dtype=torch.int32)
    pos = (kv_lens - 1).clamp(min=0)
    phys = page_table[torch.arange(B), (pos // page).long()].clone()
    phys[n_live:] = 2**30  # pad rows: never dereferenced
    return {
        "B": B, "n_live": n_live, "ctx": ctx, "num_pages": num_pages,
        "live_pages": max(need),
        "page_table": page_table.to(dev), "kv_lens": kv_lens.to(dev),
        "positions": pos[:, None].to(dev), "phys": phys.to(dev),
        "offset": (pos % page).to(dev), "valid": (kv_lens > 0).to(torch.int32).to(dev),
    }


def decode_kernels_phase(info: dict) -> dict:
    """K3' and K4' on one decode step of the batch bucket 64: 48 live rows
    at contexts spread over 1,024-4,096 tokens, then 16 pad rows
    (valid = 0, kv_len = 0, a garbage physical page)."""
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(MODEL)
    dev, dt = torch.device("cuda"), torch.bfloat16
    L, K, H, D, page = cfg.num_layers, cfg.num_kv_heads, cfg.num_heads, cfg.head_dim, 16
    d = decode_batch(cfg, page, 1024, 4096, torch.Generator().manual_seed(4321), dev)
    B, num_pages = d["B"], d["num_pages"]
    layer = L // 2
    g = torch.Generator(device=dev).manual_seed(77)
    pool = torch.randn((L, num_pages, K, page, 2 * D), generator=g, device=dev, dtype=dt)
    q = torch.randn((B, 1, H, D), generator=g, device=dev, dtype=dt)
    info.update(batch=B, live_rows=d["n_live"], context_tokens=sum(d["ctx"]), pool_pages=num_pages,
                pool_gib=pool.numel() * pool.element_size() / 2**30, layers=L)
    out = []

    # --- K4' in its fused form: the rotated q, pool bytes equal the plain
    # version's exactly; the pad rows' garbage targets are left alone.
    out.append(rope_write_case("decode_kv_write[rope]", "decode", cfg, pool, None, layer, d,
                               False, g))

    # --- K3': decode paged attention.
    out.append(decode_attention_row("decode_paged_attention", q, pool, layer, d, page))
    for e in out:
        info[e["name"]] = {key: e[key] for key in WRITE_KEYS + ("items", "spans") if key in e}
    return {e["name"]: e for e in out}


def decode_attention_row(name: str, q, pool, layer: int, d: dict, page: int) -> dict:
    """K3' on the decode batch ``d``: within one bf16 ulp of the plain
    version (outside_one_ulp), pad rows exactly zero; timed beside its
    bound, the plain version and SDPA. The bound: every live row's K|V
    read once, q read, out written; operations: QK and PV, 2 flops per
    multiply-add."""
    from llmd_tpu_torch import ops

    B, _, H, D = q.shape
    K, es = pool.shape[2], pool.element_size()
    n_live, ctx, live_pages = d["n_live"], d["ctx"], d["live_pages"]
    aargs = (q, pool, layer, d["page_table"], d["kv_lens"])
    got = ops.decode_paged_attention_full(*aargs)
    want = ops.decode_paged_attention_plain(*aargs, live_pages=live_pages)
    torch.cuda.synchronize()
    err, bad = outside_one_ulp(got, want)
    if bad:
        raise AssertionError(f"{name}: max abs err {err} vs plain")
    if got[n_live:].any():
        raise AssertionError(f"{name}: a pad row is not zero")
    del got, want
    kv_bytes = sum(ctx) * K * 2 * D * es
    qo_bytes = 2 * B * H * D * es
    b_ms, b_by = bound(kv_bytes + qo_bytes, 4.0 * H * D * sum(ctx))
    spec = {"rows_spec": [(c - 1, 1) for c in ctx], "page_table": d["page_table"]}
    lib_ms = _sdpa_yardstick(q[:n_live], pool, layer, spec, page)
    times = kernel_times(lambda: ops.decode_paged_attention_full(*aargs))
    plan = attention_plan("decode", d, H, K, page)
    return {
        "name": name, "route": "cuda",
        "source": "llmd_tpu_torch/ops/csrc/decode_paged_attention.cu",
        "replaces": "llmd_tpu/ops/ragged_paged_attention.py:463",
        "max_abs_err": err, **times,
        "plain_ms": cuda_ms(
            lambda: ops.decode_paged_attention_plain(*aargs, live_pages=live_pages), reps=10),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "bound_share": b_ms / times["ms"], "items": plan["items"], "spans": plan["spans"],
    }


def _sdpa_yardstick(q, pool, layer, s, page, window: int = 0, sinks=None,
                    max_q: int | None = None) -> float:
    """Device time of one ``scaled_dot_product_attention`` call on the same step,
    with each row's live context gathered to a dense, padded layout
    beforehand (the gather is not timed). A sliding ``window`` is part of
    the mask; ``sinks`` ([H]) append one zero key and zero value whose mask
    bias is the head's sink logit (a per-head float mask, so ``max_q``
    splits long prefill rows into sub-rows of that many queries to keep it
    small). ``pool`` is a float pool (an int8 pool is dequantized first)."""
    import torch.nn.functional as F

    T, _, H, D = q.shape
    K = pool.shape[2]
    segs, t = [], 0  # (table row, first position, queries, first token)
    for r, (p0, w) in enumerate(s["rows_spec"]):
        step = max_q or w
        for off in range(0, w, step):
            segs.append((r, p0 + off, min(step, w - off), t + off))
        t += w
    R = len(segs)
    qmax = max(w for _, _, w, _ in segs)
    smax = max(p0 + w for _, p0, w, _ in segs)
    dev = q.device
    Qd = torch.zeros((R, H, qmax, D), dtype=q.dtype, device=dev)
    Kd = torch.zeros((R, K, smax + 1, D), dtype=q.dtype, device=dev)
    Vd = torch.zeros_like(Kd)
    mask = torch.zeros((R, 1, qmax, smax + 1), dtype=torch.bool, device=dev)
    mask[..., 0] = True  # pad query slots: keep one key so no row is empty
    for i, (r, p0, w, t0) in enumerate(segs):
        n = p0 + w
        pages = s["page_table"][r, : -(-n // page)].long()
        kv = pool[layer, pages].permute(1, 0, 2, 3).reshape(K, -1, 2 * D)[:, :n]
        Kd[i, :, :n] = kv[..., :D]
        Vd[i, :, :n] = kv[..., D:]
        Qd[i, :, :w] = q[t0 : t0 + w, 0].transpose(0, 1)
        key = torch.arange(n, device=dev)[None, :]
        qpos = torch.arange(p0, p0 + w, device=dev)[:, None]
        live = key <= qpos
        if window:
            live &= key > qpos - window
        mask[i, 0, :w, :n] = live
    G = H // K
    Kd = Kd.repeat_interleave(G, dim=1)
    Vd = Vd.repeat_interleave(G, dim=1)
    if sinks is None:
        Kd, Vd, mask = Kd[:, :, :smax], Vd[:, :, :smax], mask[..., :smax]
        return device_ms(lambda: F.scaled_dot_product_attention(Qd, Kd, Vd, attn_mask=mask))
    # The last key column is the zero key: its score is the bias alone.
    bias = torch.where(mask, 0.0, float("-inf")).to(q.dtype).expand(R, H, qmax, smax + 1).clone()
    bias[..., smax] = sinks.to(q.dtype)[None, :, None]
    del mask
    return device_ms(lambda: F.scaled_dot_product_attention(Qd, Kd, Vd, attn_mask=bias))


@contextlib.contextmanager
def plain_ops(live_pages: int | None = None):
    """Route the model's fused KV writes (MLA's latent form too), flat
    attention, decode kernels,
    latent decode attention, grouped GEMM and the int8 kernels (K6''s int8
    branch, ``quantize_rows`` and its fused forms ``add_rms_norm_quant`` and
    ``glu_quant``) to their plain versions (the
    reference runs of the forward phases), restoring the kernels after.
    ``live_pages`` bounds the plain decode attentions' gathers."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.ops import grouped_gemm, quant

    saved = (ops.rope_write_kv_flat_full, ops.rope_write_kv_decode_full,
             ops.rope_write_latent_full, ops.paged_attention_full_flat,
             ops.write_kv_pages_decode_full, ops.decode_paged_attention_full,
             ops.mla_decode_paged_attention_full, grouped_gemm.grouped_matmul,
             grouped_gemm.grouped_matmul_pair, quant.quantize_rows, grouped_gemm.matmul_q8,
             grouped_gemm.grouped_matmul_q8, grouped_gemm.grouped_matmul_q8_pair,
             quant.add_rms_norm_quant, quant.glu_quant)

    def attend(q, kv_cache, layer, rows, page_table, kv_lens, sm_scale=None,
               window=0, sinks=None, items=None):  # the plain version needs no tiles
        data, scales = ops._split_cache(kv_cache)
        return ops.flat_paged_attention_plain(
            q, data, layer, rows, page_table, kv_lens, sm_scale, window, sinks, scales
        )

    def decode_attend(q, kv_cache, layer, page_table, kv_lens, sm_scale=None,
                      window=0, sinks=None, scales=None):
        return ops.decode_paged_attention_plain(
            q, kv_cache, layer, page_table, kv_lens, sm_scale, live_pages, window,
            sinks, scales,
        )

    def latent_attend(q_eff, cache, layer, page_table, kv_lens, rank, sm_scale):
        return ops.mla_decode_paged_attention_plain(
            q_eff, cache, layer, page_table, kv_lens, rank, sm_scale, live_pages
        )

    ops.rope_write_kv_flat_full = ops.rope_write_kv_flat_plain
    ops.rope_write_kv_decode_full = ops.rope_write_kv_decode_plain
    ops.rope_write_latent_full = ops.rope_write_latent_plain
    ops.paged_attention_full_flat = attend
    ops.write_kv_pages_decode_full = ops.write_kv_pages_decode_plain
    ops.decode_paged_attention_full = decode_attend
    ops.mla_decode_paged_attention_full = latent_attend
    grouped_gemm.grouped_matmul = ops.grouped_matmul_plain
    grouped_gemm.grouped_matmul_pair = ops.grouped_matmul_pair_plain
    quant.quantize_rows = ops.quantize_rows_plain
    grouped_gemm.matmul_q8 = ops.matmul_q8_plain
    grouped_gemm.grouped_matmul_q8 = ops.grouped_matmul_q8_plain
    grouped_gemm.grouped_matmul_q8_pair = ops.grouped_matmul_q8_pair_plain
    quant.add_rms_norm_quant = ops.add_rms_norm_quant_plain
    quant.glu_quant = ops.glu_quant_plain
    try:
        yield
    finally:
        (ops.rope_write_kv_flat_full, ops.rope_write_kv_decode_full,
         ops.rope_write_latent_full, ops.paged_attention_full_flat,
         ops.write_kv_pages_decode_full, ops.decode_paged_attention_full,
         ops.mla_decode_paged_attention_full, grouped_gemm.grouped_matmul,
         grouped_gemm.grouped_matmul_pair, quant.quantize_rows, grouped_gemm.matmul_q8,
         grouped_gemm.grouped_matmul_q8, grouped_gemm.grouped_matmul_q8_pair,
         quant.add_rms_norm_quant, quant.glu_quant) = saved


def forward_phase(info: dict, params: dict) -> None:
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.common import StepInput
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(MODEL)
    dev, page = torch.device("cuda"), 16
    gen = torch.Generator().manual_seed(7)
    g = torch.Generator(device=dev).manual_seed(5)
    L = cfg.num_layers

    # The mixed flat step.
    decode_ctx = torch.randint(200, 1001, (16,), generator=gen).tolist()
    s = mixed_step(cfg, page, -(-cfg.max_model_len // page),
                   [(0, 300), (600, 200)], decode_ctx, gen, dev)
    live = torch.arange(s["T"], device=dev) < s["total"]
    ids = torch.randint(0, cfg.vocab_size, (s["T"],), generator=g, device=dev)
    flat_inp = StepInput(
        token_ids=torch.where(live, ids, 0)[:, None],
        positions=s["positions"][:, None],
        kv_lens=s["kv_lens"],
        page_table=s["page_table"],
        token_rows=s["rows"],
        num_live=s["num_live"],
    )
    # The bucketed decode step (Q = 1), at contexts of 128-640 tokens.
    d = decode_batch(cfg, page, 128, 640, gen, dev)
    ids = torch.randint(0, cfg.vocab_size, (d["B"], 1), generator=g, device=dev)
    decode_inp = StepInput(
        token_ids=torch.where(d["valid"][:, None] > 0, ids, 0),
        positions=d["positions"], kv_lens=d["kv_lens"],
        page_table=d["page_table"], query_lens=d["valid"],
    )
    steps = {
        # name: (input, pool pages, live rows of the hidden state, the
        # wrappers that must launch once a layer, plain gather bound)
        "flat": (flat_inp, s["num_pages"], s["total"],
                 ("write_kv_pages_flat_full", "flat_paged_attention_full"), None),
        "decode": (decode_inp, d["num_pages"], d["n_live"],
                   ("write_kv_pages_decode_full", "decode_paged_attention_full"),
                   d["live_pages"]),
    }
    # The same weights upcast: the f32 reference both bf16 runs are
    # measured from.
    params32 = _tree_map(params, lambda w: w.float())

    def rel(a: torch.Tensor, b: torch.Tensor) -> float:
        return ((a - b).norm() / b.norm()).item()

    for name, (inp, num_pages, n_live, wrappers, live_pages) in steps.items():
        shape = (L, num_pages, cfg.num_kv_heads, page, 2 * cfg.head_dim)
        pool = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)

        def run(p: dict, work: torch.Tensor, plain: bool):
            """One forward that writes into ``work`` (a fresh copy of the
            pool); returns the live hidden states in f32 and layer 0 of
            the written pool."""
            ctx = plain_ops(live_pages) if plain else contextlib.nullcontext()
            with torch.inference_mode(), ctx:
                h, _ = llama.forward_hidden(p, work, inp, cfg)
            return h.reshape(-1, h.shape[-1])[:n_live].float(), work[0].clone()

        ops.reset_launch_counts()
        h_k, pool0_k = run(params, pool.clone(), plain=False)
        counts = ops.launch_counts()
        h_p, pool0_p = run(params, pool.clone(), plain=True)
        h_k32, _ = run(params32, pool.float(), plain=False)
        h_ref, _ = run(params32, pool.float(), plain=True)
        with torch.inference_mode():
            # Whole-step times in bf16 (a step rewrites the same K|V, so
            # the pool keeps its contents), CUDA events.
            fwd_ms = cuda_ms(lambda: llama.forward_hidden(params, pool, inp, cfg), reps=3, warmup=1)
            with plain_ops(live_pages):
                fwd_plain_ms = cuda_ms(
                    lambda: llama.forward_hidden(params, pool, inp, cfg), reps=3, warmup=1
                )
        torch.cuda.synchronize()
        want = {fn: (L if fn in wrappers else 0) for fn in counts}
        if counts != want:
            raise AssertionError(f"{name} forward launched {counts}, want {want}")
        r = {
            "live_rows": n_live, "rows": inp.token_ids.shape[0], "layers": L,
            "f32_rel_err": rel(h_k32, h_ref), "bf16_rel_err": rel(h_k, h_p),
            "bf16_kernels_vs_f32": rel(h_k, h_ref), "bf16_plain_vs_f32": rel(h_p, h_ref),
            "layer0_pool_equal": bool(torch.equal(pool0_k, pool0_p)),
            "step_ms": fwd_ms, "step_plain_ms": fwd_plain_ms,
        }
        info[name] = r
        if not all(torch.isfinite(h).all() for h in (h_k, h_p, h_k32, h_ref)):
            raise AssertionError(f"{name} forward: non-finite hidden states")
        # Layer 0 writes K|V computed from the same inputs on both paths:
        # the kernel's pool bytes must equal the plain version's.
        if not r["layer0_pool_equal"]:
            raise AssertionError(f"{name} forward: layer-0 pool bytes differ between the paths")
        # f32: the two paths differ only in the attention's summation order
        # (about 1e-6 relative per layer), amplified through 32 random layers.
        if r["f32_rel_err"] > 1e-3:
            raise AssertionError(f"{name} forward: f32 relative error {r['f32_rel_err']} (limit 1e-3)")
        # bf16: a one-ulp difference in an attention output grows through 32
        # layers of bf16 matmuls, so the two bf16 runs are not compared with
        # each other; instead the kernels' run may be no further from the f32
        # run than 1.5 times the plain run's distance.
        if r["bf16_kernels_vs_f32"] > 1.5 * r["bf16_plain_vs_f32"]:
            raise AssertionError(
                f"{name} forward: bf16 kernels {r['bf16_kernels_vs_f32']} from f32, "
                f"plain {r['bf16_plain_vs_f32']} (limit 1.5x)"
            )
        del pool, pool0_k, pool0_p, h_k, h_p, h_k32, h_ref
        torch.cuda.empty_cache()
    del params32


def _tree_map(tree: dict, fn) -> dict:
    return {k: _tree_map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@contextlib.contextmanager
def counting_readbacks():
    """Count the device->host copies (``Tensor.cpu``) made inside."""
    calls = []
    orig = torch.Tensor.cpu

    def cpu(self, *args, **kwargs):
        calls.append(tuple(self.shape))
        return orig(self, *args, **kwargs)

    torch.Tensor.cpu = cpu
    try:
        yield calls
    finally:
        torch.Tensor.cpu = orig


def pool_parts(pool) -> tuple:
    """The tensors of a pool: one, or the int8 pool's (data, scales)."""
    return pool if isinstance(pool, tuple) else (pool,)


def clone_pool(pool):
    return tuple(t.clone() for t in pool) if isinstance(pool, tuple) else pool.clone()


def pools_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(pool_parts(a), pool_parts(b)))


def runner_pools(runner) -> tuple:
    """A runner's pools: the main one, and under the ring the ring pool."""
    return (runner.kv_cache,) if runner.kv_swa is None else (runner.kv_cache, runner.kv_swa)


def randomize_pool(pool, seed: int) -> None:
    """Seeded random values in every slot of an engine's pool (the int8
    pool's scales on the f16 grid), so that a stray write shows. The
    engine writes a position's K|V before anything attends to it."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    for t in pool_parts(pool):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, device="cuda", dtype=torch.int8))
        elif isinstance(pool, tuple):
            t.uniform_(0.004, 0.016, generator=g)
            t.copy_(t.half().float())
        else:
            t.normal_(generator=g)


class GraphWatch:
    """Watches an engine's decode-step programs (``runner.programs``: one
    CUDA graph per key) through a run. It counts captures and replays by
    key and runs every replay (the staging copy and ``graph.replay``)
    under ``torch.cuda.set_sync_debug_mode("error")``. At the first replay
    it runs the key's body eagerly on the same inputs, from a copy of the
    pool taken before, puts the pool back, replays, and holds the replay to
    the eager run: tokens, logprobs and pool bytes (the ring pool's too)
    equal. ``quiet`` is true
    while a program is prepared or compared: the forwards run then are not
    the engine's steps."""

    def __init__(self, runner) -> None:
        self.runner, self.progs = runner, runner.programs
        self.captured: dict = {}
        self.replays: dict = {}
        self.quiet = False
        self.compared: dict | None = None
        self._prepare, self._replay = self.progs.prepare, self.progs.replay
        self.progs.prepare, self.progs.replay = self.prepare, self.replay

    def prepare(self, key):
        self.quiet = True
        try:
            new = self._prepare(key)
        finally:
            self.quiet = False
        if new:
            self.captured[key] = self.captured.get(key, 0) + 1
        return new

    def replay(self, key, arrays):
        from llmd_tpu_torch import ops

        pools = runner_pools(self.runner)
        check = self.compared is None
        if check:
            saved, state = [clone_pool(p) for p in pools], ops.launch_state()
            self.quiet = True
            try:
                want = self.progs.eager(key, arrays).clone()
            finally:
                self.quiet = False
            want_pools = [clone_pool(p) for p in pools]
            ops.set_launch_state(state)
            for pool, copy in zip(pools, saved):
                for t, src in zip(pool_parts(pool), pool_parts(copy)):
                    t.copy_(src)
            del saved
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = self._replay(key, arrays)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        self.replays[key] = self.replays.get(key, 0) + 1
        if check:
            torch.cuda.synchronize()
            self.compared = {"key": list(key), "tokens_and_logprobs_equal": torch.equal(out, want),
                             "pool_bytes_equal": all(pools_equal(a, b) for a, b in zip(pools, want_pools)),
                             "pools": len(pools)}
            del want_pools
            if not (self.compared["tokens_and_logprobs_equal"] and self.compared["pool_bytes_equal"]):
                raise AssertionError(f"a graph replay differs from its eager body: {self.compared}")
        return out

    def forwards(self, flat: str = "flat", q1: str = "q1") -> list:
        """The forwards the replays ran: K one-token forwards a decode
        window, one flat forward a flat step."""
        out = []
        for key, n in self.replays.items():
            out += ([q1] * key[2] if key[0] == "window" else [flat]) * n
        return out

    def summary(self) -> dict:
        return {"captured": {str(k): n for k, n in self.captured.items()},
                "replays": {str(k): n for k, n in self.replays.items()},
                "replay_vs_eager": self.compared}


def check_overlap(eng) -> dict:
    """Under async stepping the host schedules and stages step N+1 and
    assembles step N's outputs while the device runs: run those calls
    (``scheduler.schedule``, the runner's ``stage_unified`` and
    ``stage_decode``, the engine's ``_assemble_outputs`` and
    ``_finish_step``) under ``torch.cuda.set_sync_debug_mode("error")``,
    so that a hidden device sync there (a read of a device value, a
    blocking copy) fails the run. Returns the calls by name, counted as
    they run."""
    calls: dict[str, int] = {}

    def checked(owner, name):
        fn = getattr(owner, name)

        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        setattr(owner, name, call)

    checked(eng.scheduler, "schedule")
    checked(eng.runner, "stage_unified")
    checked(eng.runner, "stage_decode")
    checked(eng, "_assemble_outputs")
    checked(eng, "_finish_step")
    return calls


def check_async_end(info: dict, eng, calls: dict) -> None:
    """An async engine's end state: nothing in flight, every main-pool
    page back, staged rows rolled back (every request ended on
    ``max_tokens``, so each rolled back the row its next step had staged),
    and the overlapped calls run under the sync check."""
    info.update(async_rollbacks=eng.stats.async_rollbacks_total,
                overlap_calls_sync_checked=dict(calls), pool_usage_end=eng.allocator.usage(),
                step_host_gap_ms_mean=eng.stats.step_host_gap_ms_total / eng.stats.engine_steps_total)
    if eng.has_work() or eng.allocator.usage() != 0.0 or eng.scheduler.protected:
        raise AssertionError(f"the async engine ended with work or pages: usage "
                             f"{eng.allocator.usage()}, protected {eng.scheduler.protected}")
    if eng.stats.async_rollbacks_total <= 0:
        raise AssertionError("no staged row was rolled back although every request hit max_tokens")
    if not (calls.get("schedule") and calls.get("_assemble_outputs")):
        raise AssertionError(f"the overlapped calls did not run: {calls}")


def compare_sync_async(info: dict, got: list, want: list) -> None:
    """An async phase's greedy streams beside the same phase's sync
    streams: ``compare_greedy`` (gated), and whether they are equal."""
    info["tokens_equal_sync"] = got == want
    compare_greedy(info, got, want, gate=True)


def warm_engine(eng, info: dict, watch: GraphWatch, seed: int) -> None:
    """``eng.warmup()`` on a pool of seeded random values: the pool must
    keep every byte. Records the graphs it captured, its seconds, the
    device's free memory after it, and the device memory it kept (the graph
    pool and static inputs), measured
    after the engines of earlier phases, which their runners and programs
    keep in reference cycles, are collected."""
    pools = runner_pools(eng.runner)
    for i, pool in enumerate(pools):
        randomize_pool(pool, seed + i)
    before = [clone_pool(p) for p in pools]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    n = eng.warmup()
    torch.cuda.synchronize()
    info.update(warmup_graphs=n, warmup_s=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    info["warmup_kept_bytes"] = torch.cuda.memory_reserved() - reserved
    unchanged = all(pools_equal(a, b) for a, b in zip(pools, before))
    del before
    # Free to the next allocation: the CUDA runtime's free memory and the
    # allocator's cached, unallocated blocks (left cached, as they were).
    info["device_free_gb_after_warmup"] = (
        torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved() - torch.cuda.memory_allocated()) / 1e9
    if n != len(eng.runner.warm_keys()) or set(watch.captured) != set(eng.runner.warm_keys()):
        raise AssertionError(f"warmup captured {watch.captured}, want {eng.runner.warm_keys()}")
    if not unchanged:
        raise AssertionError("warmup changed the KV pool")


def check_replay_launches(runner, cfg, int8: bool) -> None:
    """Each captured program's launches per replay (``Program.launches``):
    every kernel branch once a layer a forward (K iterations of a window,
    one flat forward), K6' twice a MoE layer a forward, and under int8
    weights the int8 kernels as ``q8_launches`` counts them."""
    L = cfg.num_layers
    n_moe = L - cfg.first_dense_layers if cfg.is_moe else 0
    for key, prog in runner.programs.programs.items():
        flat, q1 = (1, 0) if key[0] == "flat" else (0, key[2])
        branches = {f"{fn.__name__}[{b}]": n for fn, (_, br) in prog.launches.items()
                    for b, n in br.items() if n}
        totals = {fn.__name__: n for fn, (n, _) in prog.launches.items() if n}
        if cfg.is_mla:
            want_b = {"write_kv_pages_decode_full[latent]": L * q1}
            want = {"write_kv_pages_decode_full": L * q1, "mla_decode_paged_attention_full": L * q1}
        else:
            want_b = expected_branches(cfg, flat, q1, int8)
            want = {}
            for name, n in want_b.items():
                fn = name.split("[")[0]
                want[fn] = want.get(fn, 0) + n
        if n_moe and cfg.quantization is None:
            want.update(grouped_matmul_pair=n_moe * (flat + q1), grouped_matmul=n_moe * (flat + q1))
        want.update({k: n for k, n in q8_launches(cfg, flat + q1).items() if n})
        if branches != want_b or totals != want:
            raise AssertionError(f"graph {key}: {totals} {branches} a replay, want {want} {want_b}")


ENGINE_LAYOUTS = {
    "flat step": {},
    "split engine, decode_window 8": dict(unified_step=False, decode_window=8),
    "flat step, decode_window 8": dict(decode_window=8),
}


def expected_branches(cfg, flat_forwards: int, q1_forwards: int, int8: bool) -> dict:
    """Launches per kernel branch (``ops.branch_launch_counts``) of a GQA
    model's run: every flat forward launches the flat pair once a layer,
    every bucketed Q = 1 forward the decode pair; layer i's attention takes
    its window (``cfg.layer_windows``), the sinks and the int8 pool as the
    model has them; every write takes the fused form (rope, the q|k|v
    biases where the model has them, the int8 pool)."""
    from llmd_tpu_torch.ops import write_branch
    from llmd_tpu_torch.ops.ragged_paged_attention import branch_key

    want: dict[str, int] = {}

    def add(key: str, n: int) -> None:
        if n:
            want[key] = want.get(key, 0) + n

    for w in cfg.layer_windows:
        key = branch_key(w, True if cfg.attention_sinks else None, True if int8 else None)
        add(f"flat_paged_attention_full[{key}]", flat_forwards)
        add(f"decode_paged_attention_full[{key}]", q1_forwards)
        wkey = write_branch(int8, rope=True, bias=cfg.attention_bias and not cfg.qk_norm)
        add(f"write_kv_pages_flat_full[{wkey}]", flat_forwards)
        add(f"write_kv_pages_decode_full[{wkey}]", q1_forwards)
    return want


def engine_prompts(cfg) -> list[list[int]]:
    """The engine phases' 7 distinct prompts, 16-1,500 tokens. 1,500 >
    max_num_batched_tokens: that prompt prefills in chunks."""
    gen = torch.Generator().manual_seed(11)
    lengths = [16, 100, 300, 700, 1500, 64, 900]
    return [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist() for n in lengths]


def ring_prompts(cfg) -> list[list[int]]:
    """The SWA ring phases' prompts: ``engine_prompts`` and one of 8,192
    tokens, which wraps gpt-oss-20b's 73-page (1,168-token) ring 7 times."""
    gen = torch.Generator().manual_seed(12)
    return engine_prompts(cfg) + [torch.randint(3, cfg.vocab_size, (8192,), generator=gen).tolist()]


def engine_phase(info: dict, params: dict, model: str = MODEL, kv_dtype: str = "bfloat16",
                 prompts: list | None = None, swa_ring: bool = False,
                 num_blocks: int = 2048, quantization: str | None = None,
                 async_scheduling: bool = False) -> tuple[dict, dict, list, list]:
    """``LLMEngine`` at full width serving 8 greedy requests in the step
    layout ``info["layout"]`` names: on the flat step; as the split engine
    with fused decode windows of 8; or on the flat step with windows of 8
    (steps that hold a prefill run flat, pure-decode steps run as windows).
    Every forward is logged (flat, bucketed Q = 1, or a prefill group):
    the flat pair must launch once a layer a flat forward, the decode pair
    once a layer a Q = 1 forward, K6' twice a MoE layer a forward (the
    gate|up pair and the down call), each in the branches the layer takes
    (window, sinks, int8 pool). Every decode-only step (a decode window, or
    a flat step with no prefill) must be a CUDA graph replay
    (``GraphWatch``: staging and replays under ``torch.cuda.set_sync_debug_mode
    ("error")``, the first replay held to its eager body), whose forwards
    count from its key; each graph's launches a replay are checked per
    branch; ``warmup`` runs first and must leave the pool as it was.
    ``prompts`` replaces ``engine_prompts`` (the 8th request repeats the
    4th prompt either way); ``swa_ring`` puts the sliding layers in the
    ring pool (``CacheConfig.swa_ring``); ``num_blocks`` is the pool's
    pages; ``quantization="int8"`` runs int8 weights (``params`` their
    tree), whose products must launch the int8 kernels as ``q8_launches``
    counts them and K6''s bf16 calls never. ``async_scheduling`` runs the
    engine's two-slot pipeline: the overlapped calls under the sync check
    (``check_overlap``), and at the end nothing in flight, the pool empty
    and staged rows rolled back (``check_async_end``). Returns (launch
    counts, branch launch counts, the requests' tokens, their logprobs)."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from llmd_tpu_torch.engine import LLMEngine, SamplingParams
    from llmd_tpu_torch.engine import runner as runner_mod
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(model, **({"quantization": quantization} if quantization else {}))
    layout = ENGINE_LAYOUTS[info["layout"]]
    windowed = "decode_window" in layout
    config = EngineConfig(
        model=cfg,
        cache=CacheConfig(page_size=16, num_blocks=num_blocks, dtype=kv_dtype, swa_ring=swa_ring),
        scheduler=SchedulerConfig(max_num_seqs=64, max_num_batched_tokens=1024,
                                  async_scheduling=async_scheduling, **layout),
        seed=0,
    )
    eng = LLMEngine(config, params=params, device="cuda")
    info["pool_pages"] = num_blocks
    info["async_scheduling"] = async_scheduling
    if swa_ring != (eng.runner.kv_swa is not None):
        raise AssertionError(f"swa_ring={swa_ring}, but the runner's ring pool is {eng.runner.kv_swa}")
    watch = GraphWatch(eng.runner)
    warm_engine(eng, info, watch, seed=17)
    k_steps: list[int] = []  # iterations of each decode window dispatched
    forwards: list[str] = []  # "flat", "q1" or "prefill" for every eager forward
    decode_only_flat = [0]  # flat steps with no prefill
    dispatch = eng.runner.dispatch_staged_decode
    dispatch_flat = eng.runner.dispatch_staged_unified
    forward = runner_mod.llama.forward_hidden

    def logged_forward(p, kv_cache, inp, c, *swa):
        if not watch.quiet:
            forwards.append("flat" if inp.token_rows is not None else (
                "q1" if inp.token_ids.shape[1] == 1 else "prefill"))
        return forward(p, kv_cache, inp, c, *swa)

    def logged_dispatch(staged):
        k_steps.append(staged.k)
        return dispatch(staged)

    def logged_flat(staged):
        decode_only_flat[0] += not staged.prefills
        return dispatch_flat(staged)

    eng.runner.dispatch_staged_decode = logged_dispatch
    eng.runner.dispatch_staged_unified = logged_flat
    runner_mod.llama.forward_hidden = logged_forward
    overlap = check_overlap(eng) if async_scheduling else None
    prompts = prompts or engine_prompts(cfg)
    sp = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True, logprobs=True)
    ops.reset_launch_counts()
    tokens: dict[str, list[int]] = {}
    requests = {}
    ring_usage = []
    ttft: dict[str, float] = {}
    last: dict[str, float] = {}
    cached: dict[str, int] = {}
    t0 = time.perf_counter()
    # The 8th request repeats the 700-token prompt after the first wave has
    # committed its pages: its prefill starts from a prefix-cache hit.
    step_log: list[tuple[int, float]] = []  # (live tokens, host ms) per step
    window_ms: list[float] = []  # host ms per token of each pure decode-window step
    try:
        with counting_readbacks() as readbacks:
            for wave in (prompts, [prompts[3]]):
                tw = time.perf_counter()
                for p in wave:
                    rid = eng.add_request(p, sp)
                    tokens[rid] = []
                    requests[rid] = next(r for r in eng.scheduler.waiting if r.request_id == rid)
                while eng.has_work():
                    live0, ts = eng.runner.live_tokens_total, time.perf_counter()
                    windows0, dispatches0 = len(k_steps), eng.stats.step_dispatches_total
                    # step() ends in the step's one device->host copy, so the
                    # host clock spans the device work.
                    for out in eng.step():
                        tokens[out.request_id] += out.new_token_ids
                        ttft.setdefault(out.request_id, time.perf_counter() - tw)
                        last[out.request_id] = time.perf_counter() - tw
                        cached[out.request_id] = out.num_cached_tokens
                    ms = (time.perf_counter() - ts) * 1e3
                    step_log.append((eng.runner.live_tokens_total - live0, ms))
                    ring_usage.append(eng.stats.swa_ring_usage)
                    if len(k_steps) > windows0 and eng.stats.step_dispatches_total == dispatches0 + 1:
                        window_ms.append(ms / k_steps[-1])
        torch.cuda.synchronize()
    finally:
        runner_mod.llama.forward_hidden = forward
    wall = time.perf_counter() - t0
    st = eng.stats
    steps = st.engine_steps_total
    counts, branches = ops.launch_counts(), ops.branch_launch_counts()
    eager_forwards = {k: forwards.count(k) for k in ("flat", "q1", "prefill")}
    forwards += watch.forwards()
    rids = list(tokens)
    # Time per output token of a request: from its first token to its last.
    tpot = [(last[r] - ttft[r]) / (len(tokens[r]) - 1) for r in rids]
    info.update(
        model=model, kv_cache_dtype=kv_dtype, quantization=quantization,
        requests=len(rids), steps=steps, wall_s=wall,
        output_tok_per_s=sum(len(t) for t in tokens.values()) / wall,
        ttft_median_s=statistics.median(ttft.values()), ttft_max_s=max(ttft.values()),
        tpot_median_ms=statistics.median(tpot) * 1e3,
        prefix_cached_tokens=cached[rids[-1]], repeat_matches_first=tokens[rids[-1]] == tokens[rids[3]],
        step_dispatches=st.step_dispatches_total, decode_dispatches=st.decode_dispatches_total,
        unified_steps=st.unified_steps_total, readbacks=len(readbacks),
        forwards={k: forwards.count(k) for k in ("flat", "q1", "prefill")},
        eager_forwards=eager_forwards, graphs=watch.summary(),
        launches=counts, branch_launches=branches, kv_bytes=eng.runner.kv_bytes(),
    )
    if swa_ring:
        spec = eng.runner.swa
        info.update(swa_ring_pages=st.swa_ring_pages, ring_pages_per_seq=spec.ring_pages,
                    swa_ring_usage_max=max(ring_usage), swa_section_hits=st.swa_section_hits,
                    swa_section_captures=st.swa_section_captures,
                    pool_planes=[len(spec.full_layers), len(spec.swa_layers)])
    # Every decode-only step was one graph replay: each decode window, and
    # each flat step that held no prefill.
    window_replays = sum(n for key, n in watch.replays.items() if key[0] == "window")
    flat_replays = sum(n for key, n in watch.replays.items() if key[0] == "flat")
    if window_replays != len(k_steps) or flat_replays != decode_only_flat[0]:
        raise AssertionError(f"{window_replays} window replays for {len(k_steps)} windows, "
                             f"{flat_replays} flat replays for {decode_only_flat[0]} decode-only flat steps")
    if eager_forwards["q1"] or watch.compared is None:
        raise AssertionError(f"{eager_forwards['q1']} decode forwards ran outside a graph, "
                             "or no replay was held to its eager body")
    check_replay_launches(eng.runner, cfg, kv_dtype == "int8")
    if any(len(t) != 32 for t in tokens.values()):
        raise AssertionError(f"not every request produced 32 tokens: {[len(t) for t in tokens.values()]}")
    if cached[rids[-1]] <= 0:
        raise AssertionError("the repeated prompt did not hit the prefix cache")
    if len(readbacks) != steps:
        raise AssertionError(f"{len(readbacks)} device->host copies in {steps} steps")
    L = cfg.num_layers
    n_moe = L - cfg.first_dense_layers if cfg.is_moe else 0
    flat_fw, q1_fw = forwards.count("flat"), forwards.count("q1")
    # The flat pair runs once a layer in every flat step, the decode pair
    # once a layer in every iteration of every decode window.
    flat_steps = st.unified_steps_total if eng.runner.flat else 0
    if flat_fw != flat_steps or q1_fw != sum(k_steps):
        raise AssertionError(f"{flat_fw} flat forwards in {flat_steps} flat steps, "
                             f"{q1_fw} Q = 1 forwards in windows of {sum(k_steps)} iterations")
    n_moe16 = 0 if quantization else n_moe
    want = {"write_kv_pages_flat_full": L * flat_fw,
            "flat_paged_attention_full": L * flat_fw,
            "write_kv_pages_decode_full": L * q1_fw,
            "decode_paged_attention_full": L * q1_fw,
            "mla_decode_paged_attention_full": 0,
            "grouped_matmul_pair": n_moe16 * len(forwards),
            "grouped_matmul": n_moe16 * len(forwards),
            **q8_launches(cfg, len(forwards))}
    if windowed:
        info.update(decode_windows=len(k_steps), window_iterations=sum(k_steps),
                    windows_of_8=k_steps.count(8),
                    decode_ms_per_token_median=statistics.median(window_ms))
        if 8 not in k_steps:
            raise AssertionError(f"no decode window ran 8 iterations: {k_steps}")
        if eng.runner.flat:
            # Every step is one flat program or one decode window.
            if flat_steps == 0 or flat_steps + len(k_steps) != steps:
                raise AssertionError(f"{flat_steps} flat steps + {len(k_steps)} windows in {steps} steps")
        elif len(k_steps) != st.decode_dispatches_total:
            raise AssertionError(f"{len(k_steps)} windows, {st.decode_dispatches_total} decode dispatches")
    else:
        decode_ms = [ms for n, ms in step_log if n <= len(prompts)]
        info.update(
            decode_steps=len(decode_ms), decode_step_ms_median=statistics.median(decode_ms),
            prefill_steps=[[n, ms] for n, ms in step_log if n > len(prompts)],
        )
        if flat_steps != steps or k_steps:
            raise AssertionError(f"{flat_steps} flat steps, {len(k_steps)} windows in {steps} steps")
    if counts != want:
        raise AssertionError(f"launch counts {counts}, want {want}")
    want_b = expected_branches(cfg, flat_fw, q1_fw, kv_dtype == "int8")
    if branches != want_b:
        raise AssertionError(f"branch launch counts {branches}, want {want_b}")
    if async_scheduling:
        check_async_end(info, eng, overlap)
    del eng, watch
    return counts, branches, [tokens[r] for r in rids], [requests[r].output_logprobs for r in rids]


# The speculative phases' runs: (label, scheduler options); the first runs
# without speculative decoding and is the others' reference.
SPEC_RUNS = {
    MODEL: [("off", {}), ("spec", dict(speculative_ngram=True)),
            ("spec async", dict(speculative_ngram=True, async_scheduling=True)),
            ("spec, decode_window 4", dict(speculative_ngram=True, decode_window=4)),
            ("spec async, decode_window 4",
             dict(speculative_ngram=True, decode_window=4, async_scheduling=True))],
    "deepseek-v2-lite": [("off", {}), ("spec", dict(speculative_ngram=True)),
                         ("spec async", dict(speculative_ngram=True, async_scheduling=True)),
                         ("spec, split engine", dict(speculative_ngram=True, unified_step=False))],
    "gpt-oss-20b": [("off", {}), ("spec", dict(speculative_ngram=True)),
                    ("spec, decode_window 4", dict(speculative_ngram=True, decode_window=4))],
}


def spec_prompts(cfg) -> list[list[int]]:
    """8 prompts, each a random block of 16 tokens repeated 8 times (128
    tokens), so that the n-gram proposer drafts from the first step."""
    gen = torch.Generator().manual_seed(21)
    return [torch.randint(3, cfg.vocab_size, (16,), generator=gen).tolist() * 8 for _ in range(8)]


def spec_engine_run(info: dict, params: dict, cfg, sched: dict, swa_ring: bool = False,
                    need_accepted: bool = True) -> tuple[list, list, dict]:
    """``LLMEngine`` of the model ``cfg`` on ``spec_prompts``, 48 greedy
    tokens a request, with the scheduler options ``sched``. Warmup first (the pool
    unchanged); every verify step, fused verify window, decode window and
    decode-only flat step a CUDA graph replay (``GraphWatch``: staging and
    replay under ``set_sync_debug_mode("error")``, the first replay held
    to its eager body), one replay a dispatch of its kind; one device->host
    copy a step (a fused verify window is one step); the pool empty at the
    end; drafts accepted (or, without ``need_accepted``, proposed).
    Returns (tokens, their logprobs, launch counts)."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from llmd_tpu_torch.engine import LLMEngine, SamplingParams

    eng = LLMEngine(EngineConfig(
        model=cfg, cache=CacheConfig(page_size=16, num_blocks=1024, dtype=cfg.dtype, swa_ring=swa_ring),
        scheduler=SchedulerConfig(max_num_seqs=64, max_num_batched_tokens=1024, **sched), seed=0,
    ), params=params, device="cuda")
    runner = eng.runner
    watch = GraphWatch(runner)
    warm_engine(eng, info, watch, seed=17)
    dispatched: dict[str, int] = {}

    def counted(kind: str, fn, decode_only=lambda staged: True):
        def call(staged):
            if decode_only(staged):
                dispatched[kind] = dispatched.get(kind, 0) + 1
            return fn(staged)
        return call

    runner.dispatch_staged_verify = counted("verify", runner.dispatch_staged_verify)
    runner.dispatch_staged_verify_window = counted("vwindow", runner.dispatch_staged_verify_window)
    runner.dispatch_staged_decode = counted("window", runner.dispatch_staged_decode)
    if runner.flat:
        runner.dispatch_staged_unified = counted("flat", runner.dispatch_staged_unified,
                                                 lambda staged: not staged.prefills)
    prompts = spec_prompts(cfg)
    sp = SamplingParams(temperature=0.0, max_tokens=48, ignore_eos=True, logprobs=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with counting_readbacks() as readbacks:
        rids = [eng.add_request(p, sp) for p in prompts]
        requests = [next(r for r in eng.scheduler.waiting if r.request_id == rid) for rid in rids]
        while eng.has_work():
            eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = [r.output_token_ids for r in requests]
    logprobs = [r.output_logprobs for r in requests]
    st, sch = eng.stats, eng.scheduler
    replays: dict[str, int] = {}
    for key, n in watch.replays.items():
        replays[key[0]] = replays.get(key[0], 0) + n
    counts = ops.launch_counts()
    info.update(
        model=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype, quantization=cfg.quantization,
        kv_swa_ring=swa_ring, scheduler=sched,
        steps=st.engine_steps_total, wall_s=wall,
        output_tok_per_s=sum(map(len, tokens)) / wall, readbacks=len(readbacks),
        step_dispatches=st.step_dispatches_total, decode_dispatches=st.decode_dispatches_total,
        dispatches_per_emitted_token=st.dispatches_per_emitted_token,
        spec_proposed=st.spec_proposed_tokens_total, spec_accepted=st.spec_accepted_tokens_total,
        spec_accepted_len_hist=list(st.spec_accepted_len_hist),
        spec_window_iters=st.spec_window_iters_total, spec_row_depth_hist=list(st.spec_row_depth_hist),
        async_rollbacks=st.async_rollbacks_total, dispatched=dispatched, replays_by_kind=replays,
        graphs=watch.summary(), launches=counts, kv_bytes=runner.kv_bytes(),
        pool_usage_end=eng.allocator.usage(),
    )
    if swa_ring:
        spec = runner.swa
        info.update(ring_pages_per_seq=spec.ring_pages, ring_chunk_tokens=spec.chunk_tokens,
                    swa_ring_pages=st.swa_ring_pages)
    if eng.has_work() or eng.allocator.usage() != 0.0:
        raise AssertionError(f"the engine ended with work or pages: {eng.allocator.usage()}")
    if len(readbacks) != st.engine_steps_total:
        raise AssertionError(f"{len(readbacks)} device->host copies in {st.engine_steps_total} steps")
    if replays != dispatched or watch.compared is None:
        raise AssertionError(f"graph replays {replays} for the decode-only dispatches {dispatched}, "
                             "or no replay was held to its eager body")
    if any(len(t) != 48 for t in tokens):
        raise AssertionError(f"not every request produced 48 tokens: {list(map(len, tokens))}")
    if not all(0 <= t < cfg.vocab_size for row in tokens for t in row) or not all(
            math.isfinite(x) and x < 0 for row in logprobs for x in row):
        raise AssertionError("a token outside the vocabulary, or a logprob that is not a finite "
                             "negative number")
    if sched.get("speculative_ngram"):
        if st.spec_accepted_tokens_total <= 0 and (need_accepted
                                                   or st.spec_proposed_tokens_total <= 0):
            raise AssertionError(f"no draft token was accepted: {st.spec_proposed_tokens_total} proposed")
        if sched.get("decode_window", 1) > 1 and (st.spec_window_iters_total <= 0
                                                  or not dispatched.get("vwindow")):
            raise AssertionError(f"no fused verify window ran: {dispatched}")
    del eng, watch, runner
    return tokens, logprobs, counts


# Two greedy bf16 runs of one model whose steps batch the same positions
# differently round them differently (K1' cuts a row's pages into as many
# spans as the step's size gives; a verify row's positions are scored
# together, a decode row's one at a time), so a stream may part from
# another at a near-tie. Every emitted token is therefore held to the
# model itself: ``spec_rescore`` feeds each stream back in one
# teacher-forced prefill and takes, at every output position, the gap
# between the top logprob there and the emitted token's. A sound run's
# tokens are the top, or tied with it up to rounding: in this script's
# runs on an H100 80GB HBM3 two runs' chosen-token logprobs differed by at
# most 0.37 where a rounding flips an int8 activation or an expert choice
# (deepseek-v2-lite, gpt-oss-20b). A token from a wrong context is not
# the top of the right one (the ``shifted`` witness: the next emitted
# token scored at this position). gpt-oss-20b's bf16 runs are the
# exception: random router weights leave experts nearly tied, so the
# teacher-forced prefill picks other experts than the engine's steps at
# some positions and the run without speculative decoding itself shows
# gaps near 2 nats (on an H100 80GB HBM3), about a wrong token's. Where
# the run without it exceeds the tolerance, a speculative run may exceed
# it at no more than ``SPEC_ABOVE_TOL_FACTOR`` times its share of
# positions (a wrong context exceeds it at most positions), and the
# model's f32 cut holds it token for token (``spec_exact_phase``). In f32
# the runs are equal token for token.
SPEC_TOP_GAP_TOL = 0.5
SPEC_ABOVE_TOL_FACTOR = 2.0


def spec_rescore(params: dict, cfg, prompts: list, streams: list) -> dict:
    """Each greedy stream held to the model, token by token: prompt + the
    stream but its last token in one teacher-forced prefill on a fresh
    pool (the bucketed ``[B, Q]`` layout: plain attention and writes, the
    products as the engines run them; a sliding layer attends within its
    window without the ring), and at every output position the gap of
    the emitted token's logprob below the top logprob there. ``shifted``
    is the same gap for the token emitted one position later: what a
    verify step that read its context one slot off would emit."""
    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.common import StepInput

    dev, page = torch.device("cuda"), 16
    seqs = [list(p) + list(s[:-1]) for p, s in zip(prompts, streams)]
    B, Q, P, N = len(seqs), len(seqs[0]), len(prompts[0]), len(streams[0])
    if any(len(q) != Q for q in seqs) or any(len(p) != P for p in prompts):
        raise AssertionError("spec_rescore takes prompts and streams of one length each")
    n_pages = -(-Q // page)
    table = 1 + torch.arange(B * n_pages, dtype=torch.int32, device=dev).reshape(B, n_pages)
    pool = torch.zeros((cfg.num_layers, B * n_pages + 1, cfg.kv_cache_heads, page,
                        cfg.kv_cache_entry_dim), dtype=getattr(torch, cfg.dtype), device=dev)
    inp = StepInput(
        token_ids=torch.tensor(seqs, device=dev),
        positions=torch.arange(Q, dtype=torch.int32, device=dev).expand(B, Q).contiguous(),
        kv_lens=torch.full((B,), Q, dtype=torch.int32, device=dev), page_table=table,
        query_lens=torch.full((B,), Q, dtype=torch.int32, device=dev), live_pages=n_pages,
    )
    with torch.inference_mode():
        h, _ = llama.forward_hidden(params, pool, inp, cfg)
        h = h[:, P - 1 : P - 1 + N].reshape(B * N, -1)
        logp = torch.log_softmax(llama.compute_logits(params, h, cfg).float(), dim=-1)
        emitted = torch.tensor(streams, device=dev).reshape(B * N, 1)
        top = logp.max(dim=-1).values
        gap = (top - logp.gather(1, emitted)[:, 0]).reshape(B, N)
        nxt = torch.tensor([s[1:] + s[-1:] for s in streams], device=dev).reshape(B * N, 1)
        shifted = (top - logp.gather(1, nxt)[:, 0]).reshape(B, N)[:, :-1]
    del pool, h, logp
    return {"top_gap_max": gap.max().item(), "top_gap_per_request": gap.amax(1).tolist(),
            "positions_above_tol": int((gap > SPEC_TOP_GAP_TOL).sum()),
            "positions": B * N, "shifted_gap_median": shifted.median().item(),
            "shifted_share_above_tol": (shifted > SPEC_TOP_GAP_TOL).float().mean().item()}


def spec_agreement(tokens: list, logprobs: list, ref: list, ref_logprobs: list) -> dict:
    """A speculative run's greedy streams beside the run without it, request
    by request: the leading tokens they agree on; over those, the largest
    difference of the chosen tokens' logprobs (the two runs computed the
    same distributions up to rounding); where they part, the two chosen
    tokens' logprobs (each the top logprob of its run: equal up to rounding
    where the two tokens were tied)."""
    lead, prefix_diff, part = [], 0.0, []
    for t, lp, rt, rlp in zip(tokens, logprobs, ref, ref_logprobs):
        n = next((i for i, (a, b) in enumerate(zip(t, rt)) if a != b), min(len(t), len(rt)))
        lead.append(n)
        if n:
            prefix_diff = max(prefix_diff, max(abs(a - b) for a, b in zip(lp[:n], rlp[:n])))
        if n < len(rt):
            part.append({"index": n, "tokens": [t[n], rt[n]], "logprobs": [lp[n], rlp[n]]})
    return {"tokens_equal_off": tokens == ref, "agreeing_leading_tokens": lead,
            "agreeing_share": sum(lead) / sum(map(len, ref)),
            "prefix_max_logprob_diff": prefix_diff, "parting": part,
            "parting_max_logprob_diff": max((abs(p["logprobs"][0] - p["logprobs"][1])
                                             for p in part), default=0.0)}


def spec_phase(params: dict, model: str, quantization: str | None = None,
               swa_ring: bool = False, cfg=None, need_accepted: bool = True) -> dict:
    """Every run of ``SPEC_RUNS[model]`` as a phase of its own
    (``spec_engine_run``), each speculative run beside the run without
    speculative decoding (``spec_agreement``), and every run's every
    emitted token held to the model (``spec_rescore``): within
    ``SPEC_TOP_GAP_TOL`` of the top logprob at its position, or, where
    the run without speculative decoding is not, beyond it at no more than
    ``SPEC_ABOVE_TOL_FACTOR`` times that run's share of positions. ``cfg``
    replaces the registry's model (an f32 cut: ``spec_exact_phase``); an
    f32 run's streams must also equal the reference's token for token.
    Returns the launch counts by run label."""
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = cfg or get_model_config(model, **({"quantization": quantization} if quantization else {}))
    exact = cfg.dtype == "float32"
    runs = {}
    ref = None
    for label, sched in SPEC_RUNS[model]:
        with phase("spec", {"model": model, "run": label, "exact": exact}) as info:
            tokens, logprobs, runs[label] = spec_engine_run(info, params, cfg, sched, swa_ring,
                                                            need_accepted)
            rescore = spec_rescore(params, cfg, spec_prompts(cfg), tokens)
            info["rescore"] = rescore
            if ref is None:
                ref, ref_rescore = (tokens, logprobs), rescore
                if exact and rescore["top_gap_max"] > SPEC_TOP_GAP_TOL:
                    raise AssertionError(f"{label}: an f32 token is not the model's top: {rescore}")
                continue
            if ref_rescore["top_gap_max"] <= SPEC_TOP_GAP_TOL:
                if rescore["top_gap_max"] > SPEC_TOP_GAP_TOL:
                    raise AssertionError(f"{label}: an emitted token is not the model's top at "
                                         f"its position, beyond rounding: {rescore}")
            elif rescore["positions_above_tol"] > (SPEC_ABOVE_TOL_FACTOR
                                                   * ref_rescore["positions_above_tol"]):
                raise AssertionError(f"{label}: tokens beyond the top at more positions than "
                                     f"{SPEC_ABOVE_TOL_FACTOR}x the run without speculative "
                                     f"decoding: {rescore}, without: {ref_rescore}")
            agree = spec_agreement(tokens, logprobs, *ref)
            info.update(agree)
            if exact and tokens != ref[0]:
                raise AssertionError(f"{label}: the f32 streams part from the run without "
                                     f"speculative decoding: {agree}")
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def spec_exact_phase(model: str = MODEL, layers: int = 4, swa_ring: bool = False,
                     need_accepted: bool = True) -> None:
    """``spec_phase`` on ``model``'s widths cut to ``layers`` layers in f32
    (seeded random weights; gpt-oss-20b with its biases filled, in its
    ring): the flat step's speculative runs must give the greedy streams of
    the run without speculative decoding token for token (K1' and K2' take
    their f32 path, K6' its f32 branch, the dense products cuBLAS's f32
    GEMMs with TF32 off). Random gpt-oss weights at a cut depth seldom
    repeat themselves: their drafts are proposed and verified, and mostly
    rejected (``need_accepted=False``; 1 accepted of 8 and 0 of 9 at 6
    layers on an H100 80GB HBM3), so its acceptance is held at full depth
    in bf16."""
    import dataclasses

    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.registry import get_model_config

    base = get_model_config(model)
    cut = {"layer_types": base.layer_types[:layers]} if base.layer_types else {}
    cfg = dataclasses.replace(base, num_layers=layers, dtype="float32", **cut)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
                               fused=True)
    if model == OSS_MODEL:
        fill_biases(params, seed=3)
    spec_phase(params, model, swa_ring=swa_ring, cfg=cfg, need_accepted=need_accepted)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def spec_serve_check(info: dict, base: str) -> None:
    """The speculative server: a greedy completion of a repeated-block
    prompt, then ``llmd:spec_accepted_tokens_total`` > 0 on /metrics."""
    gen = torch.Generator().manual_seed(22)
    prompt = torch.randint(3, 32000, (16,), generator=gen).tolist() * 8
    status, raw = _post(base + "/v1/completions", {"prompt": prompt, "max_tokens": 48,
                                                    "temperature": 0.0, "ignore_eos": True})
    if status != 200:
        raise AssertionError(f"/v1/completions returned {status}")
    metrics, _ = _scrape(base)
    info.update({k: metrics.get(f"llmd:{k}") for k in (
        "spec_proposed_tokens_total", "spec_accepted_tokens_total", "spec_acceptance_rate")})
    if not metrics.get("llmd:spec_accepted_tokens_total"):
        raise AssertionError(f"llmd:spec_accepted_tokens_total is {info['spec_accepted_tokens_total']}")


def stats_update_cost(params: dict) -> dict:
    """Host µs a step that the engine's stats update costs
    (``LLMEngine._finish_step``: the step's counters, its host gap and the
    gauges) on llama-3-8b's flat step, 16 requests of 256 prompt and 64
    output tokens a run, four runs in turns: alone, with a /metrics scrape
    in flight (a thread rendering the page, ``render_metrics``, every
    millisecond: every step overlaps a scrape), alone, scraped. The update
    adds no device sync: one readback a step either way."""
    from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from llmd_tpu_torch.engine import LLMEngine, SamplingParams
    from llmd_tpu_torch.models.registry import get_model_config
    from llmd_tpu_torch.serve.metrics import render_metrics

    cfg = get_model_config(MODEL)
    eng = LLMEngine(EngineConfig(
        model=cfg, cache=CacheConfig(page_size=16, num_blocks=2048),
        scheduler=SchedulerConfig(max_num_seqs=64, max_num_batched_tokens=1024), seed=0,
    ), params=params, device="cuda")
    eng.warmup()
    eng.generate([[5] * 64], SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True))
    finish = eng._finish_step
    update_s: list[float] = []

    def timed_finish(host_gap_s):
        t = time.perf_counter()
        finish(host_gap_s)
        update_s.append(time.perf_counter() - t)

    eng._finish_step = timed_finish
    sp = SamplingParams(temperature=0.0, max_tokens=64, ignore_eos=True)
    gen = torch.Generator().manual_seed(21)
    runs = []
    for scraped in (False, True, False, True):
        prompts = torch.randint(3, cfg.vocab_size, (16, 256), generator=gen).tolist()
        update_s.clear()
        stop = threading.Event()
        render_s: list[float] = []

        def scrape():
            while not stop.is_set():
                t = time.perf_counter()
                render_metrics(eng.stats, MODEL)
                render_s.append(time.perf_counter() - t)
                time.sleep(0.001)

        scraper = threading.Thread(target=scrape) if scraped else None
        st = eng.stats
        steps0, gap0 = st.engine_steps_total, st.step_host_gap_ms_total
        if scraper:
            scraper.start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with counting_readbacks() as readbacks:
                eng.generate(prompts, sp)
            torch.cuda.synchronize()
        finally:
            stop.set()
            if scraper:
                scraper.join()
        wall = time.perf_counter() - t0
        steps = st.engine_steps_total - steps0
        if len(readbacks) != steps or len(update_s) != steps:
            raise AssertionError(f"{len(readbacks)} readbacks, {len(update_s)} stats updates "
                                 f"in {steps} steps")
        us = sorted(x * 1e6 for x in update_s)
        runs.append({
            "scrape_in_flight": scraped, "steps": steps, "wall_s": wall,
            "stats_update_us_median": statistics.median(us), "stats_update_us_mean": sum(us) / steps,
            "stats_update_us_p99": us[int(0.99 * (steps - 1))],
            "host_gap_ms_per_step": (st.step_host_gap_ms_total - gap0) / steps,
            "scrapes": len(render_s),
            "render_us_median": statistics.median(render_s) * 1e6 if render_s else None,
        })
    eng._finish_step = finish
    paused = pause_resume_replays(eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {"stats_update": runs, "pause_resume": paused}


def pause_resume_replays(eng) -> dict:
    """Through ``AsyncEngine`` on a warmed engine: a request paused after
    its first token takes no step, and stages, replays and captures
    nothing while paused; after resume its decode steps replay the graphs
    captured before (no new capture) and it ends with the tokens of an
    unpaused run (a 12-token prompt fills no page, so both runs prefill
    alike)."""
    import asyncio

    from llmd_tpu_torch.engine import SamplingParams
    from llmd_tpu_torch.serve.async_engine import AsyncEngine

    prompt = list(range(40, 52))
    sp = SamplingParams(temperature=0.0, max_tokens=48, ignore_eos=True)
    (want,) = eng.generate([prompt], sp).values()
    progs = eng.runner.programs

    def state():
        return eng.stats.engine_steps_total, set(progs.programs), sum(progs.runs.values())

    async def run():
        aeng = AsyncEngine(eng)
        aeng.start(asyncio.get_running_loop())
        try:
            stream = aeng.generate("paused", prompt, sp)
            tokens = list((await stream.__anext__()).new_token_ids)
            aeng.pause()
            await asyncio.sleep(0.05)
            while aeng._step_started is not None:  # a step under way ends
                await asyncio.sleep(0.001)
            before = state()
            await asyncio.sleep(0.5)
            held = state() == before
            aeng.resume()
            async for out in stream:
                tokens += out.new_token_ids
            return tokens, held, before, state()
        finally:
            aeng.stop()

    tokens, held, before, after = asyncio.run(run())
    info = {"held_while_paused": held, "programs": len(after[1]),
            "new_programs_after_resume": len(after[1] - before[1]),
            "replays_after_resume": after[2] - before[2], "tokens_equal_unpaused": tokens == want}
    if not held or after[1] != before[1] or after[2] <= before[2] or tokens != want:
        raise AssertionError(f"pause/resume: {info}")
    return info


def layouts_phase(info: dict) -> None:
    """The tiny f32 model on the card: every step layout gives the flat
    step's streams, greedy and seeded (temperature 0.8)."""
    from llmd_tpu_torch.config import (
        CacheConfig, EngineConfig, SchedulerConfig, tiny_model_config,
    )
    from llmd_tpu_torch.engine import LLMEngine, SamplingParams
    from llmd_tpu_torch.models import llama

    model = tiny_model_config(head_dim=64, num_layers=3)
    params = llama.init_params(model, torch.Generator(device="cuda").manual_seed(1), "cuda")
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, 256, (n,), generator=gen).tolist() for n in (5, 40, 17, 70)]
    samplings = {
        "greedy": SamplingParams(temperature=0.0, max_tokens=20, ignore_eos=True),
        "seeded": SamplingParams(temperature=0.8, max_tokens=20, ignore_eos=True, seed=7),
    }
    layouts = {
        "flat": {},
        "split_window": dict(unified_step=False, decode_window=8),
        "flat_window": dict(decode_window=8),
        "bucketed": dict(ragged_qlens=False),
    }
    streams = {}
    for name, layout in layouts.items():
        config = EngineConfig(
            model=model,
            cache=CacheConfig(page_size=8, num_blocks=64, dtype="float32"),
            scheduler=SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=32, **layout),
        )
        eng = LLMEngine(config, params=params, device="cuda")
        streams[name] = {
            kind: list(eng.generate(prompts, sp).values()) for kind, sp in samplings.items()
        }
        info[name] = {"steps": eng.stats.engine_steps_total,
                      "unified_steps": eng.stats.unified_steps_total,
                      "decode_dispatches": eng.stats.decode_dispatches_total}
    for name in layouts:
        for kind in samplings:
            if streams[name][kind] != streams["flat"][kind]:
                raise AssertionError(f"{kind} streams of the {name} engine differ from the flat engine's")
    if streams["flat"]["greedy"] == streams["flat"]["seeded"]:
        raise AssertionError("the seeded noise never changed a token")
    info["streams_equal"] = True


# ---- HF checkpoints (the loader's path) -----------------------------------

CKPT_DIR = os.path.join(REPO, "build", "llama-3-8b-hf")
# The shard size transformers' save_pretrained writes.
SHARD_BYTES = 5 * 10**9
_ST_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}


def trees_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        trees_equal(a[k], b[k]) if isinstance(a[k], dict) else torch.equal(a[k], b[k]) for k in a)


def tree_nbytes(tree: dict) -> int:
    return sum(tree_nbytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
               for v in tree.values())


def unfused_leaf(cfg, layers: dict, name: str, i: int) -> torch.Tensor:
    """Layer i's leaf ``name`` of a dense tree, fused (``wqkv``, ``w_gu``)
    or not: a view of the fused leaf's columns where it is fused."""
    if name in layers:
        return layers[name][i]
    Nq, K, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cols = {"wq": ("wqkv", 0, Nq * D), "wk": ("wqkv", Nq * D, (Nq + K) * D),
            "wv": ("wqkv", (Nq + K) * D, (Nq + 2 * K) * D),
            "w_gate": ("w_gu", 0, cfg.intermediate_size),
            "w_up": ("w_gu", cfg.intermediate_size, 2 * cfg.intermediate_size)}
    fused, a, b = cols[name]
    return layers[fused][i][:, a:b]


def hf_entries(cfg, params: dict) -> list[tuple[str, str, int | None, bool]]:
    """(HF name, leaf, layer or None, transposed) of every tensor of a dense
    Llama-class checkpoint (HF stores projections [out, in])."""
    out = [("model.embed_tokens.weight", "embed", None, False)]
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", "input_norm", i, False),
                (p + "post_attention_layernorm.weight", "post_norm", i, False)]
        out += [(p + f"self_attn.{w}_proj.weight", f"w{w}", i, True) for w in "qkvo"]
        if cfg.attention_bias:
            out += [(p + f"self_attn.{w}_proj.bias", f"b{w}", i, False) for w in "qkv"]
        if cfg.qk_norm:
            out += [(p + f"self_attn.{w}_norm.weight", f"attn_{w}_norm", i, False) for w in "qk"]
        out += [(p + f"mlp.{w}_proj.weight", f"w_{w}", i, True) for w in ("gate", "up", "down")]
    out.append(("model.norm.weight", "final_norm", None, False))
    if not cfg.tie_word_embeddings:
        out.append(("lm_head.weight", "lm_head", None, True))
    return out


def hf_tensor(cfg, params: dict, entry) -> torch.Tensor:
    """An entry's tensor as the checkpoint stores it (a view)."""
    _, leaf, i, transposed = entry
    w = params[leaf] if i is None else unfused_leaf(cfg, params["layers"], leaf, i)
    return w.T if transposed else w


def write_safetensors(path: str, tensors: dict) -> int:
    """A safetensors file of ``tensors`` (name -> tensor or view, on any
    device, copied to the host one at a time): a little-endian u64 header
    length, the JSON header (dtype, shape, data offsets per tensor; padded
    to 8 bytes), the raw bytes. Returns the bytes written."""
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for t in tensors.values():
            f.write(t.contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    return 8 + len(raw) + offset


def write_hf_checkpoint(cfg, params: dict, out_dir: str) -> dict:
    """Write a dense model's tree (fused or not) as an HF directory:
    ``config.json`` for the architecture the config names (Qwen3 for QK
    norm, Qwen2 for q|k|v biases, else Llama), safetensors shards of at
    most ``SHARD_BYTES`` in transformers' names (``write_safetensors``),
    and their index. Returns the shard count and the bytes written."""
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    entries = hf_entries(cfg, params)
    shards, size = [[]], 0
    for e in entries:
        t = hf_tensor(cfg, params, e)
        n = t.numel() * t.element_size()
        if shards[-1] and size + n > SHARD_BYTES:
            shards.append([])
            size = 0
        shards[-1].append(e)
        size += n
    weight_map, total = {}, 0
    for k, shard in enumerate(shards):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        total += write_safetensors(os.path.join(out_dir, fname),
                                   {e[0]: hf_tensor(cfg, params, e) for e in shard})
        weight_map.update((e[0], fname) for e in shard)
    arch = ("Qwen3ForCausalLM" if cfg.qk_norm else
            "Qwen2ForCausalLM" if cfg.attention_bias else "LlamaForCausalLM")
    hf = {"architectures": [arch], "vocab_size": cfg.vocab_size,
          "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
          "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
          "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
          "rope_theta": cfg.rope_theta, "rope_scaling": cfg.rope_scaling,
          "rms_norm_eps": cfg.rms_norm_eps, "max_position_embeddings": cfg.max_model_len,
          "tie_word_embeddings": cfg.tie_word_embeddings,
          "attention_bias": cfg.attention_bias, "torch_dtype": cfg.dtype}
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf, f, indent=1)
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    return {"shards": len(shards), "file_bytes": total}


def host_rss(pid: int | str = "self") -> int:
    """A process's resident set (``VmRSS``; default this one's), in bytes."""
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise KeyError("VmRSS")


@contextlib.contextmanager
def peak_host_rss(info: dict, key: str):
    """The peak of ``host_rss`` while the block runs, sampled every 5 ms by
    a thread (the loader's copies release the GIL), as ``info[key]`` in GB."""
    peak, stop = [host_rss()], threading.Event()

    def sample():
        while not stop.wait(0.005):
            peak[0] = max(peak[0], host_rss())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join()
        info[key] = max(peak[0], host_rss()) / 1e9


def runner_init_memory(info: dict, config) -> dict:
    """Build a ``ModelRunner`` for ``config`` (its weights drawn from the
    seed or loaded from ``config.weights_path``) and report its peak device
    memory over what it keeps: the tree and the KV pool. Fused trees are
    built fused, so the peak may pass them by at most one layer's tensor
    (2 GB allowed). Returns the runner's tree."""
    from llmd_tpu_torch.engine.runner import ModelRunner

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    runner = ModelRunner(config, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    tree, pool = tree_nbytes(runner.params), runner.kv_bytes()
    info.update(runner_init_s=time.perf_counter() - t0, runner_tree_gb=tree / 1e9,
                pool_pages=config.cache.num_blocks, pool_gb=pool / 1e9,
                runner_init_peak_gb=peak / 1e9, runner_init_peak_over_tree_and_pool_gb=(peak - tree - pool) / 1e9)
    if peak - tree - pool > 2e9:
        raise AssertionError(f"runner init peaked {(peak - tree - pool) / 1e9:.2f} GB over its tree and pool")
    return runner.params


def checkpoint_phase(info: dict, params: dict) -> None:
    """llama-3-8b's seeded tree (the one the llama phases ran) written as
    an HF checkpoint under ``build/`` and loaded back with the port's
    ``load_params(..., device="cuda")``: ``config_from_hf`` gives the
    registry's config, and every leaf is bit-equal to the tree's. Reports
    the write and load seconds, the load's GB/s and the host's peak RSS
    during the load (``peak_host_rss``) and the load's peak device memory
    over the tree (one tensor's staging copy), then builds a runner from
    the directory (``EngineConfig.weights_path``: the fused load) and
    holds its tree to the tree bit for bit and its peak device memory to
    the tree and pool plus 2 GB."""
    from llmd_tpu_torch.config import CacheConfig, EngineConfig
    from llmd_tpu_torch.models.loader import config_from_hf, load_params
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(MODEL)
    tree = tree_nbytes(params)
    free = shutil.disk_usage(os.path.dirname(CKPT_DIR)).free
    info.update(model=MODEL, tree_gb=tree / 1e9, disk_free_gb=free / 1e9)
    if free < 1.1 * tree:
        raise AssertionError(f"{free / 1e9:.1f} GB free on disk for a {tree / 1e9:.1f} GB checkpoint")
    t0 = time.perf_counter()
    written = write_hf_checkpoint(cfg, params, CKPT_DIR)
    info.update(write_s=time.perf_counter() - t0, shards=written["shards"],
                file_gb=written["file_bytes"] / 1e9)
    hf_cfg = config_from_hf(CKPT_DIR)
    diff = [f for f in cfg.__dataclass_fields__ if f != "name"
            and getattr(hf_cfg, f) != getattr(cfg, f)]
    if diff:
        raise AssertionError(f"config_from_hf differs from the registry's config in {diff}")
    info["host_rss_before_gb"] = host_rss() / 1e9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with peak_host_rss(info, "host_rss_peak_gb"):
        loaded = load_params(hf_cfg, CKPT_DIR, device="cuda")
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    info.update(load_s=load_s, load_gb_per_s=written["file_bytes"] / load_s / 1e9,
                load_device_peak_over_tree_gb=(torch.cuda.max_memory_allocated() - base - tree) / 1e9)
    bad = [e[0] for e in hf_entries(cfg, params)
           if not torch.equal(hf_tensor(cfg, loaded, e), hf_tensor(cfg, params, e))]
    if bad or tree_nbytes(loaded) != tree:
        raise AssertionError(f"{len(bad)} loaded tensors differ from the written ones: {bad[:4]}")
    info["leaves_bit_equal"] = len(hf_entries(cfg, params))
    del loaded
    runner_params = runner_init_memory(info, EngineConfig(
        model=hf_cfg, cache=CacheConfig(page_size=16, num_blocks=2048), weights_path=CKPT_DIR))
    if not trees_equal(runner_params, params):
        raise AssertionError("the runner's tree loaded from the checkpoint differs from the tree")
    info["runner_tree_bit_equal"] = True


def _post(url: str, body: dict) -> tuple[int, bytes]:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read()


def _call(url: str, body: dict | None = None, method: str | None = None) -> tuple[int, bytes]:
    """One HTTP call; an error status is returned, not raised."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method or ("GET" if body is None else "POST"),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _scrape(base: str) -> tuple[dict, float]:
    """The server's /metrics page, parsed, and the scrape's ms."""
    from llmd_tpu_torch.serve.metrics import parse_prometheus

    t0 = time.perf_counter()
    status, raw = _call(base + "/metrics")
    ms = (time.perf_counter() - t0) * 1e3
    if status != 200:
        raise AssertionError(f"/metrics returned {status}")
    return parse_prometheus(raw.decode()), ms


def _stream_chat(base: str, body: dict) -> tuple[list[dict], float]:
    """A streamed chat completion's frames, and the ms from sending it to
    its first content chunk (the chat TTFT)."""
    req = urllib.request.Request(base + "/v1/chat/completions",
                                 data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    frames, ttft = [], None
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: {"):
                continue
            frame = json.loads(line[6:])
            if ttft is None and frame["choices"] and "content" in frame["choices"][0]["delta"]:
                ttft = (time.perf_counter() - t0) * 1e3
            frames.append(frame)
    return frames, ttft


def surface_phase(info: dict, base: str, prompt_600: list[int]) -> None:
    """The routes llm-d's router and operators drive, on the llama-3-8b
    server in its default layout (after ``serve_phase``'s requests):
    /metrics (waiting and running 0; scrape latency), a greedy chat
    completion unstreamed and streamed (equal text, one chunk a token;
    chat TTFT), the 600-token prompt again and /v1/cache/probe (37 cached
    full pages of 16), /metrics again (generation tokens risen by the
    tokens served, a prefix hit rate, steps), then /admin/pause, /ready
    503, a request submitted while paused finishing after /admin/resume,
    and /admin/drain."""
    scrapes = [_scrape(base) for _ in range(20)]
    m0 = scrapes[-1][0]
    lat = sorted(ms for _, ms in scrapes)
    info.update(scrape_ms_median=statistics.median(lat), scrape_ms_max=lat[-1],
                metric_series=len(m0))
    if m0["vllm:num_requests_waiting"] != 0 or m0["vllm:num_requests_running"] != 0:
        raise AssertionError(f"an idle server reports waiting {m0['vllm:num_requests_waiting']}, "
                             f"running {m0['vllm:num_requests_running']}")
    body = {"messages": [{"role": "system", "content": "Answer briefly."},
                         {"role": "user", "content": "What does a router read from a pod?"}],
            "max_tokens": 16, "temperature": 0.0, "ignore_eos": True}
    status, raw = _call(base + "/v1/chat/completions", body)
    reply = json.loads(raw)
    if status != 200 or reply["usage"]["completion_tokens"] != 16:
        raise AssertionError(f"chat completion: {status} {reply}")
    text = reply["choices"][0]["message"]["content"]
    served = 16
    ttfts = []
    for i in range(5):
        frames, ttft = _stream_chat(base, body)
        ttfts.append(ttft)
        served += 16
        deltas = [f["choices"][0]["delta"] for f in frames if f["choices"]]
        content = [d["content"] for d in deltas if "content" in d]
        if deltas[0] != {"role": "assistant"} or len(content) != 16:
            raise AssertionError(f"streamed chat: {len(content)} content chunks for 16 tokens")
        if "".join(content) != text:
            raise AssertionError("the streamed chat text differs from the unstreamed chat's")
        if frames[-1]["usage"]["completion_tokens"] != 16:
            raise AssertionError(f"streamed chat usage {frames[-1]['usage']}")
    info.update(chat_ttft_ms=ttfts, chat_ttft_ms_median=statistics.median(ttfts),
                chat_prompt_tokens=reply["usage"]["prompt_tokens"])
    status, raw = _call(base + "/v1/completions",
                        {"prompt": prompt_600, "max_tokens": 16, "temperature": 0.0, "ignore_eos": True})
    if status != 200:
        raise AssertionError(f"/v1/completions returned {status}")
    served += json.loads(raw)["usage"]["completion_tokens"]
    status, raw = _call(base + "/v1/cache/probe", {"prompt": prompt_600})
    probe = json.loads(raw)
    info["cache_probe"] = probe
    if status != 200 or probe != {"cached_full_pages": 37, "page_size": 16, "num_full_pages": 37}:
        raise AssertionError(f"/v1/cache/probe: {status} {probe}")
    m1, _ = _scrape(base)
    gen = m1["vllm:generation_tokens_total"] - m0["vllm:generation_tokens_total"]
    info.update(generation_tokens_served=gen, prefix_cache_hit_rate=m1["vllm:prefix_cache_hit_rate"],
                engine_steps_total=m1["vllm:engine_steps_total"],
                gpu_cache_usage_perc=m1["vllm:gpu_cache_usage_perc"],
                step_host_gap_ms_mean=m1["vllm:step_host_gap_ms_total"] / m1["vllm:engine_steps_total"])
    if gen != served or m1["vllm:prefix_cache_hit_rate"] <= 0 or m1["vllm:engine_steps_total"] <= 0:
        raise AssertionError(f"/metrics after serving {served} tokens: generation +{gen}, hit rate "
                             f"{m1['vllm:prefix_cache_hit_rate']}, steps {m1['vllm:engine_steps_total']}")
    if _call(base + "/admin/pause", {})[0] != 200:
        raise AssertionError("/admin/pause refused")
    status, raw = _call(base + "/ready")
    if status != 503 or not json.loads(raw)["paused"]:
        raise AssertionError(f"/ready while paused: {status} {raw!r}")
    result = {}
    paused_body = {"prompt": "Submitted while paused.", "max_tokens": 16, "temperature": 0.0,
                   "ignore_eos": True}
    worker = threading.Thread(target=lambda: result.update(
        reply=_call(base + "/v1/completions", paused_body)))
    worker.start()
    time.sleep(1.0)
    steps_paused = _scrape(base)[0]["vllm:engine_steps_total"]
    time.sleep(0.5)
    if not worker.is_alive() or _scrape(base)[0]["vllm:engine_steps_total"] != steps_paused:
        raise AssertionError("the paused server stepped or finished a request")
    t0 = time.perf_counter()
    if _call(base + "/admin/resume", {})[0] != 200:
        raise AssertionError("/admin/resume refused")
    worker.join(timeout=120)
    status, raw = result.get("reply", (None, b""))
    if status != 200 or json.loads(raw)["usage"]["completion_tokens"] != 16:
        raise AssertionError(f"the request submitted while paused: {status} {raw[:200]!r}")
    info["paused_request_s_after_resume"] = time.perf_counter() - t0
    status, raw = _call(base + "/admin/drain?timeout=30", {})
    if status != 200 or not json.loads(raw)["drained"]:
        raise AssertionError(f"/admin/drain: {status} {raw!r}")
    admin = json.loads(_call(base + "/admin/status")[1])
    info["admin_status"] = admin
    if _call(base + "/ready")[0] != 503 or admin != {"paused": False, "running": 0, "waiting": 0}:
        raise AssertionError(f"after drain: /admin/status {admin}")


# The router's side of failover, deadlines, tracing, the Responses API and
# Generate, played by this script against the first llama-3-8b server.

FAILOVER_CUTS = (1, 17, 63)
FAILOVER_SAMPLING = {"greedy": {"temperature": 0.0}, "seeded": {"temperature": 0.8, "seed": 7}}
FAILOVER_TOKENS = 64


def cut_request_id(name: str, k: int) -> str:
    """The request id the fault plan cuts after ``k`` frames; no id is a
    substring of another (a spec's ``match`` is a substring)."""
    return f"smoke-failover-{name}-cut{k:02d}"


def failover_fault_plan() -> str:
    """``LLMD_FAULT_PLAN`` of the first llama-3-8b server: one
    ``serve.stream.cut`` spec a cut stream, matching only its request id,
    so every other request runs uncut."""
    return json.dumps({"seed": 0, "faults": [
        {"site": "serve.stream.cut", "match": cut_request_id(name, k), "after": k - 1, "times": 1}
        for name in FAILOVER_SAMPLING for k in FAILOVER_CUTS]})


class OtlpSink:
    """A stdlib OTLP/HTTP collector on a thread: the spans POSTed to
    ``/v1/traces``, in arrival order."""

    def __init__(self) -> None:
        import http.server

        spans = self.spans = []
        lock = self.lock = threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                with lock:
                    for rs in body["resourceSpans"]:
                        for ss in rs["scopeSpans"]:
                            spans.extend(ss["spans"])
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def by_trace(self) -> dict:
        with self.lock:
            out = {}
            for s in self.spans:
                out.setdefault(s["traceId"], []).append(s)
            return out

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def _stream(base: str, path: str, body: dict, headers: dict | None = None) -> dict:
    """A streamed request read frame by frame, surviving a cut: its frames,
    whether it ended with [DONE], and the ms to its first token frame."""
    import http.client

    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    frames, done, first = [], False, None
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            for raw in r:
                line = raw.decode().strip()
                if line == "data: [DONE]":
                    done = True
                    break
                if line.startswith("data: {"):
                    frame = json.loads(line[6:])
                    if first is None and (frame.get("token_ids") or any(
                            c.get("delta", {}).get("content") or c.get("text")
                            for c in frame.get("choices") or [])):
                        first = (time.perf_counter() - t0) * 1e3
                    frames.append(frame)
    except (http.client.IncompleteRead, ConnectionError):
        pass  # the server severed the stream: what a dead replica does
    return {"frames": frames, "done": done, "first_ms": first}


def _chat_parts(frames: list) -> tuple[list[int], str, int, dict | None]:
    """A chat stream's annotated token ids, its text, its role preambles
    and its usage."""
    toks, text, roles, usage = [], "", 0, None
    for f in frames:
        toks += f.get("token_ids") or []
        for c in f.get("choices") or []:
            roles += c.get("delta") == {"role": "assistant"}
            text += c.get("delta", {}).get("content") or ""
        usage = f.get("usage") or usage
    return toks, text, roles, usage


def _fault_count(base: str, site: str) -> float:
    status, raw = _call(base + "/metrics")
    for line in raw.decode().splitlines():
        if line.startswith("llmd:faults_injected_total{") and f'site="{site}"' in line:
            return float(line.rsplit(None, 1)[1])
    return 0.0


class PrefillProbe:
    """llama-3-8b's next-token log-probabilities after a token sequence,
    from one flat prefill through the kernels, on the server's seed-0
    weights drawn again here at the first call."""

    def __init__(self) -> None:
        self.params = None

    def gap(self, ids: list[int], tokens: tuple[int, int]) -> dict:
        """The top-2 log-probability gap after ``ids``, and the
        log-probabilities of ``tokens`` (the uncut stream's next token and
        the resumed leg's)."""
        from llmd_tpu_torch.models import llama
        from llmd_tpu_torch.models.common import StepInput
        from llmd_tpu_torch.models.registry import get_model_config

        cfg = get_model_config(MODEL)
        dev, page = torch.device("cuda"), 16
        if self.params is None:
            self.params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                            "cuda", fused=True)
        s = mixed_step(cfg, page, -(-cfg.max_model_len // page), [(0, len(ids))], [],
                       torch.Generator().manual_seed(5), dev)
        tok = torch.zeros(s["T"], dtype=torch.long)
        tok[: len(ids)] = torch.tensor(ids)
        inp = StepInput(token_ids=tok[:, None].to(dev), positions=s["positions"][:, None],
                        kv_lens=s["kv_lens"], page_table=s["page_table"], token_rows=s["rows"],
                        num_live=s["num_live"])
        pool = torch.zeros((cfg.num_layers, s["num_pages"], cfg.num_kv_heads, page,
                            2 * cfg.head_dim), dtype=torch.bfloat16, device=dev)
        with torch.inference_mode():
            h, _ = llama.forward_hidden(self.params, pool, inp, cfg)
            last = h.reshape(-1, h.shape[-1])[len(ids) - 1:len(ids)]
            logp = torch.log_softmax(llama.compute_logits(self.params, last, cfg).float(), -1)[0]
        top2 = logp.topk(2)
        return {"top2_logprob_gap": float(top2.values[0] - top2.values[1]),
                "top2_tokens": top2.indices.tolist(),
                "logprob_uncut_token": float(logp[tokens[0]]),
                "logprob_resumed_token": float(logp[tokens[1]])}

    def close(self) -> None:
        self.params = None
        gc.collect()
        torch.cuda.empty_cache()


def leading_agreement(got: list[int], want: list[int]) -> int:
    n = 0
    while n < min(len(got), len(want)) and got[n] == want[n]:
        n += 1
    return n


def failover_phase(info: dict, base: str) -> None:
    """The router's failover on one server: a greedy and a seeded chat
    stream of 64 tokens after a prompt of about 600 tokens runs uncut, then
    is cut by the server's fault plan after k = 1, 17 and 63 frames and
    resumed with ``resume_token_ids`` (the cut leg's annotated tokens) and
    ``x-llmd-resume: 1``. Gates: the stitched stream has exactly 64 tokens,
    one role preamble and the two legs' text with nothing repeated; the
    resumed leg's usage counts the history; the cut leg ends without [DONE]
    after k frames; ``stream_resumes_total``, ``resume_replayed_tokens_total``
    and ``faults_injected_total{site="serve.stream.cut"}`` move by what was
    sent. Reported: the tokens agreeing with the uncut stream (no gate: a
    bf16 prefill of the history may part from the decode path at a
    near-tie; at the first disagreement, the top-2 gap of a prefill of the
    uncut history), and the resumed leg's TTFT with its prefix hit."""
    _call(base + "/admin/resume", {})  # the surface phase ended with a drain
    words = " ".join(f"w{i % 97}" for i in range(150))
    messages = [{"role": "user", "content": f"Carry on after a failover. {words}"}]
    prompt_ids = json.loads(_call(base + "/tokenize", {"messages": messages})[1])["tokens"]
    info["prompt_tokens"] = len(prompt_ids)
    m0, _ = _scrape(base)
    cuts0 = _fault_count(base, "serve.stream.cut")
    tokens_hdr = {"x-llmd-stream-tokens": "1"}
    runs, probe = {}, PrefillProbe()
    for name, sampling in FAILOVER_SAMPLING.items():
        body = {"messages": messages, "max_tokens": FAILOVER_TOKENS, "ignore_eos": True,
                "stream": True, **sampling}
        uncut = _stream(base, "/v1/chat/completions", body, tokens_hdr)
        want, want_text, roles, usage = _chat_parts(uncut["frames"])
        if not uncut["done"] or len(want) != FAILOVER_TOKENS or roles != 1:
            raise AssertionError(f"{name}: the uncut stream: {len(want)} tokens, {roles} preambles")
        legs = []
        for k in FAILOVER_CUTS:
            cut = _stream(base, "/v1/chat/completions", body,
                          {**tokens_hdr, "x-request-id": cut_request_id(name, k)})
            history, cut_text, cut_roles, _ = _chat_parts(cut["frames"])
            if cut["done"] or len(history) != k or cut_roles != 1:
                raise AssertionError(f"{name} cut {k}: {len(history)} tokens, done {cut['done']}")
            resumed = _stream(base, "/v1/chat/completions", {**body, "resume_token_ids": history},
                              {**tokens_hdr, "x-llmd-resume": "1",
                               "x-request-id": cut_request_id(name, k) + "-resume"})
            rest, rest_text, rest_roles, rusage = _chat_parts(resumed["frames"])
            stitched = history + rest
            if not resumed["done"] or rest_roles or len(stitched) != FAILOVER_TOKENS:
                raise AssertionError(f"{name} cut {k}: stitched {len(stitched)} tokens, "
                                     f"{rest_roles} preambles on the resume leg")
            if rusage["completion_tokens"] != FAILOVER_TOKENS or (
                    rusage["prompt_tokens"] != usage["prompt_tokens"]):
                raise AssertionError(f"{name} cut {k}: resumed usage {rusage}")
            lead = leading_agreement(stitched, want)
            leg = {"cut_after": k, "agreeing_leading_tokens": lead,
                   # The cut leg alone (no resume): the uncut request
                   # again, its prompt now a prefix hit.
                   "cut_leg_agreeing_tokens": leading_agreement(history, want),
                   "resume_ttft_ms": resumed["first_ms"],
                   "resume_prefix_hit_tokens": rusage.get("prompt_tokens_details", {}).get(
                       "cached_tokens", 0),
                   "text_equal_uncut": cut_text + rest_text == want_text}
            if lead < FAILOVER_TOKENS:
                leg["first_disagreement"] = {"at": lead, **probe.gap(
                    prompt_ids + want[:lead], (want[lead], stitched[lead]))}
            legs.append(leg)
        runs[name] = legs
    probe.close()
    info["runs"] = runs
    info["resume_ttft_ms"] = [leg["resume_ttft_ms"] for legs in runs.values() for leg in legs]
    m1, _ = _scrape(base)
    sent = len(FAILOVER_SAMPLING) * len(FAILOVER_CUTS)
    moved = {"stream_resumes_total": m1["llmd:stream_resumes_total"] - m0["llmd:stream_resumes_total"],
             "resume_replayed_tokens_total": m1["llmd:resume_replayed_tokens_total"]
             - m0["llmd:resume_replayed_tokens_total"],
             "faults_injected_total": _fault_count(base, "serve.stream.cut") - cuts0}
    info["metrics_moved"] = moved
    want_moved = {"stream_resumes_total": sent,
                  "resume_replayed_tokens_total": len(FAILOVER_SAMPLING) * sum(FAILOVER_CUTS),
                  "faults_injected_total": sent}
    if moved != want_moved:
        raise AssertionError(f"/metrics moved by {moved}, want {want_moved}")


def deadline_phase(info: dict, base: str) -> None:
    """``x-request-deadline-s: 0.05`` on a 512-token completion: 504
    ``timeout_error`` unstreamed, a terminal 504 frame streamed, and the
    engine request aborted (``/admin/drain`` within 5 s, where the 512
    tokens would take several seconds; the running gauge, which refreshes
    at a step, reads 0 after the next request). A deadline of 60 s answers
    200 with the text of the same request without one."""
    body = {"prompt": "A long answer, please.", "max_tokens": 512, "temperature": 0.0,
            "ignore_eos": True}
    hdr = {"x-request-deadline-s": "0.05"}
    req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **hdr})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    info["deadline_504_ms"] = (time.perf_counter() - t0) * 1e3
    err = json.loads(raw).get("error", {})
    if status != 504 or err.get("type") != "timeout_error" or err.get("code") != 504:
        raise AssertionError(f"a 0.05 s deadline: {status} {raw[:200]!r}")
    t0 = time.perf_counter()
    status, raw = _call(base + "/admin/drain?timeout=5", {})
    info["aborted_drain_ms"] = (time.perf_counter() - t0) * 1e3
    if status != 200 or not json.loads(raw)["drained"]:
        raise AssertionError("the deadlined request was not aborted: the engine did not drain")
    streamed = _stream(base, "/v1/completions", {**body, "stream": True}, hdr)
    frames = streamed["frames"]
    if not streamed["done"] or not frames or frames[-1].get("error", {}).get("code") != 504:
        raise AssertionError(f"a streamed 0.05 s deadline ended with {frames[-1:]}")
    info["streamed_frames_before_error"] = len(frames) - 1
    status, raw = _call(base + "/admin/drain?timeout=5", {})
    if status != 200 or not json.loads(raw)["drained"]:
        raise AssertionError("the streamed deadlined request was not aborted")
    _call(base + "/admin/resume", {})
    body["max_tokens"] = 64
    status, raw = _post(base + "/v1/completions", body)
    plain = json.loads(raw)["choices"][0]["text"]
    req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          "x-request-deadline-s": "60"})
    with urllib.request.urlopen(req, timeout=120) as r:
        status, ample = r.status, json.loads(r.read())
    if status != 200 or ample["choices"][0]["text"] != plain:
        raise AssertionError(f"a 60 s deadline: {status}, text equal {ample['choices'][0]['text'] == plain}")
    m, _ = _scrape(base)
    info["running_after"] = m["vllm:num_requests_running"]
    if m["vllm:num_requests_running"] != 0:
        raise AssertionError(f"running {m['vllm:num_requests_running']} after the deadlines")


def tracing_phase(info: dict, base: str, sink: OtlpSink) -> None:
    """The server runs with ``--otlp-traces-endpoint`` at ``sink`` and
    ``--trace-sample-ratio 1.0``. Eight completions with sampled
    ``traceparent``s each reach the sink as one ``engine.generate`` span
    with the caller's trace id and parent span id, whose token attributes
    equal the reply's usage; the same eight with flags ``00`` export
    nothing. Reports the median latency of each eight (no gate)."""
    import secrets

    def send(flags: str) -> tuple[list, list]:
        sent, ms = [], []
        for i in range(8):
            tid, pid = secrets.token_hex(16), secrets.token_hex(8)
            body = {"prompt": f"Trace request {i}.", "max_tokens": 16, "temperature": 0.0,
                    "ignore_eos": True, "stream": i % 2 == 1}
            req = urllib.request.Request(
                base + "/v1/completions", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json",
                         "traceparent": f"00-{tid}-{pid}-{flags}"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                raw = r.read().decode()
            ms.append((time.perf_counter() - t0) * 1e3)
            if body["stream"]:
                usage = [json.loads(ln[6:]) for ln in raw.splitlines()
                         if ln.startswith("data: {")][-1]["usage"]
            else:
                usage = json.loads(raw)["usage"]
            sent.append((tid, pid, usage))
        return sent, ms

    sampled, sampled_ms = send("01")
    unsampled, unsampled_ms = send("00")
    info.update(sampled_ms_median=statistics.median(sampled_ms),
                unsampled_ms_median=statistics.median(unsampled_ms),
                sampled_ms=sampled_ms, unsampled_ms=unsampled_ms)
    t0 = time.perf_counter()
    while True:
        traces = sink.by_trace()
        if all(tid in traces for tid, _, _ in sampled) or time.perf_counter() - t0 > 15:
            break
        time.sleep(0.2)
    time.sleep(2.5)  # one more flush interval (2 s) for spans that must not come
    traces = sink.by_trace()
    info["spans_received"] = sum(len(v) for v in traces.values())
    for tid, pid, usage in sampled:
        spans = traces.get(tid, [])
        if len(spans) != 1:
            raise AssertionError(f"trace {tid}: {len(spans)} spans at the sink")
        (span,) = spans
        attrs = {a["key"]: a["value"] for a in span["attributes"]}
        got = (span["name"], span.get("parentSpanId"),
               int(attrs["gen_ai.usage.prompt_tokens"]["intValue"]),
               int(attrs["gen_ai.usage.completion_tokens"]["intValue"]))
        if got != ("engine.generate", pid, usage["prompt_tokens"], usage["completion_tokens"]):
            raise AssertionError(f"trace {tid}: span {got}, usage {usage}")
    leaked = [tid for tid, _, _ in unsampled if tid in traces]
    if leaked:
        raise AssertionError(f"{len(leaked)} unsampled requests exported spans")


def responses_phase(info: dict, base: str) -> None:
    """/v1/responses: create (greedy), retrieve, chain through
    ``previous_response_id``, delete (then 404); a conversation whose
    response appends its turns; a streamed response whose events come as
    created, deltas, completed and spell its text. The greedy text equals
    the chat route's for the same messages."""
    body = {"model": MODEL, "input": "Name three colours.", "max_output_tokens": 16,
            "temperature": 0.0}
    t0 = time.perf_counter()
    status, raw = _call(base + "/v1/responses", body)
    info["create_ms"] = (time.perf_counter() - t0) * 1e3
    first = json.loads(raw)
    if status != 200 or first["status"] != "completed" or first["usage"]["output_tokens"] < 1:
        raise AssertionError(f"create: {status} {raw[:200]!r}")
    text = first["output"][0]["content"][0]["text"]
    status, raw = _call(base + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": body["input"]}], "max_tokens": 16,
        "temperature": 0.0})
    chat = json.loads(raw)
    info.update(text_chars=len(text),
                text_equal_chat=chat["choices"][0]["message"]["content"] == text)
    if not info["text_equal_chat"] or (
            chat["usage"]["completion_tokens"] != first["usage"]["output_tokens"]):
        raise AssertionError("the response's greedy text or length differs from the chat route's")
    if json.loads(_call(base + f"/v1/responses/{first['id']}")[1]).get("id") != first["id"]:
        raise AssertionError("retrieve")
    status, raw = _call(base + "/v1/responses", {**body, "input": "And three more.",
                                                 "previous_response_id": first["id"]})
    second = json.loads(raw)
    if status != 200 or second["usage"]["input_tokens"] <= first["usage"]["input_tokens"]:
        raise AssertionError(f"chaining: {status} {second.get('usage')}")
    if _call(base + f"/v1/responses/{first['id']}", method="DELETE")[0] != 200 or (
            _call(base + f"/v1/responses/{first['id']}")[0] != 404):
        raise AssertionError("delete")
    conv = json.loads(_call(base + "/v1/conversations", {"metadata": {"smoke": "1"}})[1])
    _call(base + f"/v1/conversations/{conv['id']}/items",
          {"items": [{"type": "message", "role": "user", "content": "Remember blue."}]})
    status, _ = _call(base + "/v1/responses", {**body, "input": "Which colour?",
                                               "conversation": conv["id"]})
    items = json.loads(_call(base + f"/v1/conversations/{conv['id']}/items")[1])["data"]
    info["conversation_roles"] = [m["role"] for m in items]
    if status != 200 or info["conversation_roles"] != ["user", "user", "assistant"]:
        raise AssertionError(f"conversation: {status} {info['conversation_roles']}")
    req = urllib.request.Request(base + "/v1/responses",
                                 data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    events, name = [], None
    with urllib.request.urlopen(req, timeout=120) as r:
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("event: "):
                name = line[7:]
            elif line.startswith("data: "):
                events.append((name, json.loads(line[6:])))
    names = [e for e, _ in events]
    info["stream_events"] = len(names)
    deltas = "".join(d["delta"] for e, d in events if e == "response.output_text.delta")
    final = events[-1][1]["response"]
    # A delta event carries text: random weights mostly pick ids above the
    # byte tokenizer's 259, which decode to nothing, so there may be none.
    if (names[0] != "response.created" or names[-1] != "response.completed"
            or set(names[1:-1]) - {"response.output_text.delta"}
            or final["output"][0]["content"][0]["text"] != deltas
            or final["usage"]["output_tokens"] != first["usage"]["output_tokens"]):
        raise AssertionError(f"streamed response events {names}, usage {final['usage']}")


def grpc_phase(info: dict, base: str) -> None:
    """/vllm.Generation/Generate, unstreamed and streamed, gives the token
    ids the completion route annotates for the same prompt ids."""
    prompt = [3 + (13 * i) % 250 for i in range(40)]
    sampling = {"max_tokens": 16, "temperature": 0.0, "ignore_eos": True}
    body = {"prompt_token_ids": prompt, "model": MODEL, "sampling_params": sampling}
    t0 = time.perf_counter()
    status, raw = _call(base + "/vllm.Generation/Generate", body)
    info["generate_ms"] = (time.perf_counter() - t0) * 1e3
    plain = json.loads(raw)
    streamed = _stream(base, "/vllm.Generation/Generate", {**body, "stream": True})
    frames = streamed["frames"]
    ids = [t for f in frames for t in f.get("token_ids", [])]
    completion = _stream(base, "/v1/completions",
                         {"prompt": prompt, "stream": True, **sampling},
                         {"x-llmd-stream-tokens": "1"})
    annotated = [t for f in completion["frames"] for t in f.get("token_ids", [])]
    info["token_ids"] = plain["token_ids"]
    if status != 200 or len(plain["token_ids"]) != 16 or plain["finish_reason"] != "length":
        raise AssertionError(f"Generate: {status} {raw[:200]!r}")
    if not streamed["done"] or frames[-1].get("usage", {}).get("completion_tokens") != 16:
        raise AssertionError(f"streamed Generate ended with {frames[-1:]}")
    if not (ids == plain["token_ids"] == annotated):
        raise AssertionError(f"Generate {plain['token_ids']}, streamed {ids}, completion {annotated}")


def serve_phase(info: dict, layout_args: list[str], model: str = MODEL,
                surface: dict | None = None, flags: tuple = (), name: str | None = None,
                sink: OtlpSink | None = None, check=None) -> list[str]:
    """Start the server for ``model`` (a registry name or an HF model
    directory, with ``flags`` and ``layout_args`` appended to its command
    line) and complete a few requests. ``/v1/models`` must report the
    served name ``name`` (default: ``model``) and 8,192 tokens. Every
    server streams one completion and must deliver one chunk per token and
    the text of the same completion unstreamed; a server in its default
    layout also answers two plain requests, one with a 600-token prompt.
    With ``surface`` (a dict of numbers to report with it),
    ``surface_phase`` then runs on this server as a phase of its own. With
    ``sink`` the server exports its spans to that collector at ratio 1.0
    and runs under ``failover_fault_plan``, and the ``failover``,
    ``deadline``, ``tracing``, ``responses`` and ``grpc`` phases follow.
    ``check(info, base)`` runs last while the server is up. Returns the
    completions' texts, the streamed one last."""
    name = name or model
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    log_path = os.path.join(REPO, "build", "chip_smoke_serve.log")
    env = dict(os.environ)
    if sink is not None:
        flags = (*flags, "--otlp-traces-endpoint", sink.url, "--trace-sample-ratio", "1.0")
        env["LLMD_FAULT_PLAN"] = failover_fault_plan()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "llmd_tpu_torch.serve", "--model", model,
             "--host", "127.0.0.1", "--port", str(port), *flags, *layout_args],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT, env=env,
        )
        try:
            t0 = time.perf_counter()
            while True:
                if proc.poll() is not None:
                    raise RuntimeError(f"server exited with {proc.returncode}; see {log_path}")
                try:
                    with urllib.request.urlopen(base + "/health", timeout=5) as r:
                        if r.status == 200:
                            break
                except OSError:
                    pass
                if time.perf_counter() - t0 > 600:
                    raise TimeoutError("server did not become healthy in 600 s")
                time.sleep(1.0)
            info["startup_s"] = time.perf_counter() - t0
            info["server_rss_gb"] = host_rss(proc.pid) / 1e9
            with urllib.request.urlopen(base + "/v1/models", timeout=30) as r:
                (entry,) = json.loads(r.read())["data"]
            info["served"] = [entry["id"], entry["max_model_len"]]
            if info["served"] != [name, 8192]:
                raise AssertionError(f"/v1/models reports {info['served']}, want {[name, 8192]}")
            usages, texts = [], []
            bodies = [{"prompt": "Stream this.", "max_tokens": 16}]
            if not layout_args:
                bodies += [
                    {"prompt": f"The port serves {name}.", "max_tokens": 16},
                    {"prompt": [3 + i % 250 for i in range(600)], "max_tokens": 16},
                ]
            for body in bodies:
                status, raw = _post(base + "/v1/completions",
                                    {**body, "temperature": 0.0, "ignore_eos": True})
                if status != 200:
                    raise AssertionError(f"/v1/completions returned {status}")
                reply = json.loads(raw)
                usages.append(reply["usage"]["completion_tokens"])
                texts.append(reply["choices"][0]["text"])
                if body is bodies[0]:
                    unstreamed = reply["choices"][0]["text"]
            status, raw = _post(base + "/v1/completions", {
                **bodies[0], "temperature": 0.0, "ignore_eos": True, "stream": True,
            })
            frames = [
                json.loads(line[6:]) for line in raw.decode().splitlines()
                if line.startswith("data: {")
            ]
            if status != 200 or "usage" not in frames[-1]:
                raise AssertionError(f"streamed completion failed: {status}")
            usages.append(frames[-1]["usage"]["completion_tokens"])
            info["completion_tokens"] = usages
            info["stream_chunks"] = len(frames) - 1
            if set(usages) != {16}:
                raise AssertionError(f"completion_tokens {usages}, want 16 each")
            # One chunk per token, then the final frame; in order, the
            # chunks spell the unstreamed completion (the 12-token prompt
            # fills no page, so the repeat starts from no cached prefix and
            # runs the same steps).
            if len(frames) - 1 != 16:
                raise AssertionError(f"{len(frames) - 1} token chunks for 16 tokens")
            streamed = "".join(f["choices"][0]["text"] for f in frames)
            if streamed != unstreamed:
                raise AssertionError("the streamed text differs from the unstreamed completion's")
            texts.append(streamed)
            if check is not None:
                check(info, base)
            if surface is not None:
                with phase("surface", {"model": model, "layout": "flat step", **surface}) as sinfo:
                    surface_phase(sinfo, base, bodies[2]["prompt"])
            if sink is not None:
                with phase("failover", {"model": model, "layout": "flat step"}) as sinfo:
                    failover_phase(sinfo, base)
                with phase("deadline", {"model": model, "layout": "flat step"}) as sinfo:
                    deadline_phase(sinfo, base)
                with phase("tracing", {"model": model, "layout": "flat step"}) as sinfo:
                    tracing_phase(sinfo, base, sink)
                with phase("responses", {"model": model, "layout": "flat step"}) as sinfo:
                    responses_phase(sinfo, base)
                with phase("grpc", {"model": model, "layout": "flat step"}) as sinfo:
                    grpc_phase(sinfo, base)
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    return texts

DS_MODEL = "deepseek-v2-lite"


def routed_group_sizes(tokens: int, experts: int, k: int, gen) -> torch.Tensor:
    """Group sizes of ``tokens`` tokens each routed to ``k`` distinct
    experts drawn uniformly: what a router with random weights gives."""
    ids = torch.rand((tokens, experts), generator=gen).argsort(dim=1)[:, :k]
    return torch.bincount(ids.reshape(-1), minlength=experts).to(torch.int32)


def _grouped_library_ms(x, ws, gs) -> tuple[float, str]:
    """Device time of the PyTorch calls computing the grouped products of x
    with each weight tensor in ``ws``: ``torch._grouped_mm`` once a tensor
    where this torch has it and takes these inputs, else (event-timed) a
    host loop of per-expert ``torch.matmul`` (offsets read back before
    timing). Returns (ms, which call)."""
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    if hasattr(torch, "_grouped_mm"):
        try:
            torch._grouped_mm(x, ws[0], offs=offs)
            torch.cuda.synchronize()
            return (device_ms(lambda: [torch._grouped_mm(x, w, offs=offs) for w in ws]),
                    "torch._grouped_mm" + (f" x {len(ws)}" if len(ws) > 1 else ""))
        except (RuntimeError, TypeError) as e:
            print(f"torch._grouped_mm refused these inputs: {str(e)[:120]}", file=sys.stderr)
    ends = [0] + offs.tolist()
    out = torch.empty((x.shape[0], ws[0].shape[2]), dtype=x.dtype, device=x.device)

    def loop():
        for w in ws:
            for g in range(w.shape[0]):
                if ends[g + 1] > ends[g]:
                    torch.matmul(x[ends[g] : ends[g + 1]], w[g], out=out[ends[g] : ends[g + 1]])

    return cuda_ms(loop), "per-expert torch.matmul loop"


def host_us(fn, n: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to return (the enqueue, not
    the device work), the mean over ``n`` calls after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def grouped_case(T: int, E: int, k: int, K: int, N: int, pair: bool, gen, g, dev) -> dict:
    """K6' on one routed step: T tokens each routed to k of E experts (the
    row counts a router with random weights gives), x [T k, K] bf16 against
    one weight tensor [E, K, N], or two through the pair call. Held to the
    plain version within one bf16 ulp, timed on the device (``device_ms``;
    the single-call event time beside it) beside the bound, the plain
    version and ``torch._grouped_mm`` (once a weight tensor), with the
    wrapper's host time a call."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.ops import grouped_gemm

    dt = torch.bfloat16
    gs = routed_group_sizes(T, E, k, gen).to(dev)
    M = T * k
    x = torch.randn((M, K), generator=g, device=dev, dtype=dt)
    ws = [torch.randn((E, K, N), generator=g, device=dev, dtype=dt).mul_(K**-0.5)
          for _ in range(2 if pair else 1)]
    if pair:
        kernel = lambda: ops.grouped_matmul_pair(x, ws[0], ws[1], gs)  # noqa: E731
        plain = lambda: ops.grouped_matmul_pair_plain(x, ws[0], ws[1], gs)  # noqa: E731
    else:
        kernel = lambda: (ops.grouped_matmul(x, ws[0], gs),)  # noqa: E731
        plain = lambda: (ops.grouped_matmul_plain(x, ws[0], gs),)  # noqa: E731
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(got, want):
        e, bad = outside_one_ulp(a, b)
        if bad:
            raise AssertionError(f"grouped_gemm M={M} K={K} N={N} pair={pair}: max abs err {e} vs plain")
        err = max(err, e)
    del got, want
    live = int((gs > 0).sum().item())
    # Bound: x read once, the routed experts' weights read once, the
    # outputs written; 2 flops per multiply-add of the routed rows.
    nw = len(ws)
    nbytes = (M * K + nw * (live * K * N + M * N)) * x.element_size() + 4 * E
    b_ms, b_by = bound(nbytes, 2.0 * nw * M * K * N)
    lib_ms, lib = _grouped_library_ms(x, ws, gs)
    ms = device_ms(kernel)
    row = {
        "M": M, "experts": E, "live_experts": live, "K": K, "N": N, "weights": nw,
        "tiles": grouped_gemm.TILES[grouped_gemm.tile_choice(M, E)],
        "max_abs_err": err, "ms": ms, "event_ms": cuda_ms(kernel),
        "plain_ms": cuda_ms(plain, reps=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
        "library_ms": lib_ms, "library_call": lib, "host_us": host_us(kernel),
    }
    del x, ws
    torch.cuda.empty_cache()
    return row


def latent_case(cfg, H: int, gen, g, dev) -> dict:
    """K5' on one decode step of the batch bucket 64 (48 live rows at 1k-4k
    context, 16 pad rows) over a latent pool of ``cfg``'s width and a
    27-layer depth, with H query heads: held to the plain version within
    one bf16 ulp, pad rows zero, timed on the device (``device_ms``; the
    single-call event time beside it) beside the bound, the plain version
    and SDPA on the gathered rows, with the wrapper's host time a call."""
    import torch.nn.functional as F

    from llmd_tpu_torch import ops

    dt = torch.bfloat16
    L, Dl, rank, page = 27, cfg.kv_cache_entry_dim, cfg.kv_lora_rank, 16
    d = decode_batch(cfg, page, 1024, 4096, gen, dev)
    B, n_live, ctx = d["B"], d["n_live"], d["ctx"]
    pool = torch.randn((L, d["num_pages"], 1, page, Dl), generator=g, device=dev, dtype=dt)
    q = torch.randn((B, 1, H, Dl), generator=g, device=dev, dtype=dt)
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    layer = L // 2
    aargs = (q, pool, layer, d["page_table"], d["kv_lens"], rank, scale)
    got = ops.mla_decode_paged_attention_full(*aargs)
    want = ops.mla_decode_paged_attention_plain(*aargs, live_pages=d["live_pages"])
    torch.cuda.synchronize()
    err, bad = outside_one_ulp(got, want)
    if bad:
        raise AssertionError(f"mla_decode_attention H={H}: max abs err {err} vs plain")
    if got[n_live:].any():
        raise AssertionError(f"mla_decode_attention H={H}: a pad row is not zero")
    del want
    es = pool.element_size()
    # Bound: each live row's latent rows read once, q read, out written;
    # operations: scores over Dl and values over rank, per head and position.
    nbytes = (sum(ctx) * Dl + B * H * Dl + B * H * rank) * es
    b_ms, b_by = bound(nbytes, 2.0 * H * (Dl + rank) * sum(ctx))
    # Library yardstick: SDPA on each row's live latent rows gathered to a
    # dense, padded [B, 1, S, Dl] key (the one latent head shared by every
    # query head) and its rank slice as the value; the gather is not timed.
    smax = max(ctx)
    keys = torch.zeros((n_live, 1, smax, Dl), dtype=dt, device=dev)
    for r, n in enumerate(ctx):
        pages = d["page_table"][r, : -(-n // page)].long()
        keys[r, 0, :n] = pool[layer, pages].reshape(-1, Dl)[:n]
    mask = (torch.arange(smax, device=dev)[None, :] < d["kv_lens"][:n_live, None])[:, None, None, :]
    qd = q[:n_live].transpose(1, 2)  # [n, H, 1, Dl]
    vals = keys[..., :rank]
    try:
        F.scaled_dot_product_attention(qd, keys, vals, attn_mask=mask, scale=scale, enable_gqa=True)
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qd, keys, vals, attn_mask=mask, scale=scale, enable_gqa=True))
        lib = "scaled_dot_product_attention (enable_gqa)"
    except (RuntimeError, TypeError):
        kx, vx = keys.expand(-1, H, -1, -1), vals.expand(-1, H, -1, -1)
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(qd, kx, vx, attn_mask=mask, scale=scale))
        lib = "scaled_dot_product_attention (heads expanded)"
    kernel = lambda: ops.mla_decode_paged_attention_full(*aargs)  # noqa: E731
    ms = device_ms(kernel)
    row = {
        "batch": B, "live_rows": n_live, "heads": H, "context_tokens": sum(ctx), "layers": L,
        "pool_gib": pool.numel() * es / 2**30, "max_abs_err": err, "ms": ms,
        "event_ms": cuda_ms(kernel),
        "plain_ms": cuda_ms(
            lambda: ops.mla_decode_paged_attention_plain(*aargs, live_pages=d["live_pages"]), reps=10),
        "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
        "library_ms": lib_ms, "library_call": lib,
        "host_us": host_us(kernel),
    }
    del pool, keys, q
    torch.cuda.empty_cache()
    return row


def latent_write_case(cfg, gen, g, dev) -> dict:
    """The store-only K4' (the TPU kernel's own function) on MLA's latent
    rows, as MLA ran it before the latent form: one latent row (``cfg``'s
    640 bf16 values, written as the K and V halves of one "head") a row of
    one decode step of the batch bucket 64 (48 live rows at 1k-4k context,
    16 pad rows with garbage targets) into a 27-layer latent pool. The pool
    bytes must equal the plain version's; timed beside its byte bound (the
    live rows in and out, the addressing), the plain version and one
    ``index_put_`` of the live rows. No model's path runs it since the
    latent form, so its row says so (``on_path`` false, no launches)."""
    from llmd_tpu_torch import ops

    dt, L, Dl, page = torch.bfloat16, 27, cfg.kv_cache_entry_dim, 16
    d = decode_batch(cfg, page, 1024, 4096, gen, dev)
    B, n_live = d["B"], d["n_live"]
    pool = torch.randn((L, d["num_pages"], 1, page, Dl), generator=g, device=dev, dtype=dt)
    kv_new = torch.randn((B, 1, Dl), generator=g, device=dev, dtype=dt)
    layer = L // 2
    wargs = (kv_new, layer, d["phys"], d["offset"], d["valid"])
    plane = pool[layer]
    before = plane.clone()
    ops.write_kv_pages_decode_full(pool, *wargs)
    got = plane.clone()
    plane.copy_(before)
    ops.write_kv_pages_decode_plain(pool, *wargs)
    torch.cuda.synchronize()
    if not torch.equal(got, plane) or torch.equal(got, before):
        raise AssertionError("decode_kv_write (latent rows): pool bytes differ from the plain version")
    del got, before
    es = pool.element_size()
    b_ms, b_by = bound(2 * n_live * Dl * es + 3 * 4 * B, 0.0)
    idx = (d["phys"][:n_live].long(), torch.zeros(n_live, dtype=torch.long, device=dev),
           d["offset"][:n_live].long())
    live_rows = kv_new[:n_live, 0]
    times = kernel_times(lambda: ops.write_kv_pages_decode_full(pool, *wargs))
    row = {
        "name": f"decode_kv_write@{cfg.name}", "route": "cuda",
        "source": "llmd_tpu_torch/ops/csrc/decode_kv_write.cu",
        "replaces": "llmd_tpu/ops/kv_write.py:298", "max_abs_err": 0.0, **times,
        "plain_ms": cuda_ms(lambda: ops.write_kv_pages_decode_plain(pool, *wargs)),
        "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / times["ms"],
        "library_ms": device_ms(lambda: plane.index_put_(idx, live_rows)),
        "on_path": False, "launches": 0,
    }
    del pool, kv_new
    torch.cuda.empty_cache()
    return row


def latent_rows_apart(got: torch.Tensor, want: torch.Tensor, rank: int) -> dict:
    """Latent rows [..., Dl] written by K4''s latent form against the plain
    version's: their rope and pad columns equal, and the largest distance
    of their c_kv columns (``[..., :rank]``) in bf16 ulps of the plain
    value (the form's norm sums its squares in another order)."""
    g, w = got[..., :rank].double(), want[..., :rank].double()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0**-100))) - 7)
    return {"rope_and_pad_equal": bool(torch.equal(got[..., rank:], want[..., rank:])),
            "c_kv_max_ulps": ((g - w).abs() / ulp).max().item() if g.numel() else 0.0}


LATENT_SOURCE = {"route": "cuda", "source": "llmd_tpu_torch/ops/csrc/decode_kv_write.cu",
                 "replaces": "llmd_tpu/ops/kv_write.py:298"}


def latent_fused_case(cfg, kind: str, gen, g, dev) -> dict:
    """K4''s latent form (``ops.rope_write_latent_full``) at ``cfg``'s
    widths on a 27-layer latent pool: "decode", one step of the batch
    bucket 64 (48 live rows at 1k-4k context, 16 pad rows with garbage
    targets); "prefill", a bucket of 4 rows x 256 = 1,024 tokens (624
    live, 400 pad tokens); both addressed by page table and positions. kv_a is a bf16 [B, Q, rank + rope] product output, q_pe
    the rope heads of a q projection (a strided view), q_eff_nope the
    absorption einsum's output. Held to the plain version: q_eff (every
    row) and the stored rows' rope and pad parts bit-equal, c_kv bit-equal
    to the plain arithmetic run with the kernel's norm factor and within
    two bf16 ulps of the plain chain, the factor within RSTD_REL, nothing
    stored for a pad (the pool equals the plain version's elsewhere, and
    only the live tokens' rows changed). Timed in device time beside the
    byte bound (kv_a, q_pe, q_eff_nope, the cos/sin rows and the weight in;
    the live rows and q_eff out; 4 bytes of addressing a row), the plain
    version, the unfused chain it replaces (the body of ``mla_write``
    between the projections and the einsum before the fused form:
    ``rms_norm``, ``apply_rope`` twice, the concatenations and pads and
    ``ops.write_kv_pages_full``: the store-only K4' at Q = 1, the plain
    scatter at Q > 1) and ``index_put_`` of the finished live rows (the
    nearest library call: no PyTorch call computes the whole function)."""
    import torch.nn.functional as F

    from llmd_tpu_torch import ops
    from llmd_tpu_torch.models.common import apply_rope, rms_norm, rope_tables

    dt, L, page = torch.bfloat16, 27, 16
    rank, rope, Dl, nh = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.kv_cache_entry_dim, cfg.num_heads
    nope = cfg.qk_nope_head_dim
    if kind == "decode":
        d = decode_batch(cfg, page, 1024, 4096, gen, dev)
        B, Q, num_pages = d["B"], 1, d["num_pages"]
        page_table, positions = d["page_table"].clone(), d["positions"]
        page_table[d["n_live"]:] = 2**30  # pad rows: garbage targets
        valid = d["valid"][:, None] > 0
        prep = (d["phys"], d["offset"], d["valid"])  # the unfused chain's store only
    else:
        rows = [(0, 256), (512, 200), (0, 128), (1000, 40)]
        p = bucketed_rows(cfg, page, rows, gen, dev)
        B, Q, num_pages = len(rows), 256, p["num_pages"]
        page_table, positions = p["page_table"], p["positions"]
        valid = p["live"].view(B, Q)
        prep = None
    N = B * Q
    pool = torch.randn((L, num_pages, 1, page, Dl), generator=g, device=dev, dtype=dt)
    kv_a = torch.randn((B, Q, rank + rope), generator=g, device=dev, dtype=dt).mul_(3)
    q = torch.randn((B, Q, nh, nope + rope), generator=g, device=dev, dtype=dt)
    w_uk = torch.randn((nh, rank, nope), generator=g, device=dev, dtype=dt).mul_(nope**-0.5)
    q_pe = q[..., nope:]
    q_eff_nope = torch.einsum("bqhn,hrn->bqhr", q[..., :nope], w_uk)
    w = (1 + 0.1 * torch.randn((rank,), generator=g, device=dev)).to(dt)
    cos, sin = rope_tables(positions, rope, cfg.rope_theta, cfg.rope_scaling)
    eps, layer = cfg.rms_norm_eps, L // 2
    args = (kv_a, w, eps, cos, sin, q_pe, q_eff_nope, page_table, positions, valid)
    plane = pool[layer]
    before = plane.clone()
    rk, rp = torch.empty(N, device=dev), torch.empty(N, device=dev)
    got = ops.rope_write_latent_full(pool, layer, *args, rstd=rk)
    got_plane = plane.clone()
    plane.copy_(before)
    want = ops.rope_write_latent_plain(pool, layer, *args, rstd=rp)
    torch.cuda.synchronize()
    pos = positions.long()
    phys = torch.gather(page_table.long(), 1, pos // page)[valid]
    slot = (pos % page)[valid]
    n_live = int(valid.sum().item())
    exact = (kv_a[..., :rank].float() * rk.view(B, Q, 1)).to(dt) * w
    held = plane.clone()
    held[phys, 0, slot, :rank] = exact[valid]
    apart = latent_rows_apart(got_plane[phys, 0, slot], plane[phys, 0, slot], rank)
    changed = int((got_plane != before).any(dim=-1).sum().item())
    rstd_rel = ((rk - rp).abs() / rp).max().item()
    name = f"decode_kv_write[latent]@{cfg.name} {kind}"
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: q_eff differs from the plain version")
    if not torch.equal(got_plane, held):
        raise AssertionError(f"{name}: the pool differs from the plain version beyond c_kv's "
                             "factor, or a pad stored")
    if apart["c_kv_max_ulps"] > 2 or rstd_rel > RSTD_REL or changed > n_live or changed == 0:
        raise AssertionError(f"{name}: c_kv {apart}, factor {rstd_rel}, {changed} rows changed "
                             f"for {n_live} live tokens")
    err = (got_plane[phys, 0, slot].float() - plane[phys, 0, slot].float()).abs().max().item()
    del got, want, got_plane, held, before

    def unfused():  # mla_write's body around the store before the fused form
        c_kv = rms_norm(kv_a[..., :rank], w, eps)
        k_pe = apply_rope(kv_a[..., None, rank:], cos, sin)[:, :, 0]
        lat4 = F.pad(torch.cat([c_kv, k_pe], dim=-1), (0, Dl - rank - rope))[:, :, None, :]
        ops.write_kv_pages_full(pool, layer, lat4[..., : Dl // 2], lat4[..., Dl // 2 :],
                                page_table, positions, valid, prep)
        return F.pad(torch.cat([q_eff_nope, apply_rope(q_pe, cos, sin)], dim=-1),
                     (0, Dl - rank - rope))

    latent = F.pad(torch.cat([exact, apply_rope(kv_a[..., None, rank:], cos, sin)[:, :, 0]], -1),
                   (0, Dl - rank - rope))[valid]
    idx = (phys, torch.zeros_like(phys), slot)
    es = pool.element_size()
    nbytes = (N * (rank + rope) + N * nh * (rope + rank) + rank + n_live * Dl + N * nh * Dl) * es
    nbytes += N * rope * 4 + 4 * N
    b_ms, b_by = bound(nbytes, 0.0)
    times = kernel_times(lambda: ops.rope_write_latent_full(pool, layer, *args))
    row = {
        "name": name, **LATENT_SOURCE, "max_abs_err": err, **times,
        "plain_ms": cuda_ms(lambda: ops.rope_write_latent_plain(pool, layer, *args), reps=10, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / times["ms"],
        "library_ms": device_ms(lambda: plane.index_put_(idx, latent)),
        "library_call": "index_put_ of the finished live rows",
        "unfused_ms": device_ms(unfused), "rows": N, "live_rows": n_live,
        "c_kv_max_ulps": apart["c_kv_max_ulps"], "rstd_max_rel": rstd_rel,
        "wrapper": "write_kv_pages_decode_full", "model": cfg.name,
    }
    del pool, kv_a, q, q_eff_nope, latent
    torch.cuda.empty_cache()
    return row


def moe_mla_kernels_phase(info: dict) -> dict:
    """K6' at deepseek-v2-lite's expert shapes (a 48-row decode step and a
    1024-token prefill step: the gate|up pair, the gate alone and the down
    call), at gpt-oss-20b's (32 experts, top-4, K = N = 2,880: a 32-token
    decode step and a 1,024-token prefill step, the pair and the down call)
    and at qwen3-30b-a3b's (one layer's 128 experts, top-8, decode step);
    K5' on one decode step of the batch bucket 64 (48 live rows at 1k-4k
    context, 16 pad rows) over a 27-layer latent pool, at deepseek-v2-lite's
    16 heads and deepseek-r1's 128; K4''s latent form on a decode step and
    a 1,024-token prefill bucket (``latent_fused_case``), and the
    store-only K4' on a decode step's latent rows. Each is held to its
    plain version (within one bf16 ulp; the writes bit for bit, c_kv given
    the norm's factor) and timed beside its bound, the plain version and
    one library call."""
    from llmd_tpu_torch.models.registry import get_model_config

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2024)
    g = torch.Generator(device=dev).manual_seed(31)
    ds, qw, oss = (get_model_config(n) for n in (DS_MODEL, "qwen3-30b-a3b", OSS_MODEL))
    H, Fm = ds.hidden_size, ds.moe_intermediate_size
    dsk = (ds.num_experts, ds.num_experts_per_tok)
    ossk = (oss.num_experts, oss.num_experts_per_tok)
    cases = {
        # name: (tokens, experts, top-k, K, N, pair)
        "deepseek-v2-lite decode 48 rows, gate": (48, *dsk, H, Fm, False),
        "deepseek-v2-lite decode 48 rows, gate|up pair": (48, *dsk, H, Fm, True),
        "deepseek-v2-lite decode 48 rows, down": (48, *dsk, Fm, H, False),
        "deepseek-v2-lite prefill 1024 tokens, gate": (1024, *dsk, H, Fm, False),
        "deepseek-v2-lite prefill 1024 tokens, gate|up pair": (1024, *dsk, H, Fm, True),
        "deepseek-v2-lite prefill 1024 tokens, down": (1024, *dsk, Fm, H, False),
        "gpt-oss-20b decode 32 tokens, gate|up pair": (
            32, *ossk, oss.hidden_size, oss.moe_intermediate_size, True),
        "gpt-oss-20b decode 32 tokens, down": (
            32, *ossk, oss.moe_intermediate_size, oss.hidden_size, False),
        "gpt-oss-20b prefill 1024 tokens, gate|up pair": (
            1024, *ossk, oss.hidden_size, oss.moe_intermediate_size, True),
        "gpt-oss-20b prefill 1024 tokens, down": (
            1024, *ossk, oss.moe_intermediate_size, oss.hidden_size, False),
        "qwen3-30b-a3b decode 48 rows, gate": (
            48, qw.num_experts, qw.num_experts_per_tok, qw.hidden_size, qw.moe_intermediate_size,
            False),
    }
    gemm = {name: grouped_case(*c, gen, g, dev) for name, c in cases.items()}
    info["grouped_gemm"] = gemm
    r1 = get_model_config("deepseek-r1")
    latent = {  # deepseek-r1's latent is deepseek-v2-lite's (512 + 64, padded to 640)
        "deepseek-v2-lite, 16 heads": latent_case(ds, ds.num_heads, gen, g, dev),
        "deepseek-r1, 128 heads": latent_case(r1, r1.num_heads, gen, g, dev),
    }
    info["mla_decode_attention"] = latent
    keys_ = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_share", "library_ms",
             "host_us")
    gg_src = {"route": "cuda", "source": "llmd_tpu_torch/ops/csrc/grouped_gemm.cu",
              "replaces": "llmd_tpu/ops/grouped_gemm.py:43"}
    table = {
        # table name: (case, wrapper, model whose engine run is its main path)
        "grouped_gemm": ("deepseek-v2-lite decode 48 rows, gate", "grouped_matmul", DS_MODEL),
        "grouped_gemm@down": ("deepseek-v2-lite decode 48 rows, down", "grouped_matmul", DS_MODEL),
        "grouped_gemm@prefill": ("deepseek-v2-lite prefill 1024 tokens, gate", "grouped_matmul",
                                 DS_MODEL),
        "grouped_gemm_pair": ("deepseek-v2-lite decode 48 rows, gate|up pair",
                              "grouped_matmul_pair", DS_MODEL),
        "grouped_gemm_pair@prefill": ("deepseek-v2-lite prefill 1024 tokens, gate|up pair",
                                      "grouped_matmul_pair", DS_MODEL),
        "grouped_gemm_pair@gpt-oss decode": ("gpt-oss-20b decode 32 tokens, gate|up pair",
                                             "grouped_matmul_pair", OSS_MODEL),
        "grouped_gemm_pair@gpt-oss prefill": ("gpt-oss-20b prefill 1024 tokens, gate|up pair",
                                              "grouped_matmul_pair", OSS_MODEL),
        "grouped_gemm@gpt-oss prefill down": ("gpt-oss-20b prefill 1024 tokens, down",
                                              "grouped_matmul", OSS_MODEL),
    }
    out = {name: {"name": name, **gg_src, "wrapper": wrapper, "model": model, "shape": case,
                  **{k: gemm[case][k] for k in keys_}}
           for name, (case, wrapper, model) in table.items()}
    for name, case in (("mla_decode_attention", "deepseek-v2-lite, 16 heads"),
                       ("mla_decode_attention@128 heads", "deepseek-r1, 128 heads")):
        out[name] = {
            "name": name, "route": "cuda",
            "source": "llmd_tpu_torch/ops/csrc/mla_decode_attention.cu",
            "replaces": "llmd_tpu/ops/mla_decode.py:143",
            "wrapper": "mla_decode_paged_attention_full", "model": DS_MODEL, "shape": case,
            **{k: latent[case][k] for k in keys_},
        }
    # K4''s latent form at decode and prefill, then the store-only K4'.
    for kind in ("decode", "prefill"):
        e = latent_fused_case(ds, kind, gen, g, dev)
        info[e["name"]] = {k: e[k] for k in (*WRITE_KEYS, "c_kv_max_ulps", "rstd_max_rel") if k in e}
        out[e["name"]] = e
    e = latent_write_case(ds, gen, g, dev)
    info[e["name"]] = {k: e[k] for k in (*WRITE_KEYS, "on_path") if k in e}
    out[e["name"]] = e
    return out


def bucketed_rows(cfg, page, rows, gen, dev) -> dict:
    """A bucketed [B, Q] prefill step of (start, width) rows, each row on
    its own physical pages (a random permutation of the pool)."""
    B, Q = len(rows), max(w for _, w in rows)
    need = [-(-(p0 + w) // page) for p0, w in rows]
    num_pages = sum(need) + 8
    perm = torch.randperm(num_pages, generator=gen).to(torch.int32)
    page_table = torch.zeros((B, -(-cfg.max_model_len // page)), dtype=torch.int32)
    tokens = torch.zeros((B, Q), dtype=torch.int64)
    positions = torch.zeros((B, Q), dtype=torch.int32)
    off = 0
    for r, ((p0, w), n) in enumerate(zip(rows, need)):
        page_table[r, :n] = perm[off : off + n]
        off += n
        tokens[r, :w] = torch.randint(0, cfg.vocab_size, (w,), generator=gen)
        positions[r, :w] = torch.arange(p0, p0 + w)
        positions[r, w:] = p0 + w - 1
    qlens = torch.tensor([w for _, w in rows], dtype=torch.int32)
    kv_lens = torch.tensor([p0 + w for p0, w in rows], dtype=torch.int32)
    return {
        "tokens": tokens.to(dev), "positions": positions.to(dev), "query_lens": qlens.to(dev),
        "kv_lens": kv_lens.to(dev), "page_table": page_table.to(dev),
        "num_pages": num_pages, "live_pages": max(need),
        "live": (torch.arange(Q)[None, :] < qlens[:, None]).reshape(-1).to(dev),
    }


def cut_layers(params: dict, n: int, dtype) -> dict:
    """The first ``n`` layers of a model (its dense prefix first), cast to
    ``dtype`` where that widens or keeps a leaf (f32 leaves such as the
    sinks and the router bias stay f32): the f32 reference of a model too
    large to upcast whole."""
    def cast(v):
        return v.to(torch.promote_types(v.dtype, dtype))

    out = {k: cast(v) for k, v in params.items() if not isinstance(v, dict)}
    dense = params.get("dense_layers", {})
    n_dense = next(iter(dense.values())).shape[0] if dense else 0
    if dense:
        out["dense_layers"] = {k: cast(v[: min(n, n_dense)]) for k, v in dense.items()}
    out["layers"] = {k: cast(v[: n - n_dense]) for k, v in params["layers"].items()}
    return out


def ds_forward_phase(info: dict, params: dict) -> None:
    """deepseek-v2-lite at full width: one bucketed prefill forward (Q > 1:
    K4''s latent form, plain latent attention, K6' in every MoE layer) and
    one Q = 1 decode forward (K4''s latent form, K5' and K6') of the
    27-layer model, through the kernels
    and through the plain versions. An f32 copy of 27 layers (63 GB) does
    not fit beside the bf16 weights, so the f32 reference runs the first 4
    layers (the dense layer and 3 MoE layers) at full width."""
    import dataclasses

    from llmd_tpu_torch import ops
    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.common import StepInput
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(DS_MODEL)
    dev, page, L = torch.device("cuda"), 16, cfg.num_layers
    n_moe = L - cfg.first_dense_layers
    gen = torch.Generator().manual_seed(17)
    g = torch.Generator(device=dev).manual_seed(19)
    p = bucketed_rows(cfg, page, [(0, 256), (512, 200), (0, 128), (1000, 40)], gen, dev)
    prefill = StepInput(token_ids=p["tokens"], positions=p["positions"], kv_lens=p["kv_lens"],
                        page_table=p["page_table"], query_lens=p["query_lens"],
                        live_pages=p["live_pages"])
    d = decode_batch(cfg, page, 128, 640, gen, dev)
    ids = torch.randint(0, cfg.vocab_size, (d["B"], 1), generator=g, device=dev)
    decode = StepInput(token_ids=torch.where(d["valid"][:, None] > 0, ids, 0),
                       positions=d["positions"], kv_lens=d["kv_lens"],
                       page_table=d["page_table"], query_lens=d["valid"])
    steps = {
        # name: (input, pool pages, live slots of the hidden state, launches
        # per forward by wrapper, plain gather bound)
        "prefill": (prefill, p["num_pages"], p["live"],
                    {"grouped_matmul_pair": n_moe, "grouped_matmul": n_moe,
                     "write_kv_pages_decode_full": L}, p["live_pages"]),
        "decode": (decode, d["num_pages"], torch.arange(d["B"], device=dev) < d["n_live"],
                   {"grouped_matmul_pair": n_moe, "grouped_matmul": n_moe,
                    "write_kv_pages_decode_full": L,
                    "mla_decode_paged_attention_full": L}, d["live_pages"]),
    }
    cut = 4
    cfg4 = dataclasses.replace(cfg, num_layers=cut)
    params4 = cut_layers(params, cut, torch.bfloat16)
    params4_32 = cut_layers(params, cut, torch.float32)

    def rel(a: torch.Tensor, b: torch.Tensor) -> float:
        return ((a - b).norm() / b.norm()).item()

    for name, (inp, num_pages, live, per_forward, live_pages) in steps.items():
        shape = (L, num_pages, 1, page, cfg.kv_cache_entry_dim)
        pool = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)

        def run(prm, c, work, plain):
            ctx = plain_ops(live_pages) if plain else contextlib.nullcontext()
            with torch.inference_mode(), ctx:
                h, _ = llama.forward_hidden(prm, work, inp, c)
            return h.reshape(-1, h.shape[-1])[live].float()

        ops.reset_launch_counts()
        h_k = run(params, cfg, pool.clone(), plain=False)
        counts, branches = ops.launch_counts(), ops.branch_launch_counts()
        h_p = run(params, cfg, pool.clone(), plain=True)
        want = {fn: per_forward.get(fn, 0) for fn in counts}
        if counts != want or branches != {"write_kv_pages_decode_full[latent]": L}:
            raise AssertionError(f"{name} forward launched {counts} {branches}, want {want}, "
                                 f"every write in the latent branch")
        h4_k = run(params4, cfg4, pool[:cut].clone(), plain=False)
        h4_p = run(params4, cfg4, pool[:cut].clone(), plain=True)
        h4_k32 = run(params4_32, cfg4, pool[:cut].float(), plain=False)
        h4_ref = run(params4_32, cfg4, pool[:cut].float(), plain=True)
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: llama.forward_hidden(params, pool, inp, cfg), reps=3, warmup=1)
            with plain_ops(live_pages):
                fwd_plain_ms = cuda_ms(
                    lambda: llama.forward_hidden(params, pool, inp, cfg), reps=1, warmup=1)
        torch.cuda.synchronize()
        r = {
            "rows": inp.token_ids.shape[0], "Q": inp.token_ids.shape[1],
            "live_tokens": int(live.sum().item()), "layers": L, "launches": counts,
            "bf16_rel_err_27_layers": rel(h_k, h_p),
            "f32_rel_err_4_layers": rel(h4_k32, h4_ref),
            "bf16_kernels_vs_f32_4_layers": rel(h4_k, h4_ref),
            "bf16_plain_vs_f32_4_layers": rel(h4_p, h4_ref),
            "step_ms": fwd_ms, "step_plain_ms": fwd_plain_ms,
        }
        info[name] = r
        if not all(torch.isfinite(h).all() for h in (h_k, h_p, h4_k, h4_p, h4_k32, h4_ref)):
            raise AssertionError(f"deepseek {name} forward: non-finite hidden states")
        # f32: the paths differ in summation order only (attention, the
        # expert products, the combine), about 1e-6 relative per layer.
        if r["f32_rel_err_4_layers"] > 1e-3:
            raise AssertionError(f"deepseek {name} forward: f32 relative error {r['f32_rel_err_4_layers']}")
        # bf16: the kernels' run may be no further from the f32 run than 1.5
        # times the plain run's distance (a one-ulp difference grows through
        # the layers, so the two bf16 runs are not held to each other).
        if r["bf16_kernels_vs_f32_4_layers"] > 1.5 * r["bf16_plain_vs_f32_4_layers"]:
            raise AssertionError(
                f"deepseek {name} forward: bf16 kernels {r['bf16_kernels_vs_f32_4_layers']} from f32, "
                f"plain {r['bf16_plain_vs_f32_4_layers']} (limit 1.5x)")
        del pool, h_k, h_p, h4_k, h4_p, h4_k32, h4_ref
        torch.cuda.empty_cache()
    del params4, params4_32
    torch.cuda.empty_cache()


DS_LAYOUTS = {
    "default (bucketed unified step)": {},
    "split engine, decode_window 8": dict(unified_step=False, decode_window=8),
}


def ds_engine_phase(info: dict, params: dict, quantization: str | None = None,
                    async_scheduling: bool = False) -> tuple[dict, list]:
    """``LLMEngine`` serving deepseek-v2-lite (8 greedy requests, chunked
    prefill and a prefix-cache hit) in the layout ``info["layout"]`` names.
    MLA has no flat step, so the default engine runs the bucketed unified
    step. Every forward is logged with its Q: the pair and the down call
    of K6' must launch 26 times each a forward, K4''s latent form 27 times
    every forward (at any Q), K5' 27 times a Q = 1 forward (each window
    iteration is one), the GQA kernels never. Each
    step reads back once. Every decode-only step is a decode window, and
    every window a CUDA graph replay (``GraphWatch``: staging and replays
    under ``torch.cuda.set_sync_debug_mode("error")``, so a hidden device
    sync fails the run; the first replay held to its eager body);
    ``warmup`` must leave the pool as it was. ``quantization="int8"``
    runs int8 weights: the int8 kernels launch as ``q8_launches`` counts
    them, K6''s bf16 calls never. ``async_scheduling`` runs the two-slot
    pipeline, checked as ``engine_phase`` checks it. Returns the launch
    counts and the requests' tokens."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from llmd_tpu_torch.engine import LLMEngine, SamplingParams
    from llmd_tpu_torch.engine import runner as runner_mod
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(DS_MODEL, **({"quantization": quantization} if quantization else {}))
    layout = DS_LAYOUTS[info["layout"]]
    config = EngineConfig(
        model=cfg,
        cache=CacheConfig(page_size=16, num_blocks=2048, dtype="bfloat16"),
        scheduler=SchedulerConfig(max_num_seqs=64, max_num_batched_tokens=1024,
                                  async_scheduling=async_scheduling, **layout),
        seed=0,
    )
    eng = LLMEngine(config, params=params, device="cuda")
    info["async_scheduling"] = async_scheduling
    if eng.runner.flat:
        raise AssertionError("an MLA engine took the flat step")
    watch = GraphWatch(eng.runner)
    warm_engine(eng, info, watch, seed=19)
    forwards: list[int] = []  # Q of every eager forward
    k_steps: list[int] = []
    forward = runner_mod.llama.forward_hidden
    dispatch = eng.runner.dispatch_staged_decode

    def logged_forward(params, kv_cache, inp, c):
        if not watch.quiet:
            forwards.append(inp.token_ids.shape[1])
        return forward(params, kv_cache, inp, c)

    def logged_dispatch(staged):
        k_steps.append(staged.k)
        return dispatch(staged)

    runner_mod.llama.forward_hidden = logged_forward
    eng.runner.dispatch_staged_decode = logged_dispatch
    overlap = check_overlap(eng) if async_scheduling else None
    gen = torch.Generator().manual_seed(11)
    lengths = [16, 100, 300, 700, 1500, 64, 900]
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist() for n in lengths]
    sp = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True)
    tokens: dict[str, list[int]] = {}
    ttft: dict[str, float] = {}
    last: dict[str, float] = {}
    cached: dict[str, int] = {}
    window_ms: list[float] = []  # host ms per token of each step that is one decode window
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with counting_readbacks() as readbacks:
            for wave in (prompts, [prompts[3]]):
                tw = time.perf_counter()
                for p in wave:
                    tokens[eng.add_request(p, sp)] = []
                while eng.has_work():
                    ts, windows0 = time.perf_counter(), len(k_steps)
                    dispatches0 = eng.stats.step_dispatches_total
                    for out in eng.step():
                        tokens[out.request_id] += out.new_token_ids
                        ttft.setdefault(out.request_id, time.perf_counter() - tw)
                        last[out.request_id] = time.perf_counter() - tw
                        cached[out.request_id] = out.num_cached_tokens
                    if len(k_steps) > windows0 and eng.stats.step_dispatches_total == dispatches0 + 1:
                        window_ms.append((time.perf_counter() - ts) * 1e3 / k_steps[-1])
        torch.cuda.synchronize()
    finally:
        runner_mod.llama.forward_hidden = forward
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = eng.stats
    rids = list(tokens)
    tpot = [(last[r] - ttft[r]) / (len(tokens[r]) - 1) for r in rids]
    eager_decode_forwards = forwards.count(1)
    forwards += watch.forwards(flat=1, q1=1)
    decode_forwards = forwards.count(1)
    info.update(
        requests=len(rids), steps=st.engine_steps_total, wall_s=wall,
        output_tok_per_s=sum(len(t) for t in tokens.values()) / wall,
        ttft_median_s=statistics.median(ttft.values()), ttft_max_s=max(ttft.values()),
        tpot_median_ms=statistics.median(tpot) * 1e3,
        prefix_cached_tokens=cached[rids[-1]],
        step_dispatches=st.step_dispatches_total, decode_dispatches=st.decode_dispatches_total,
        unified_steps=st.unified_steps_total, readbacks=len(readbacks),
        forwards=len(forwards), q1_forwards=decode_forwards, decode_windows=len(k_steps),
        window_iterations=sum(k_steps), decode_ms_per_token_median=statistics.median(window_ms),
        graphs=watch.summary(), launches=counts, quantization=quantization,
    )
    # Every decode window was one graph replay, and no decode forward ran
    # outside one.
    if sum(watch.replays.values()) != len(k_steps) or eager_decode_forwards or watch.compared is None:
        raise AssertionError(f"{watch.replays} replays for {len(k_steps)} windows, "
                             f"{eager_decode_forwards} decode forwards outside a graph")
    check_replay_launches(eng.runner, cfg, False)
    if any(len(t) != 32 for t in tokens.values()):
        raise AssertionError(f"not every request produced 32 tokens: {[len(t) for t in tokens.values()]}")
    if cached[rids[-1]] <= 0:
        raise AssertionError("the repeated prompt did not hit the prefix cache")
    if len(readbacks) != st.engine_steps_total:
        raise AssertionError(f"{len(readbacks)} device->host copies in {st.engine_steps_total} steps")
    L, n_moe = cfg.num_layers, cfg.num_layers - cfg.first_dense_layers
    n_moe16 = 0 if quantization else n_moe
    want = {"write_kv_pages_flat_full": 0, "flat_paged_attention_full": 0,
            "write_kv_pages_decode_full": L * len(forwards),
            "decode_paged_attention_full": 0,
            "mla_decode_paged_attention_full": L * decode_forwards,
            "grouped_matmul_pair": n_moe16 * len(forwards),
            "grouped_matmul": n_moe16 * len(forwards),
            **q8_launches(cfg, len(forwards))}
    branches = ops.branch_launch_counts()
    info["branch_launches"] = branches
    if counts != want or branches != {"write_kv_pages_decode_full[latent]": L * len(forwards)}:
        raise AssertionError(f"launch counts {counts} {branches}, want {want}, every write "
                             "in the latent branch")
    if "decode_window" in layout and 8 not in k_steps:
        raise AssertionError(f"no decode window ran 8 iterations: {k_steps}")
    if not layout and st.unified_steps_total == 0:
        raise AssertionError("the default MLA engine ran no bucketed unified step")
    if async_scheduling:
        check_async_end(info, eng, overlap)
    del eng, watch
    return counts, [tokens[r] for r in rids]


def compare_greedy(info: dict, got: list, want: list, gate: bool) -> None:
    """The int8 pool's greedy tokens beside the bf16 pool's, request by
    request: the leading tokens both agree on, and the share of all tokens
    before the first disagreement. Quantizing K|V perturbs the logits, so
    the streams may part; with ``gate`` the check is that most requests (5
    of 8) agree on their first 4 tokens, not that they are equal.
    ``first_token_witness`` shows where a first token parts, and why."""
    lead = []
    for a, b in zip(got, want):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        lead.append(n)
    info.update(agreeing_leading_tokens=lead,
                agreeing_share=sum(lead) / sum(len(b) for b in want))
    if gate and sum(n >= 4 for n in lead) < 5:
        raise AssertionError(f"int8 pool's greedy tokens part from the bf16 pool's early: {lead}")


def first_token_witness(info: dict, params: dict, model: str, engine_int8: list,
                        engine_bf16: list) -> None:
    """Each engine prompt's first greedy token from one flat prefill of
    all 7 prompts, on a bf16 pool through the kernels, and on an int8 pool
    through the kernels and through the plain versions. The int8 kernels
    must pick the plain int8 path's token wherever that path's top-1 /
    top-2 logit gap is wider than the two paths' largest logit difference
    for that prompt (their summation orders differ, so a narrower gap is a
    tie). Reports, per prompt, the tokens, the gaps and the bf16 pool's
    margin over the int8 pool's token: where the int8 pool's first token
    parts from the bf16 pool's, that margin says how close the bf16 pool
    was to choosing it."""
    import itertools

    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.common import StepInput
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(model)
    dev, page = torch.device("cuda"), 16
    prompts = engine_prompts(cfg)
    lens = [len(p) for p in prompts]
    s = mixed_step(cfg, page, -(-cfg.max_model_len // page), [(0, n) for n in lens], [],
                   torch.Generator().manual_seed(5), dev)
    ids = torch.zeros(s["T"], dtype=torch.long)
    ids[: s["total"]] = torch.tensor(sum(prompts, []))
    inp = StepInput(token_ids=ids[:, None].to(dev), positions=s["positions"][:, None],
                    kv_lens=s["kv_lens"], page_table=s["page_table"], token_rows=s["rows"],
                    num_live=s["num_live"])
    last = torch.tensor([n - 1 for n in itertools.accumulate(lens)], device=dev)
    shape = (cfg.num_layers, s["num_pages"], cfg.num_kv_heads, page, 2 * cfg.head_dim)

    def logits(int8: bool, plain: bool) -> torch.Tensor:
        pool = ((torch.zeros(shape, dtype=torch.int8, device=dev),
                 torch.ones((*shape[:4], 2), device=dev)) if int8 else
                torch.zeros(shape, dtype=torch.bfloat16, device=dev))
        with torch.inference_mode(), plain_ops() if plain else contextlib.nullcontext():
            h, _ = llama.forward_hidden(params, pool, inp, cfg)
            return llama.compute_logits(params, h.reshape(-1, h.shape[-1])[last], cfg)

    bf16, int8, int8_plain = logits(False, False), logits(True, False), logits(True, True)
    tok = {k: v.argmax(-1) for k, v in (("bf16", bf16), ("int8", int8), ("int8_plain", int8_plain))}
    top2 = int8_plain.topk(2, dim=-1).values
    gap_plain = top2[:, 0] - top2[:, 1]
    noise = (int8 - int8_plain).abs().amax(-1)
    bf16_top2 = bf16.topk(2, dim=-1).values
    bf16_margin = bf16_top2[:, 0] - bf16.gather(1, tok["int8"][:, None])[:, 0]
    w = {
        "prompt_tokens": lens,
        "first_token_bf16": tok["bf16"].tolist(), "first_token_int8": tok["int8"].tolist(),
        "first_token_int8_plain": tok["int8_plain"].tolist(),
        "int8_plain_top2_gap": gap_plain.tolist(), "int8_kernels_vs_plain_max_logit_diff": noise.tolist(),
        "bf16_top2_gap": (bf16_top2[:, 0] - bf16_top2[:, 1]).tolist(),
        "bf16_margin_over_int8_token": bf16_margin.tolist(),
        # The engine chunks the 1,500-token prompt and batches the prompts
        # otherwise, so its first tokens may differ from this one step's
        # at a near-tie.
        "engine_int8_first_equal": [a[0] == b for a, b in zip(engine_int8, tok["int8"].tolist())],
        "engine_bf16_first_equal": [a[0] == b for a, b in zip(engine_bf16, tok["bf16"].tolist())],
    }
    info["first_token_witness"] = w
    bad = [i for i in range(len(lens))
           if tok["int8"][i] != tok["int8_plain"][i] and gap_plain[i] > 2 * noise[i]]
    if bad:
        raise AssertionError(f"{model}: int8 kernels' first tokens part from the plain int8 path's "
                             f"at prompts {bad}: {w}")


OSS_MODEL = "gpt-oss-20b"
ATTN_SOURCES = {
    "flat": ("llmd_tpu_torch/ops/csrc/flat_paged_attention.cu",
             "llmd_tpu/ops/ragged_paged_attention.py:344"),
    "decode": ("llmd_tpu_torch/ops/csrc/decode_paged_attention.cu",
               "llmd_tpu/ops/ragged_paged_attention.py:463"),
}


def attention_branch_case(kind: str, q, data, scales, layer, step, page, window, sinks) -> dict:
    """One branch of K1' (``kind`` "flat", on a mixed flat step) or K3'
    ("decode", on a decode batch) held to its plain version within one
    bf16 ulp (pad rows exactly zero) and timed beside its bound, the plain
    version and SDPA on the dense gather (the window in the mask, the sink
    as a zero key whose bias is its logit, an int8 pool dequantized
    first). The bound counts each row's live, in-window positions once: K|V
    in the pool's bytes (int8: half of bf16, plus 8 bytes of scales a
    position and head), q read and the output written."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.ops.ragged_paged_attention import branch_key

    T, _, H, D = q.shape
    K = data.shape[2]
    kw = dict(window=window, sinks=sinks, scales=scales)
    plan = attention_plan(kind, step, H, data.shape[2], page, window)
    if kind == "flat":
        args = (q, data, layer, step["rows"], step["page_table"], step["kv_lens"])
        kernel = lambda: ops.flat_paged_attention_full(*args, **kw, items=plan["tiles"])  # noqa: E731
        plain = lambda: ops.flat_paged_attention_plain(*args, **kw)  # noqa: E731
        rows_spec, n_live, dead = step["rows_spec"], step["total"], slice(step["total"], None)
        plain_reps = 10
    else:
        args = (q, data, layer, step["page_table"], step["kv_lens"])
        kernel = lambda: ops.decode_paged_attention_full(*args, **kw)  # noqa: E731
        plain = lambda: ops.decode_paged_attention_plain(  # noqa: E731
            *args, live_pages=step["live_pages"], **kw)
        rows_spec = [(c - 1, 1) for c in step["ctx"]]
        n_live, dead = step["n_live"], slice(step["n_live"], None)
        plain_reps = 5
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, bad = outside_one_ulp(got[:n_live], want[:n_live])
    key = branch_key(window, sinks, scales)
    if bad:
        raise AssertionError(f"{kind}_paged_attention[{key}]: max abs err {err} vs plain")
    if got[dead].any():
        raise AssertionError(f"{kind}_paged_attention[{key}]: a pad row is not zero")
    del got, want
    # Needed positions per row: [first query's window start, last kv_len).
    positions = flops_pos = 0
    for p0, w in rows_spec:
        lo = max(p0 + 1 - window, 0) if window else 0
        positions += p0 + w - lo
        flops_pos += sum(p - max(p + 1 - window, 0) + 1 if window else p + 1
                         for p in range(p0, p0 + w))
    per_pos = K * 2 * D * data.element_size() + (K * 8 if scales is not None else 0)
    b_ms, b_by = bound(positions * per_pos + 2 * n_live * H * D * q.element_size(),
                       4.0 * H * D * flops_pos)
    pool_f = (data if scales is None else
              ops.dequantize_pages(data[layer], scales[layer], q.dtype)[None])
    lay = layer if scales is None else 0
    spec = {"rows_spec": rows_spec, "page_table": step["page_table"]}
    lib_ms = _sdpa_yardstick(q[:n_live] if kind == "decode" else q, pool_f, lay, spec, page,
                             window, sinks, max_q=None if sinks is None else 64)
    del pool_f
    source, replaces = ATTN_SOURCES[kind]
    times = kernel_times(kernel)
    ms = times["ms"]
    return {
        "name": f"{kind}_paged_attention[{key}]", "route": "cuda", "source": source,
        "replaces": replaces, "max_abs_err": err,
        **times, "plain_ms": cuda_ms(plain, reps=plain_reps, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "bound_share": b_ms / ms, "items": plan["items"], "spans": plan["spans"],
        "wrapper": f"{kind}_paged_attention_full", "branch": key,
    }


def random_int8_pool(shape, g, dev):
    """An int8 pool (data, f32 scales on the f16 grid) of random rows whose
    dequantized values are about unit size."""
    data = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    scales = torch.empty((*shape[:4], 2), device=dev).uniform_(0.004, 0.016, generator=g)
    return data, scales.half().float()


def oss_kernels_phase(info: dict) -> dict:
    """The window, sink and int8 branches of K1'-K4' on the card, each held
    to its plain version and timed beside its bound, the plain version and
    a library call. gpt-oss-20b shapes (H 64, K 8, D 64, page 16, a
    24-layer pool): K1' on one mixed flat step (3 prefill chunks and 32
    decode rows at 1k-4k context) and K3' on a decode step (bucket 64: 48
    live rows at 1k-4k, 16 pad rows), on a sliding layer (window 128 and
    sinks) and a full layer (sinks), on a bf16 and on an int8 pool, with
    K2' and K4' in their fused form (bias, rope and store) on both pools at
    head_dim 64 with the model's q|k|v biases. llama-3-8b shapes (32-layer
    pool, head_dim 128): K1', K2', K3' and K4' on an int8 pool."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.models.registry import get_model_config

    dev, dt, page = torch.device("cuda"), torch.bfloat16, 16
    gen = torch.Generator().manual_seed(4040)
    g = torch.Generator(device=dev).manual_seed(41)
    out = {}
    for model, cases in ((OSS_MODEL, ("bf16", "int8")), (MODEL, ("int8",))):
        cfg = get_model_config(model)
        L, K, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
        max_pages = -(-cfg.max_model_len // page)
        decode_ctx = torch.randint(1024, 4097, (32,), generator=gen).tolist()
        flat = mixed_step(cfg, page, max_pages, [(0, 512), (1024, 256), (2000, 128)],
                          decode_ctx, gen, dev)
        dec = decode_batch(cfg, page, 1024, 4096, gen, dev)
        sinks = (torch.randn((H,), generator=g, device=dev) if cfg.attention_sinks else None)
        layers = [(0, cfg.layer_windows[0]), (1, cfg.layer_windows[1])] if cfg.sliding_window else [(L // 2, 0)]
        for pool_kind in cases:
            for kind, step in (("flat", flat), ("decode", dec)):
                shape = (L, step["num_pages"], K, page, 2 * D)
                if pool_kind == "int8":
                    data, scales = random_int8_pool(shape, g, dev)
                else:
                    data, scales = torch.randn(shape, generator=g, device=dev, dtype=dt), None
                rows = step["T"] if kind == "flat" else step["B"]
                q = torch.randn((rows, 1, H, D), generator=g, device=dev, dtype=dt)
                for layer, window in layers:
                    e = attention_branch_case(kind, q, data, scales, layer, step, page, window, sinks)
                    e["model"] = model
                    out[e["name"]] = e
                # The fused writes: an int8 pool at both models' shapes, a
                # bf16 pool at gpt-oss-20b's with its q|k|v biases
                # (llama-3-8b's bf16 rows are in the kernels and
                # decode_kernels phases).
                key = ops.write_branch(scales is not None, rope=True, bias=cfg.attention_bias)
                name = f"{kind}_kv_write[{key}]" + ("" if model == MODEL else f"@{model}")
                out[name] = rope_write_case(name, kind, cfg, data, scales, L // 2, step,
                                            cfg.attention_bias, g)
                del data, scales, q
                torch.cuda.empty_cache()
    for name, e in out.items():
        info[name] = {k: e[k] for k in ("model", "bound_by", "items", "spans") + WRITE_KEYS
                      if k in e}
    return out


def fill_biases(params: dict, seed: int) -> None:
    """Small seeded values in the bias leaves the init leaves at zero
    (q|k|v, o, router, experts), so that their branches do work."""
    layers = params["layers"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    for name in ("bq", "bk", "bv", "bo", "router_bias", "we_gate_b", "we_up_b", "we_down_b"):
        w = layers[name]
        w.copy_(torch.randn(w.shape, generator=g, device="cuda", dtype=torch.float32) * 0.02)


def oss_forward_phase(info: dict, params: dict) -> None:
    """gpt-oss-20b at full width: one mixed flat step (K1', K2', K6') and
    one Q = 1 decode forward (K3', K4', K6') of the 24-layer model through
    the kernels and the plain versions, each layer in its branches
    (sliding layers window 128 and sinks, full layers sinks), on a bf16 and
    on an int8 pool; layer 0's written pool bytes (and scales) must equal
    the plain version's. An f32 copy
    of 24 layers does not fit beside the bf16 weights, so the f32
    reference runs the first 4 layers (2 sliding, 2 full) at full width."""
    import dataclasses

    from llmd_tpu_torch import ops
    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.common import StepInput
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(OSS_MODEL)
    dev, page, L = torch.device("cuda"), 16, cfg.num_layers
    gen = torch.Generator().manual_seed(23)
    g = torch.Generator(device=dev).manual_seed(29)
    decode_ctx = torch.randint(200, 1001, (16,), generator=gen).tolist()
    s = mixed_step(cfg, page, -(-cfg.max_model_len // page), [(0, 300), (600, 200)],
                   decode_ctx, gen, dev)
    live = torch.arange(s["T"], device=dev) < s["total"]
    ids = torch.randint(0, cfg.vocab_size, (s["T"],), generator=g, device=dev)
    flat_inp = StepInput(token_ids=torch.where(live, ids, 0)[:, None],
                         positions=s["positions"][:, None], kv_lens=s["kv_lens"],
                         page_table=s["page_table"], token_rows=s["rows"], num_live=s["num_live"])
    d = decode_batch(cfg, page, 128, 640, gen, dev)
    ids = torch.randint(0, cfg.vocab_size, (d["B"], 1), generator=g, device=dev)
    decode_inp = StepInput(token_ids=torch.where(d["valid"][:, None] > 0, ids, 0),
                           positions=d["positions"], kv_lens=d["kv_lens"],
                           page_table=d["page_table"], query_lens=d["valid"])
    per_forward = L  # K6': the gate|up pair and the down call, each once a MoE layer
    steps = {
        # name: (input, pool pages, live slots, launches per forward, gather bound)
        "flat": (flat_inp, s["num_pages"], live,
                 {"write_kv_pages_flat_full": L, "flat_paged_attention_full": L,
                  "grouped_matmul_pair": per_forward, "grouped_matmul": per_forward},
                 None, (1, 0)),
        "decode": (decode_inp, d["num_pages"], torch.arange(d["B"], device=dev) < d["n_live"],
                   {"write_kv_pages_decode_full": L, "decode_paged_attention_full": L,
                    "grouped_matmul_pair": per_forward, "grouped_matmul": per_forward},
                   d["live_pages"], (0, 1)),
    }
    cut = 4
    cfg4 = dataclasses.replace(cfg, num_layers=cut, layer_types=cfg.layer_types[:cut])
    params4 = cut_layers(params, cut, torch.bfloat16)
    params4_32 = cut_layers(params, cut, torch.float32)

    def rel(a: torch.Tensor, b: torch.Tensor) -> float:
        return ((a - b).norm() / b.norm()).item()

    def cut_pool(pool, n: int | None = None, f32: bool = False):
        """A fresh copy of the pool's first ``n`` layers (all if None); a
        bf16 pool upcast to f32 with ``f32``. The int8 pair stays int8."""
        if isinstance(pool, tuple):
            return tuple(t[:n].clone() for t in pool)
        return pool[:n].float() if f32 else pool[:n].clone()

    def layer0(pool) -> tuple:
        return tuple(t[0].clone() for t in pool) if isinstance(pool, tuple) else (pool[0].clone(),)

    for name, (inp, num_pages, live_slots, per_fw, live_pages, (nf, nq)) in steps.items():
        shape = (L, num_pages, cfg.num_kv_heads, page, 2 * cfg.head_dim)
        for int8 in (False, True):
            pool = (random_int8_pool(shape, g, dev) if int8 else
                    torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16))

            def run(prm, c, work, plain):
                """One forward writing into ``work``; returns the live
                hidden states in f32 and the written pool."""
                ctx = plain_ops(live_pages) if plain else contextlib.nullcontext()
                with torch.inference_mode(), ctx:
                    h, _ = llama.forward_hidden(prm, work, inp, c)
                return h.reshape(-1, h.shape[-1])[live_slots].float(), work

            ops.reset_launch_counts()
            h_k, work = run(params, cfg, cut_pool(pool), plain=False)
            counts, branches = ops.launch_counts(), ops.branch_launch_counts()
            pool0_k = layer0(work)
            h_p, work = run(params, cfg, cut_pool(pool), plain=True)
            pool0_p = layer0(work)
            del work
            want = {fn: per_fw.get(fn, 0) for fn in counts}
            if counts != want:
                raise AssertionError(f"gpt-oss {name} forward launched {counts}, want {want}")
            want_b = expected_branches(cfg, nf, nq, int8)
            if branches != want_b:
                raise AssertionError(f"gpt-oss {name} forward branches {branches}, want {want_b}")
            h4_k, _ = run(params4, cfg4, cut_pool(pool, cut), plain=False)
            h4_p, _ = run(params4, cfg4, cut_pool(pool, cut), plain=True)
            h4_k32, w4_k = run(params4_32, cfg4, cut_pool(pool, cut, f32=True), plain=False)
            h4_ref, w4_p = run(params4_32, cfg4, cut_pool(pool, cut, f32=True), plain=True)
            with torch.inference_mode():
                fwd_ms = cuda_ms(lambda: llama.forward_hidden(params, pool, inp, cfg), reps=3, warmup=1)
                with plain_ops(live_pages):
                    fwd_plain_ms = cuda_ms(
                        lambda: llama.forward_hidden(params, pool, inp, cfg), reps=1, warmup=1)
            torch.cuda.synchronize()
            r = {
                "kv_cache_dtype": "int8" if int8 else "bfloat16",
                "rows": inp.token_ids.shape[0], "live_tokens": int(live_slots.sum().item()),
                "layers": L, "launches": counts, "branch_launches": branches,
                "layer0_pool_equal": all(torch.equal(a, b) for a, b in zip(pool0_k, pool0_p)),
                "bf16_rel_err_24_layers": rel(h_k, h_p),
                "f32_rel_err_4_layers": rel(h4_k32, h4_ref),
                "bf16_kernels_vs_f32_4_layers": rel(h4_k, h4_ref),
                "bf16_plain_vs_f32_4_layers": rel(h4_p, h4_ref),
                "step_ms": fwd_ms, "step_plain_ms": fwd_plain_ms,
            }
            tag = f"{name}_int8" if int8 else name
            info[tag] = r
            if int8:
                # The 4-layer f32 runs on the int8 pool: how far their
                # written int8 rows and scales, and each token's hidden
                # state, are apart.
                step = (w4_k[0].int() - w4_p[0].int()).abs().flatten(1)
                tok = (h4_k32 - h4_ref).norm(dim=-1) / h4_ref.norm(dim=-1)
                r.update(
                    f32_int8_written_elements_per_layer=(
                        r["live_tokens"] * cfg.num_kv_heads * 2 * cfg.head_dim),
                    f32_int8_elements_differing_per_layer=(step > 0).sum(1).tolist(),
                    f32_int8_max_step_per_layer=step.amax(1).tolist(),
                    f32_scales_differing_per_layer=(w4_k[1] != w4_p[1]).flatten(1).sum(1).tolist(),
                    f32_token_rel_err_median=tok.median().item(),
                    f32_token_rel_err_max=tok.max().item(),
                    f32_tokens_over_1e_3=int((tok > 1e-3).sum().item()),
                )
            del w4_k, w4_p
            if not all(torch.isfinite(h).all() for h in (h_k, h_p, h4_k, h4_p, h4_k32, h4_ref)):
                raise AssertionError(f"gpt-oss {tag} forward: non-finite hidden states")
            # Layer 0 writes K|V computed from the same inputs on both paths:
            # the kernel's pool bytes (and an int8 pool's scales) must equal
            # the plain version's.
            if not r["layer0_pool_equal"]:
                raise AssertionError(f"gpt-oss {tag} forward: layer-0 pool bytes differ between the paths")
            # f32: the paths differ in summation order only (attention, the
            # expert products, the combine), about 1e-6 relative per layer.
            # On the int8 pool that difference moves a value across a
            # rounding boundary now and then from layer 1 on: the element is
            # stored one quantization step (1/127 of its row's amax) apart,
            # every later token of the row attends to it, and a token whose
            # router sat at a near-tie picks another expert, so the hidden
            # states part by more each layer (reported, not gated). What
            # holds the kernels to plain there: layer 0's rows and scales
            # are equal, and layer 1's rows, computed from layer 0's int8
            # attention, differ only by such flips: one step, in at most a
            # thousandth of the elements.
            if int8:
                steps = r["f32_int8_max_step_per_layer"]
                flips = r["f32_int8_elements_differing_per_layer"][1]
                if (steps[0] != 0 or r["f32_scales_differing_per_layer"][0] or steps[1] > 1
                        or flips > 1e-3 * r["f32_int8_written_elements_per_layer"]):
                    raise AssertionError(
                        f"gpt-oss {tag} forward: written int8 rows of layers 0/1 differ by "
                        f"{steps[:2]} quantization steps in {flips} elements of layer 1")
            elif r["f32_rel_err_4_layers"] > 1e-3:
                raise AssertionError(f"gpt-oss {tag} forward: f32 relative error {r['f32_rel_err_4_layers']}")
            # bf16: the kernels' run may be no further from the f32 run than
            # 1.5 times the plain run's distance.
            if r["bf16_kernels_vs_f32_4_layers"] > 1.5 * r["bf16_plain_vs_f32_4_layers"]:
                raise AssertionError(
                    f"gpt-oss {tag} forward: bf16 kernels {r['bf16_kernels_vs_f32_4_layers']} from f32, "
                    f"plain {r['bf16_plain_vs_f32_4_layers']} (limit 1.5x)")
            del pool, pool0_k, pool0_p, h_k, h_p, h4_k, h4_p, h4_k32, h4_ref
            torch.cuda.empty_cache()
    del params4, params4_32
    torch.cuda.empty_cache()


OSS_LAYOUTS = (("flat step", "bfloat16"), ("split engine, decode_window 8", "bfloat16"),
               ("flat step, decode_window 8", "int8"))


def ring_copy(pool, pt, lens, R: int, page: int):
    """The ring pool and ring-view table a ring engine would hold for rows
    of ``lens`` tokens written through ``pt`` (layer 0 of ``pool``, a
    tensor or the int8 pair): row r's ring is R pages of its own, and
    logical page l lands at ``ring[l % R]``; the latest R pages are the
    ones a ring holds."""
    B, dev = pt.shape[0], pt.device
    ring_pt = (torch.arange(B, device=dev)[:, None] * R
               + torch.arange(pt.shape[1], device=dev)[None] % R).to(pt.dtype)
    parts = [torch.zeros((1, B * R, *t.shape[2:]), dtype=t.dtype, device=dev)
             for t in pool_parts(pool)]
    for r in range(B):
        n = -(-int(lens[r]) // page)
        for lp in range(max(0, n - R), n):
            for dst, src in zip(parts, pool_parts(pool)):
                dst[0, r * R + lp % R] = src[0, pt[r, lp]]
    return (tuple(parts) if isinstance(pool, tuple) else parts[0]), ring_pt


def ring_kernels_phase(info: dict) -> None:
    """K1' on the mixed flat step and K3' on the decode step at gpt-oss-20b
    shapes, window 128 with sinks, on a bf16 and an int8 pool: the call
    through a ring pool (each row's latest R pages at ``ring[l % R]``) and
    its ring-view table gives the same bits as the call through the full
    table. R covers a row's window and its chunk, as ``SwaRingSpec``
    sizes it."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.models.registry import get_model_config

    dev, page = torch.device("cuda"), 16
    cfg = get_model_config(OSS_MODEL)
    K, H, D, window = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim, cfg.sliding_window
    gen = torch.Generator().manual_seed(909)
    g = torch.Generator(device=dev).manual_seed(91)
    max_pages = -(-cfg.max_model_len // page)
    decode_ctx = torch.randint(1024, 4097, (32,), generator=gen).tolist()
    flat = mixed_step(cfg, page, max_pages, [(0, 512), (1024, 256), (2000, 128)], decode_ctx, gen, dev)
    dec = decode_batch(cfg, page, 1024, 4096, gen, dev)
    sinks = torch.randn((H,), generator=g, device=dev)
    for kind, step in (("flat", flat), ("decode", dec)):
        if kind == "flat":
            lens = [p0 + w for p0, w in step["rows_spec"]]
            R = -(-(window + max(w for _, w in step["rows_spec"])) // page) + 1
            rows = step["T"]
        else:
            lens = step["ctx"] + [0] * (step["B"] - step["n_live"])
            R = -(-(window + 1) // page) + 1
            rows = step["B"]
        q = torch.randn((rows, 1, H, D), generator=g, device=dev, dtype=torch.bfloat16)
        for pool_kind in ("bf16", "int8"):
            shape = (1, step["num_pages"], K, page, 2 * D)
            pool = (random_int8_pool(shape, g, dev) if pool_kind == "int8"
                    else torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16))
            ring, ring_pt = ring_copy(pool, step["page_table"], lens, R, page)
            outs = []
            for pl, pt in ((pool, step["page_table"]), (ring, ring_pt)):
                data, scales = pl if isinstance(pl, tuple) else (pl, None)
                if kind == "flat":
                    outs.append(ops.flat_paged_attention_full(
                        q, data, 0, step["rows"], pt, step["kv_lens"], None, window, sinks, scales))
                else:
                    outs.append(ops.decode_paged_attention_full(
                        q, data, 0, pt, step["kv_lens"], None, window, sinks, scales))
            torch.cuda.synchronize()
            equal = torch.equal(*outs)
            info[f"{kind}[{pool_kind}+window+sinks]"] = {"ring_pages": R, "bit_equal": equal}
            if not equal:
                diff = (outs[0].float() - outs[1].float()).abs().max().item()
                raise AssertionError(f"{kind} attention through the ring table differs: {diff}")
            del pool, ring, outs
    torch.cuda.empty_cache()


def ring_engine_phases(params: dict, layout: str, kv_dtype: str) -> list:
    """gpt-oss-20b's engine in ``layout`` on ``ring_prompts`` (the engine
    phases' 8 requests and one of 8,192 tokens), without the ring and then
    with it, each an ``engine_phase`` (warmup, graph replays held to their
    eager bodies, launches a kernel branch). The ring run's tokens and
    logprobs must equal the no-ring run's: both schedule alike (the chunk
    cap is the budget) and the kernels read the same logical pages.
    Returns the ring run's tokens."""
    from llmd_tpu_torch.models.registry import get_model_config

    prompts = ring_prompts(get_model_config(OSS_MODEL))
    runs = {}
    for ring in (False, True):
        with phase("engine", {"model": OSS_MODEL, "layout": layout, "kv_cache_dtype": kv_dtype,
                              "kv_swa_ring": ring, "prompts": len(prompts) + 1}) as info:
            _, _, tokens, logprobs = engine_phase(info, params, OSS_MODEL, kv_dtype,
                                                  prompts=prompts, swa_ring=ring)
            runs[ring] = (tokens, logprobs, info["kv_bytes"])
            if ring:
                info.update(tokens_equal_no_ring=tokens == runs[False][0],
                            logprobs_equal_no_ring=logprobs == runs[False][1],
                            kv_bytes_no_ring=runs[False][2])
                if not (info["tokens_equal_no_ring"] and info["logprobs_equal_no_ring"]):
                    compare_greedy(info, tokens, runs[False][0], gate=False)
                    raise AssertionError(f"the ring engine's stream differs from the no-ring engine's: "
                                         f"{info['agreeing_leading_tokens']}")
        gc.collect()
        torch.cuda.empty_cache()
    return runs[True][0]


def hybrid_prefix_phase(info: dict, params: dict) -> None:
    """A 4,096-token prompt, then the same prompt again, on gpt-oss-20b's
    ring engine and on its engine without the ring (flat step). The ring
    engine's repeat must seed its ring from the section it retained (one
    hit, n_pre = 255 pages skipped: 4,080 tokens); the no-ring engine's
    repeat takes the same 255 pages from its prefix cache, so both repeats
    prefill the same last 16 tokens: their tokens and logprobs must be
    equal, as must the two cold runs'. A repeat's bf16 arithmetic (a
    16-token chunk) is not the cold run's (1,024-token chunks), so whether
    a repeat's tokens equal its cold run's is reported."""
    from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from llmd_tpu_torch.engine import LLMEngine, SamplingParams
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(OSS_MODEL)
    prompt = torch.randint(3, cfg.vocab_size, (4096,), generator=torch.Generator().manual_seed(13)).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True, logprobs=True)
    runs = {}
    for ring in (False, True):
        eng = LLMEngine(EngineConfig(
            model=cfg, cache=CacheConfig(page_size=16, num_blocks=2048, swa_ring=ring),
            scheduler=SchedulerConfig(max_num_seqs=64, max_num_batched_tokens=1024), seed=0,
        ), params=params, device="cuda")
        out = []
        for _ in range(2):
            rid = eng.add_request(prompt, sp)
            req = next(r for r in eng.scheduler.waiting if r.request_id == rid)
            t0 = time.perf_counter()
            while eng.has_work():
                eng.step()
            torch.cuda.synchronize()
            out.append((req.output_token_ids, req.output_logprobs, req.num_cached_tokens,
                        time.perf_counter() - t0))
        runs[ring] = out
        name = "ring" if ring else "no_ring"
        info[name] = {"cached_tokens": [o[2] for o in out], "seconds": [o[3] for o in out],
                      "repeat_tokens_equal_cold": out[1][0] == out[0][0],
                      "kv_bytes": eng.runner.kv_bytes()}
        if ring:
            st = eng.stats
            n_pre = eng.runner.swa.section(len(prompt), 16)[0]
            info[name].update(swa_section_hits=st.swa_section_hits,
                              swa_section_captures=st.swa_section_captures, n_pre=n_pre)
            if st.swa_section_hits != 1 or st.swa_section_captures < 1 or out[1][2] != n_pre * 16:
                raise AssertionError(f"hybrid hit: {info[name]}")
            info[name]["metrics"] = ring_metrics(eng)
        elif out[1][2] != 4080:
            raise AssertionError(f"the no-ring repeat cached {out[1][2]} tokens, not 4,080")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    for i, what in enumerate(("cold", "repeat")):
        equal = runs[True][i][:2] == runs[False][i][:2]
        info[f"{what}_ring_equals_no_ring"] = equal
        if not equal:
            raise AssertionError(f"the ring engine's {what} run differs from the no-ring engine's")


def ring_metrics(eng) -> dict:
    """The ring engine's /metrics page (``render_metrics``): it carries the
    ring's series, and ``gpu_cache_usage_perc`` is the binding pool's
    usage, the larger of the main pool's and the ring pool's."""
    from llmd_tpu_torch.serve.metrics import parse_prometheus, render_metrics

    page = parse_prometheus(render_metrics(eng.stats, OSS_MODEL))
    got = {k: page.get(f"vllm:{k}") for k in ("swa_ring_usage_perc", "kv_main_usage_perc",
                                               "gpu_cache_usage_perc", "swa_ring_pages")}
    if None in got.values():
        raise AssertionError(f"the ring engine's page lacks a ring series: {got}")
    want = round(max(eng.allocator.usage(), eng.swa_allocator.usage()), 6)
    if got["gpu_cache_usage_perc"] != want or got["swa_ring_usage_perc"] <= 0:
        raise AssertionError(f"gpu_cache_usage_perc {got}, want the larger pool's {want}")
    return got


def capacity_phase(info: dict, params: dict) -> None:
    """Sequences decoding at once at equal KV bytes: 12 requests of 16,384
    prompt and 128 output tokens (greedy), max_num_seqs 16, budget 1,024,
    page 16, on gpt-oss-20b's flat step. Without the ring: 4,160 pages of
    24 layers (3.27 GB, room for 4 such sequences). With it: the same
    bytes as 16 rings of 73 pages plus the sections' 72, 12 layers, and a
    12-layer main pool of the rest (7,080 pages: room for 6). A sequence
    decodes 128 steps while later prompts prefill 16 steps each, so the
    pool, not the schedule, caps the sequences decoding at once. Gates:
    the two engines' KV bytes equal, and more sequences decoding at once
    with the ring. Streams are reported, not gated: preemption recomputes
    with other batches."""
    from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig, swa_ring_spec
    from llmd_tpu_torch.engine import LLMEngine, SamplingParams
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(OSS_MODEL)
    sched = SchedulerConfig(max_num_seqs=16, max_num_batched_tokens=1024)
    spec = swa_ring_spec(cfg, CacheConfig(page_size=16, swa_ring=True), sched)
    rings = sched.max_num_seqs * spec.ring_pages
    retention = 8 * spec.max_section_pages(16)
    full, swa = len(spec.full_layers), len(spec.swa_layers)
    main_pages = (4160 * cfg.num_layers - (rings + retention) * swa) // full
    gen = torch.Generator().manual_seed(14)
    prompts = [torch.randint(3, cfg.vocab_size, (16384,), generator=gen).tolist() for _ in range(12)]
    sp = SamplingParams(temperature=0.0, max_tokens=128, ignore_eos=True)
    res = {}
    for ring in (False, True):
        cache = (CacheConfig(page_size=16, num_blocks=main_pages, swa_ring=True, swa_blocks=rings)
                 if ring else CacheConfig(page_size=16, num_blocks=4160))
        eng = LLMEngine(EngineConfig(model=cfg, cache=cache, scheduler=sched, seed=0),
                        params=params, device="cuda")
        decoding = []
        schedule = eng.scheduler.schedule

        def logged_schedule():
            batch = schedule()
            decoding.append(len(batch.decodes))
            return batch

        eng.scheduler.schedule = logged_schedule
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = eng.generate(prompts, sp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out_tokens = sum(len(t) for t in toks.values())
        res[ring] = list(toks.values())
        entry = {"num_blocks": cache.num_blocks, "kv_bytes": eng.runner.kv_bytes(),
                 "max_decoding_at_once": max(decoding), "preemptions": eng.scheduler.num_preemptions,
                 "steps": eng.stats.engine_steps_total, "wall_s": wall,
                 "output_tok_per_s": out_tokens / wall, "output_tokens": out_tokens}
        if ring:
            entry.update(swa_ring_pages=eng.stats.swa_ring_pages, ring_pages_per_seq=spec.ring_pages)
        info["ring" if ring else "no_ring"] = entry
        if out_tokens != 12 * 128:
            raise AssertionError(f"{out_tokens} output tokens, want {12 * 128}")
        del eng, toks
        gc.collect()
        torch.cuda.empty_cache()
    compare_greedy(info, res[True], res[False], gate=False)
    a, b = info["ring"], info["no_ring"]
    if a["kv_bytes"] != b["kv_bytes"]:
        raise AssertionError(f"KV bytes {a['kv_bytes']} with the ring, {b['kv_bytes']} without")
    if a["max_decoding_at_once"] <= b["max_decoding_at_once"]:
        raise AssertionError(f"{a['max_decoding_at_once']} sequences decoding at once with the ring, "
                             f"{b['max_decoding_at_once']} without")


QWEN_MODEL = "qwen3-32b"
# The in-process qwen3-32b engines' pool: 1,024 pages (4.3 GB). Beside the
# 65.5 GB tree the engine checks (``warm_engine``, ``GraphWatch``) hold up
# to three copies of the pool at once, which 2,048 pages (8.6 GB) would
# not fit on an 80 GB card; the qwen3-32b server keeps the default 2,048.
QWEN_BLOCKS = 1024


def qwen_kernels_phase(info: dict) -> dict:
    """K1'-K4' at qwen3-32b's shapes (64 query heads, 8 KV heads, head_dim
    128, a 64-layer pool) on the steps of ``kernels_phase`` and
    ``decode_kernels_phase``: K1' and the fused K2' on the mixed flat step
    and on the prefill-only step, K3' and the fused K4' on the decode
    batch. q and k of the writes come out of Qwen3's QK norm, v stays a view
    of the q|k|v projection, as in the model. Each is held to its plain
    version as there (attention within one bf16 ulp, the writes bit for
    bit) and timed beside its bound, the plain version and a library call;
    the launches come from qwen3-32b's engine runs."""
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(QWEN_MODEL)
    dev, dt, page = torch.device("cuda"), torch.bfloat16, 16
    L, K, H, D = cfg.num_layers, cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    max_pages = -(-cfg.max_model_len // page)
    gen = torch.Generator().manual_seed(3232)
    g = torch.Generator(device=dev).manual_seed(32)
    layer = L // 2
    decode_ctx = torch.randint(1024, 4097, (32,), generator=gen).tolist()
    steps = (("", mixed_step(cfg, page, max_pages, [(0, 512), (1024, 256), (2000, 128)],
                             decode_ctx, gen, dev)),
             (" prefill", mixed_step(cfg, page, max_pages, [(3072, 1024)], [], gen, dev)))
    out = []
    for suffix, s in steps:
        pool = torch.randn((L, s["num_pages"], K, page, 2 * D), generator=g, device=dev, dtype=dt)
        q = torch.randn((s["T"], 1, H, D), generator=g, device=dev, dtype=dt)
        out.append(rope_write_case(f"flat_kv_write[rope]@{QWEN_MODEL}{suffix}", "flat", cfg, pool,
                                   None, layer, s, False, g, qk_norm=True))
        out.append({**flat_attention_row(f"flat_paged_attention@{QWEN_MODEL}{suffix}", q, pool,
                                         layer, s, page),
                    "wrapper": "flat_paged_attention_full", "branch": "plain"})
        del pool, q
        torch.cuda.empty_cache()
    d = decode_batch(cfg, page, 1024, 4096, gen, dev)
    pool = torch.randn((L, d["num_pages"], K, page, 2 * D), generator=g, device=dev, dtype=dt)
    q = torch.randn((d["B"], 1, H, D), generator=g, device=dev, dtype=dt)
    out.append(rope_write_case(f"decode_kv_write[rope]@{QWEN_MODEL}", "decode", cfg, pool, None,
                               layer, d, False, g, qk_norm=True))
    out.append({**decode_attention_row(f"decode_paged_attention@{QWEN_MODEL}", q, pool, layer,
                                       d, page),
                "wrapper": "decode_paged_attention_full", "branch": "plain"})
    del pool, q
    info.update(layers=L, flat_tokens=[s["total"] for _, s in steps],
                decode_live_rows=d["n_live"])
    for e in out:
        e["model"] = QWEN_MODEL
        info[e["name"]] = {k: e[k] for k in ("bound_by", "items", "spans") + WRITE_KEYS if k in e}
    return {e["name"]: e for e in out}


def qwen_phases() -> dict:
    """qwen3-32b at full width and depth (64 layers, 65.5 GB of bf16
    weights drawn from seed 0) on one card: a runner built from the seed
    (its peak device memory held to the tree and pool plus 2 GB), then the
    8 requests on the flat step and as the split engine with windows of 8
    (``engine_phase``: launches per K1'-K4' branch, graph replays, one
    readback a step, decode ms), then the int8 tree's runner and flat
    step engine. Returns each layout's branch launch counts and the int8
    engine's launch counts."""
    from llmd_tpu_torch.config import CacheConfig, EngineConfig
    from llmd_tpu_torch.models.registry import get_model_config

    with phase("runner_init", {"model": QWEN_MODEL}) as info:
        params = runner_init_memory(info, EngineConfig(
            model=get_model_config(QWEN_MODEL),
            cache=CacheConfig(page_size=16, num_blocks=QWEN_BLOCKS), seed=0))
    runs = {}
    for layout in ("flat step", "split engine, decode_window 8"):
        with phase("engine", {"model": QWEN_MODEL, "layout": layout}) as info:
            _, runs[layout], _, _ = engine_phase(info, params, QWEN_MODEL, num_blocks=QWEN_BLOCKS)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with phase("runner_init", {"model": QWEN_MODEL, "quantization": "int8"}) as info:
        params = runner_init_memory(info, EngineConfig(
            model=get_model_config(QWEN_MODEL, quantization="int8"),
            cache=CacheConfig(page_size=16, num_blocks=QWEN_BLOCKS), seed=0))
    with phase("engine", {"model": QWEN_MODEL, "layout": "flat step", "quantization": "int8"}) as info:
        q8_counts, _, _, _ = engine_phase(info, params, QWEN_MODEL, num_blocks=QWEN_BLOCKS,
                                          quantization="int8")
    del params
    return runs, q8_counts


# --------------------------------------------------------------------- #
# int8 weights (W8A8): K6''s int8 branch, quantize_rows and its fused forms.

INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores (the same sheet)
Q8_SOURCE = {"route": "cuda", "source": "llmd_tpu_torch/ops/csrc/grouped_gemm_s8.cu",
             "replaces": "llmd_tpu/ops/grouped_gemm.py:43 (K6'); int8 branch of "
                         "llmd_tpu/ops/quant.py:125 qdot, :164 grouped_matmul_q (XLA in JAX)"}
QR_SOURCE = {"route": "cuda", "source": "llmd_tpu_torch/ops/csrc/quantize_rows.cu",
             "replaces": "none (llmd_tpu/ops/quant.py:116 quantize_activations, XLA in JAX)"}
Q8_KEYS = ("max_abs_err", "ms", "event_ms", "host_us", "plain_ms", "bound_ms", "bound_by",
           "bound_share", "bound_bytes_ms", "bound_ops_ms", "library_ms")


def q8_launches(cfg, forwards: int) -> dict:
    """Launches of the int8 wrappers in ``forwards`` forwards of a model
    with int8 weights, each followed by its logits (one ``lm_head``
    product unless the head is tied). Every layer's two norms are one
    ``add_rms_norm_quant`` each (the input norm taking the previous layer's
    output, the post norm the attention output), and MLA's ``q_norm``
    another where ``q_lora_rank > 0``; every gated unit is one ``glu_quant``
    (a dense MLP's, the experts', a shared expert's); ``quantize_rows`` is
    left to the attention output (``wo``) and ``lm_head``. Every dense
    product is one ``matmul_q8`` (q|k|v and o, or MLA's projections;
    gate|up and down, or their unfused three in an MLA tree's dense layers;
    a shared expert's three), a MoE layer's experts one pair and one down
    call. All zeros without int8 weights."""
    keys = ("quantize_rows", "matmul_q8", "grouped_matmul_q8", "grouped_matmul_q8_pair",
            "add_rms_norm_quant", "glu_quant")
    if cfg.quantization != "int8":
        return dict.fromkeys(keys, 0)
    L = cfg.num_layers
    n_moe = L - cfg.first_dense_layers if cfg.is_moe else 0
    q_lora = cfg.is_mla and cfg.q_lora_rank > 0
    attn = (4 if q_lora else 3) if cfg.is_mla else 2
    mlp = 3 if cfg.is_mla else 2  # MLA trees stay unfused
    shared = 3 if cfg.shared_expert_intermediate_size else 0
    head = 0 if cfg.tie_word_embeddings else 1
    dense = L * attn + (L - n_moe) * mlp + n_moe * shared + head
    glus = (L - n_moe) + n_moe * (1 + (shared > 0))
    return {"quantize_rows": forwards * (L + head), "matmul_q8": forwards * dense,
            "grouped_matmul_q8": forwards * n_moe, "grouped_matmul_q8_pair": forwards * n_moe,
            "add_rms_norm_quant": forwards * L * (3 if q_lora else 2),
            "glu_quant": forwards * glus}


def q8_bound(nbytes: float, ops: float, ops_per_s: float = INT8_OPS_PER_S) -> dict:
    """The least time for the work: bytes at the HBM rate and operations
    at their type's peak (int8 products on the tensor cores by default),
    the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops}


def rand_q8(shape, g, dev):
    return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)


def q8_row(kernel, plain, nbytes: float, ops: float, library=None,
           ops_per_s: float = INT8_OPS_PER_S) -> dict:
    """Run ``kernel`` and ``plain`` (each returning a tuple of outputs) on
    the same inputs: bit-equal or raise; then the row's times, bound and
    library time (``library``: (fn, name) or (None, why))."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(got, want):
        err = max(err, (a.float() - b.float()).abs().max().item())
        if not torch.equal(a, b):
            raise AssertionError(f"int8 kernel differs from its plain version (max abs err {err})")
    del got, want
    row = {"max_abs_err": err, **kernel_times(kernel),
           "plain_ms": cuda_ms(plain, reps=3, warmup=1), **q8_bound(nbytes, ops, ops_per_s)}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    fn, lib = library if library is not None else (None, None)
    row["library_ms"] = device_ms(fn) if fn is not None else None
    row["library_call"] = lib
    return row


def int_mm_yardstick(xq, a_scale, w, w_scale):
    """``torch._int_mm`` and the plain epilogue on the K-major weight w
    ``[N, K]`` (as its column-major ``[K, N]`` view, else a row-major copy),
    where this torch takes the shapes (it refuses 16 rows or fewer); (fn,
    name) or (None, why)."""
    from llmd_tpu_torch.ops import grouped_gemm

    for b, name in ((w.t(), "torch._int_mm (w column-major) + epilogue"),
                    (w.t().contiguous(), "torch._int_mm + epilogue")):
        try:
            torch._int_mm(xq, b)
            torch.cuda.synchronize()
        except (RuntimeError, TypeError) as e:
            why = str(e)[:100]
            continue
        return (lambda b=b: grouped_gemm._rescale(torch._int_mm(xq, b), a_scale, w_scale,
                                                  torch.bfloat16)), name
    return None, f"torch._int_mm refused M={xq.shape[0]}: {why}"


def q8_plan_of(M: int, G: int, N: int, K: int, pair: bool, dev) -> dict:
    """The form ``q8_plan`` gives a product, as a row's fields."""
    from llmd_tpu_torch.ops import grouped_gemm

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = grouped_gemm.q8_plan(M, G, N, K, sms, pair)
    return {"form": "swap-AB" if plan.swap else "prefill", "tile": [plan.rows, plan.cols]}


def q8_dense_case(M: int, K: int, N: int, g, dev) -> dict:
    """K6''s int8 branch as one dense product (G = 1: a projection or
    lm_head), xq [M, K] and w [N, K] int8 (K-major), bf16 out."""
    from llmd_tpu_torch.ops import grouped_gemm

    xq, a_scale = rand_q8((M, K), g, dev), torch.rand(M, generator=g, device=dev) / 127
    w, w_scale = rand_q8((N, K), g, dev), torch.rand(N, generator=g, device=dev) / 127
    kernel = lambda: (grouped_gemm.matmul_q8(xq, a_scale, w, w_scale, torch.bfloat16),)  # noqa: E731
    plain = lambda: (grouped_gemm.matmul_q8_plain(xq, a_scale, w, w_scale, torch.bfloat16),)  # noqa: E731
    row = q8_row(kernel, plain, M * K + 4 * M + K * N + 4 * N + 2 * M * N, 2.0 * M * K * N,
                 int_mm_yardstick(xq, a_scale, w, w_scale))
    row.update(M=M, K=K, N=N, **q8_plan_of(M, 1, N, K, False, dev))
    del xq, w
    torch.cuda.empty_cache()
    return row


def q8_grouped_case(T: int, E: int, k: int, K: int, N: int, pair: bool, gen, g, dev) -> dict:
    """K6''s int8 branch on one routed step (T tokens to k of E experts,
    the row counts a random router gives), against one weight tensor or
    two through the pair."""
    from llmd_tpu_torch.ops import grouped_gemm

    gs = routed_group_sizes(T, E, k, gen).to(dev)
    M = T * k
    xq, a_scale = rand_q8((M, K), g, dev), torch.rand(M, generator=g, device=dev) / 127
    ws = [(rand_q8((E, N, K), g, dev), torch.rand((E, N), generator=g, device=dev) / 127)
          for _ in range(2 if pair else 1)]
    if pair:
        (wa, sa), (wb, sb) = ws
        kernel = lambda: grouped_gemm.grouped_matmul_q8_pair(  # noqa: E731
            xq, a_scale, wa, sa, wb, sb, gs, torch.bfloat16)
        plain = lambda: grouped_gemm.grouped_matmul_q8_pair_plain(  # noqa: E731
            xq, a_scale, wa, sa, wb, sb, gs, torch.bfloat16)
    else:
        (w, sc), = ws
        kernel = lambda: (grouped_gemm.grouped_matmul_q8(xq, a_scale, w, sc, gs, torch.bfloat16),)  # noqa: E731
        plain = lambda: (grouped_gemm.grouped_matmul_q8_plain(xq, a_scale, w, sc, gs, torch.bfloat16),)  # noqa: E731
    live = int((gs > 0).sum().item())
    nw = len(ws)
    nbytes = M * K + 4 * M + nw * (live * (K * N + 4 * N) + 2 * M * N) + 4 * E
    row = q8_row(kernel, plain, nbytes, 2.0 * nw * M * K * N,
                 (None, "none: no single PyTorch call computes a grouped int8 product"))
    row.update(M=M, experts=E, live_experts=live, K=K, N=N, weights=nw,
               **q8_plan_of(M, E, N, K, pair, dev))
    del xq, ws
    torch.cuda.empty_cache()
    return row


def quantize_rows_case(M: int, K: int, g, dev) -> dict:
    from llmd_tpu_torch.ops import quant

    x = torch.randn((M, K), generator=g, device=dev, dtype=torch.bfloat16)
    # f32 work an element: |x|, the max, the divide, the rounding, the clamp.
    row = q8_row(lambda: quant.quantize_rows(x), lambda: quant.quantize_rows_plain(x),
                 M * K * 3 + 4 * M, 5.0 * M * K,
                 (None, "none: no single PyTorch call quantizes rows to int8"), F32_OPS_PER_S)
    row.update(M=M, K=K)
    return row


FUSED_SOURCE = {"route": "cuda", "source": "llmd_tpu_torch/ops/csrc/quantize_rows.cu"}
NORM_REPLACES = ("none (llmd_tpu/models/common.py:62 rms_norm after the residual add, then "
                 "llmd_tpu/ops/quant.py:116 quantize_activations: XLA in JAX)")
GLU_REPLACES = ("none (llmd_tpu/models/llama.py:154 silu(gate) * up, llmd_tpu/models/moe.py:112 "
                "expert_glu, then llmd_tpu/ops/quant.py:116 quantize_activations: XLA in JAX)")
FUSED_KEYS = (*Q8_KEYS, "unfused_ms")
# The norm's rsqrt factor: the kernel's within 2^-21 (a few f32 ulps) of
# the plain chain's, whose sum of squares runs in another order.
RSTD_REL = 2.0**-21


def apart(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far a bf16 row lies from the plain chain's: elements apart,
    elements beyond one ulp (``outside_one_ulp``'s bound), max error."""
    diff = (got.float() - want.float()).abs()
    beyond = diff > BF16_ATOL + BF16_ULP * want.float().abs()
    return {"elements_apart": int((got != want).sum().item()), "beyond_one_ulp": int(beyond.sum().item()),
            "max_abs_err": diff.max().item()}


def fused_times(call, plain, unfused, nbytes: float, ops: float) -> dict:
    """A fused form's times: the model's call (``kernel_times``), the
    plain version, the unfused chain it replaces (PyTorch's ops, then the
    ``quantize_rows`` kernel; device time, as "ms"), and the bound (bytes
    at 3.35 TB/s, f32 operations at 67 TFLOP/s)."""
    row = {**kernel_times(call), "plain_ms": cuda_ms(plain, reps=3, warmup=1),
           "unfused_ms": device_ms(unfused), **q8_bound(nbytes, ops, F32_OPS_PER_S),
           "library_ms": None,
           "library_call": "none: no PyTorch call computes a norm or a gated unit with an int8 quantization"}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row


def norm_quant_case(M: int, K: int, g, dev, bias: bool = False, want_h: bool = False) -> dict:
    """``add_rms_norm_quant`` as a post norm: the residual x plus a branch
    output (plus ``bo`` where ``bias``), the norm with a random weight, the
    quantized rows (and h where the model writes it, ``want_h``). Held to
    the contract: x_new bit-equal to the plain chain's; h bit-equal to the
    plain chain's arithmetic after its reduction, run with the kernel's
    rsqrt factor, which is within ``RSTD_REL`` of the plain chain's; (xq,
    a_scale) bit-equal to ``quantize_rows_plain`` of the kernel's h, and
    the same without h written. h against the plain chain's h is reported
    (``apart``): one f32 ulp of the factor can move bf16(x r) by one ulp,
    which the weight product can make two."""
    from llmd_tpu_torch.models.common import rms_norm
    from llmd_tpu_torch.ops import quant

    dt, eps = torch.bfloat16, 1e-5
    x, d = (torch.randn((M, K), generator=g, device=dev, dtype=dt) for _ in range(2))
    w = torch.randn((K,), generator=g, device=dev, dtype=dt)
    b = torch.randn((K,), generator=g, device=dev, dtype=dt) * 0.1 if bias else None
    rk, rp = torch.empty(M, device=dev), torch.empty(M, device=dev)
    xk, hk, qk, sk = quant.add_rms_norm_quant(x, d, b, w, eps, True, rk)
    xp, hp, _, _ = quant.add_rms_norm_quant_plain(x, d, b, w, eps, True, rp)
    wq, ws = quant.quantize_rows_plain(hk)
    _, _, q2, s2 = quant.add_rms_norm_quant(x, d, b, w, eps)
    after = (xk.float() * rk[:, None]).to(dt) * w
    torch.cuda.synchronize()
    rel = ((rk - rp).abs() / rp).max().item()
    checks = {"x_new_bit_equal": torch.equal(xk, xp), "h_bit_equal_given_rstd": torch.equal(hk, after),
              "rstd_rel_err": rel, "quantized_bit_equal": torch.equal(qk, wq) and torch.equal(sk, ws),
              "quantized_without_h_bit_equal": torch.equal(q2, qk) and torch.equal(s2, sk)}
    if not (checks["x_new_bit_equal"] and checks["h_bit_equal_given_rstd"] and rel <= RSTD_REL
            and checks["quantized_bit_equal"] and checks["quantized_without_h_bit_equal"]):
        raise AssertionError(f"add_rms_norm_quant {M} x {K} breaks its contract: {checks}")
    row = {**checks, **apart(hk, hp)}
    del xk, hk, qk, sk, xp, hp, wq, ws, q2, s2, after
    args = (x, d, b, w, eps, want_h)
    # x, delta, x_new (+ h) in bf16, xq, the scales, the weight and bias.
    nbytes = (6 + 2 * want_h + 1) * M * K + 4 * M + 2 * K * (2 if bias else 1)
    row.update(fused_times(
        lambda: quant.add_rms_norm_quant(*args), lambda: quant.add_rms_norm_quant_plain(*args),
        lambda: quant.quantize_rows(rms_norm(x + (d if b is None else d + b), w, eps)),
        nbytes, 14.0 * M * K))
    row.update(M=M, K=K, bias=bias, h_written=want_h)
    return row


def glu_quant_case(M: int, F: int, g, dev, kind: str = "silu", limit: float = 0.0,
                   experts: int = 0, split: bool = True) -> dict:
    """``glu_quant`` on a gate|up product: one [M, 2F] output split in two
    (``split``, the dense w_gu) or two [M, F] outputs (the experts' pair, a
    shared expert), with the experts' biases picked by unsorted expert ids
    where ``experts``. Held to the contract: act within one bf16 ulp of the
    plain chain's (``apart`` reports it), (xq, a_scale) bit-equal to
    ``quantize_rows_plain`` of the kernel's act, and the same without act
    written."""
    from llmd_tpu_torch.ops import quant

    dt = torch.bfloat16
    if split:
        gu = torch.randn((M, 2 * F), generator=g, device=dev, dtype=dt) * 3
        gate, up = gu, None
    else:
        gate, up = (torch.randn((M, F), generator=g, device=dev, dtype=dt) * 3 for _ in range(2))
    biases, ids = None, None
    if experts:
        biases = tuple(torch.randn((experts, F), generator=g, device=dev, dtype=dt) for _ in range(2))
        ids = torch.randint(0, experts, (M,), generator=g, device=dev)
    args = (gate, up, kind, limit, biases, ids)
    qk, sk, ak = quant.glu_quant(*args, want_act=True)
    _, _, ap = quant.glu_quant_plain(*args, want_act=True)
    wq, ws = quant.quantize_rows_plain(ak)
    q2, s2, _ = quant.glu_quant(*args)
    torch.cuda.synchronize()
    row = {"quantized_bit_equal": torch.equal(qk, wq) and torch.equal(sk, ws),
           "quantized_without_act_bit_equal": torch.equal(q2, qk) and torch.equal(s2, sk),
           **apart(ak, ap)}
    if row["beyond_one_ulp"] or not (row["quantized_bit_equal"] and row["quantized_without_act_bit_equal"]):
        raise AssertionError(f"glu_quant {kind} {M} x {F} breaks its contract: {row}")
    del qk, sk, ak, ap, wq, ws, q2, s2
    live = int(torch.unique(ids).numel()) if experts else 0

    def unfused():
        g_, u_ = (gate[:, :F], gate[:, F:]) if split else (gate, up)
        if biases is not None:
            g_, u_ = g_ + biases[0][ids], u_ + biases[1][ids]
        return quant.quantize_rows(quant.glu(g_, u_, kind, limit).contiguous())

    nbytes = 5 * M * F + 4 * M + (8 * M + 4 * live * F if experts else 0)
    row.update(fused_times(lambda: quant.glu_quant(*args), lambda: quant.glu_quant_plain(*args),
                           unfused, nbytes, 10.0 * M * F))
    row.update(M=M, F=F, kind=kind, experts=experts, live_experts=live, split=split)
    return row


def quant_kernels_phase(info: dict) -> dict:
    """K6''s int8 branch and ``quantize_rows`` at the int8 models' shapes,
    each bit-equal to its plain version and timed beside its bound (bytes
    at 3.35 TB/s, int8 operations at 1,979 TOP/s), the plain version and,
    for a dense product, ``torch._int_mm`` plus the plain epilogue: llama-3-8b's
    dense products at decode steps of 32 and 64 rows and a 1,024-token
    prefill, qwen3-32b's at a 32-row decode step, deepseek-v2-lite's
    dense-layer down (K 10,944) at a 128-token step (16 items: the
    longest contraction over the fewest items), the experts
    of deepseek-v2-lite (48-token decode, 1,024-token prefill) and
    gpt-oss-20b (32-token decode, 1,024-token prefill), the rows
    quantized before those products, and the fused forms that quantize
    the rows out of a norm or a gated unit (``norm_quant_case``,
    ``glu_quant_case``). Returns the kernel table's rows."""
    from llmd_tpu_torch.models.registry import get_model_config

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2025)
    g = torch.Generator(device=dev).manual_seed(37)
    cfg = get_model_config(MODEL)
    H, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    dense_cases = {
        "decode 32 rows, wqkv": (32, H, qkv), "decode 32 rows, wo": (32, H, H),
        "decode 32 rows, w_gu": (32, H, 2 * F), "decode 32 rows, w_down": (32, F, H),
        "decode 32 rows, lm_head": (32, H, V), "decode 64 rows, wqkv": (64, H, qkv),
        "decode 64 rows, w_gu": (64, H, 2 * F), "decode 64 rows, w_down": (64, F, H),
        "prefill 1024 tokens, wqkv": (1024, H, qkv), "prefill 1024 tokens, w_gu": (1024, H, 2 * F),
        "prefill 1024 tokens, w_down": (1024, F, H),
    }
    qwen = get_model_config(QWEN_MODEL)
    qH, qF = qwen.hidden_size, qwen.intermediate_size
    qq = qwen.num_heads * qwen.head_dim
    dense_cases.update({
        "qwen3-32b decode 32 rows, wqkv": (32, qH, qq + 2 * qwen.num_kv_heads * qwen.head_dim),
        "qwen3-32b decode 32 rows, wo": (32, qq, qH),
        "qwen3-32b decode 32 rows, w_gu": (32, qH, 2 * qF),
        "qwen3-32b decode 32 rows, w_down": (32, qF, qH),
    })
    ds, oss = get_model_config(DS_MODEL), get_model_config(OSS_MODEL)
    dense_cases["deepseek-v2-lite dense layer, prefill 128 rows, w_down"] = (
        128, ds.intermediate_size, ds.hidden_size)
    dense = {name: q8_dense_case(*c, g, dev) for name, c in dense_cases.items()}
    info["dense"] = dense
    dsk, ossk = (ds.num_experts, ds.num_experts_per_tok), (oss.num_experts, oss.num_experts_per_tok)
    grouped_cases = {
        "deepseek-v2-lite decode 48 rows, gate|up pair": (48, *dsk, ds.hidden_size, ds.moe_intermediate_size, True),
        "deepseek-v2-lite decode 48 rows, down": (48, *dsk, ds.moe_intermediate_size, ds.hidden_size, False),
        "deepseek-v2-lite prefill 1024 tokens, gate|up pair": (
            1024, *dsk, ds.hidden_size, ds.moe_intermediate_size, True),
        "gpt-oss-20b decode 32 tokens, gate|up pair": (
            32, *ossk, oss.hidden_size, oss.moe_intermediate_size, True),
        "gpt-oss-20b decode 32 tokens, down": (32, *ossk, oss.moe_intermediate_size, oss.hidden_size, False),
        "gpt-oss-20b prefill 1024 tokens, gate|up pair": (
            1024, *ossk, oss.hidden_size, oss.moe_intermediate_size, True),
    }
    grouped = {name: q8_grouped_case(*c, gen, g, dev) for name, c in grouped_cases.items()}
    info["grouped"] = grouped
    qrows = {"decode 32 rows x 4096": (32, H), "decode 32 rows x 14336": (32, F),
             "prefill 1024 tokens x 4096": (1024, H)}
    quantized = {name: quantize_rows_case(*c, g, dev) for name, c in qrows.items()}
    info["quantize_rows"] = quantized
    norms = {f"{MODEL} decode 32 rows x {H}": (32, H), f"{MODEL} decode 64 rows x {H}": (64, H),
             f"{MODEL} prefill 1024 tokens x {H}": (1024, H),
             f"{QWEN_MODEL} decode 32 rows x {qH}": (32, qH)}
    normed = {name: norm_quant_case(*c, g, dev) for name, c in norms.items()}
    # gpt-oss's post norm: the attention output plus bo, h written for the router.
    normed[f"{OSS_MODEL} decode 32 rows x {oss.hidden_size}, bo, h"] = norm_quant_case(
        32, oss.hidden_size, g, dev, bias=True, want_h=True)
    info["add_rms_norm_quant"] = normed
    oss_kind = ("swiglu_oss", oss.swiglu_limit)
    glus = {f"{MODEL} decode 32 rows x {F}": dict(M=32, F=F), f"{MODEL} decode 64 rows x {F}": dict(M=64, F=F),
            f"{MODEL} prefill 1024 tokens x {F}": dict(M=1024, F=F),
            f"{QWEN_MODEL} decode 32 rows x {qF}": dict(M=32, F=qF),
            f"{OSS_MODEL} experts decode 32 tokens x {oss.moe_intermediate_size}": dict(
                M=32 * ossk[1], F=oss.moe_intermediate_size, kind=oss_kind[0], limit=oss_kind[1],
                experts=ossk[0], split=False),
            f"{OSS_MODEL} experts prefill 1024 tokens x {oss.moe_intermediate_size}": dict(
                M=1024 * ossk[1], F=oss.moe_intermediate_size, kind=oss_kind[0], limit=oss_kind[1],
                experts=ossk[0], split=False),
            f"{DS_MODEL} experts decode 48 tokens x {ds.moe_intermediate_size}": dict(
                M=48 * dsk[1], F=ds.moe_intermediate_size, split=False),
            f"{DS_MODEL} shared expert decode 48 rows x {ds.shared_expert_intermediate_size}": dict(
                M=48, F=ds.shared_expert_intermediate_size, split=False)}
    gated = {name: glu_quant_case(g=g, dev=dev, **c) for name, c in glus.items()}
    info["glu_quant"] = gated
    table = {
        # table name: (cases, case, source, wrapper, model whose int8 engine run is its main path)
        "grouped_gemm_s8@dense decode 32, wqkv": (dense, "decode 32 rows, wqkv", Q8_SOURCE, "matmul_q8", MODEL),
        "grouped_gemm_s8@dense decode 32, wo": (dense, "decode 32 rows, wo", Q8_SOURCE, "matmul_q8", MODEL),
        "grouped_gemm_s8@dense decode 32, w_gu": (dense, "decode 32 rows, w_gu", Q8_SOURCE, "matmul_q8", MODEL),
        "grouped_gemm_s8@dense decode 32, w_down": (
            dense, "decode 32 rows, w_down", Q8_SOURCE, "matmul_q8", MODEL),
        "grouped_gemm_s8@dense decode 32, lm_head": (
            dense, "decode 32 rows, lm_head", Q8_SOURCE, "matmul_q8", MODEL),
        "grouped_gemm_s8@dense decode 64, w_gu": (dense, "decode 64 rows, w_gu", Q8_SOURCE, "matmul_q8", MODEL),
        "grouped_gemm_s8@dense prefill 1024, w_gu": (
            dense, "prefill 1024 tokens, w_gu", Q8_SOURCE, "matmul_q8", MODEL),
        "grouped_gemm_s8@dense prefill 1024, w_down": (
            dense, "prefill 1024 tokens, w_down", Q8_SOURCE, "matmul_q8", MODEL),
        **{f"grouped_gemm_s8@qwen3-32b dense decode 32, {leaf}": (
            dense, f"qwen3-32b decode 32 rows, {leaf}", Q8_SOURCE, "matmul_q8", QWEN_MODEL)
           for leaf in ("wqkv", "wo", "w_gu", "w_down")},
        "grouped_gemm_s8@deepseek dense prefill 128, w_down": (
            dense, "deepseek-v2-lite dense layer, prefill 128 rows, w_down", Q8_SOURCE, "matmul_q8",
            DS_MODEL),
        "grouped_gemm_s8_pair@deepseek decode": (
            grouped, "deepseek-v2-lite decode 48 rows, gate|up pair", Q8_SOURCE,
            "grouped_matmul_q8_pair", DS_MODEL),
        "grouped_gemm_s8@deepseek decode down": (
            grouped, "deepseek-v2-lite decode 48 rows, down", Q8_SOURCE, "grouped_matmul_q8", DS_MODEL),
        "grouped_gemm_s8_pair@deepseek prefill": (
            grouped, "deepseek-v2-lite prefill 1024 tokens, gate|up pair", Q8_SOURCE,
            "grouped_matmul_q8_pair", DS_MODEL),
        "grouped_gemm_s8_pair@gpt-oss decode": (
            grouped, "gpt-oss-20b decode 32 tokens, gate|up pair", Q8_SOURCE,
            "grouped_matmul_q8_pair", OSS_MODEL),
        "grouped_gemm_s8@gpt-oss decode down": (
            grouped, "gpt-oss-20b decode 32 tokens, down", Q8_SOURCE, "grouped_matmul_q8", OSS_MODEL),
        "grouped_gemm_s8_pair@gpt-oss prefill": (
            grouped, "gpt-oss-20b prefill 1024 tokens, gate|up pair", Q8_SOURCE,
            "grouped_matmul_q8_pair", OSS_MODEL),
        "quantize_rows@decode 32 x 4096": (quantized, "decode 32 rows x 4096", QR_SOURCE, "quantize_rows", MODEL),
        "quantize_rows@decode 32 x 14336": (quantized, "decode 32 rows x 14336", QR_SOURCE, "quantize_rows", MODEL),
        "quantize_rows@prefill 1024 x 4096": (
            quantized, "prefill 1024 tokens x 4096", QR_SOURCE, "quantize_rows", MODEL),
    }
    for cases, wrapper, replaces in ((normed, "add_rms_norm_quant", NORM_REPLACES),
                                     (gated, "glu_quant", GLU_REPLACES)):
        for case in cases:
            model = next(m for m in (QWEN_MODEL, OSS_MODEL, DS_MODEL, MODEL) if case.startswith(m))
            table[f"{wrapper}@{case}"] = (cases, case, {**FUSED_SOURCE, "replaces": replaces}, wrapper, model)
    keys = (*FUSED_KEYS, "form", "tile", "elements_apart", "beyond_one_ulp", "rstd_rel_err")
    return {name: {"name": name, **src, "wrapper": wrapper, "model": f"{model} int8", "shape": case,
                   **{k: cases[case][k] for k in keys if k in cases[case]}}
            for name, (cases, case, src, wrapper, model) in table.items()}


def q8_steps(cfg, gen, g, dev) -> dict:
    """The int8 forward phases' steps: a mixed flat step and a Q = 1 decode
    step (batch bucket 64) for a GQA model, a bucketed prefill step and the
    decode step for MLA. name -> (input, pool pages, live slots, gather
    bound)."""
    from llmd_tpu_torch.models.common import StepInput

    page = 16
    d = decode_batch(cfg, page, 128, 640, gen, dev)
    ids = torch.randint(0, cfg.vocab_size, (d["B"], 1), generator=g, device=dev)
    decode = (StepInput(token_ids=torch.where(d["valid"][:, None] > 0, ids, 0),
                        positions=d["positions"], kv_lens=d["kv_lens"],
                        page_table=d["page_table"], query_lens=d["valid"]),
              d["num_pages"], torch.arange(d["B"], device=dev) < d["n_live"], d["live_pages"])
    if cfg.is_mla:
        p = bucketed_rows(cfg, page, [(0, 256), (512, 200), (0, 128), (1000, 40)], gen, dev)
        return {"prefill": (StepInput(token_ids=p["tokens"], positions=p["positions"],
                                      kv_lens=p["kv_lens"], page_table=p["page_table"],
                                      query_lens=p["query_lens"], live_pages=p["live_pages"]),
                            p["num_pages"], p["live"], p["live_pages"]),
                "decode": decode}
    decode_ctx = torch.randint(200, 1001, (16,), generator=gen).tolist()
    s = mixed_step(cfg, page, -(-cfg.max_model_len // page), [(0, 300), (600, 200)],
                   decode_ctx, gen, dev)
    live = torch.arange(s["T"], device=dev) < s["total"]
    ids = torch.randint(0, cfg.vocab_size, (s["T"],), generator=g, device=dev)
    flat = StepInput(token_ids=torch.where(live, ids, 0)[:, None], positions=s["positions"][:, None],
                     kv_lens=s["kv_lens"], page_table=s["page_table"], token_rows=s["rows"],
                     num_live=s["num_live"])
    return {"flat": (flat, s["num_pages"], live, None), "decode": decode}


def q8_forward_phase(info: dict, model: str, params16: dict, params8: dict) -> None:
    """One step of each kind (``q8_steps``) of the int8 model at full width
    through the kernels and through the plain versions (``plain_ops``: K6''s
    int8 branch and ``quantize_rows`` among them), and of the bf16 model
    its int8 tree was quantized from. Every int8 product must launch the
    int8 kernels (``q8_launches``) and K6''s bf16 calls never; layer 0's
    pool bytes must equal the plain run's (its K|V come from int8
    products that are bit-equal to theirs); hidden states finite; and, as
    the bf16 forwards are held, the kernels' bf16 run no further from the
    f32 run of the same int8 tree (its float leaves upcast, the int8 leaves
    as they are; plain versions) than 1.5 times the plain bf16 run's
    distance. Reported, not gated: the two bf16 runs against each other,
    the two f32 runs (a one-ulp difference in an attention output can move
    an activation's int8 rounding, so they part more than bf16 weights'
    do), and the int8 logits against the bf16 model's (relative error,
    argmax agreement; random weights)."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.registry import get_model_config

    cfg16 = get_model_config(model)
    cfg8 = get_model_config(model, quantization="int8")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(41)
    g = torch.Generator(device=dev).manual_seed(43)
    L = cfg8.num_layers
    n_moe = L - cfg8.first_dense_layers if cfg8.is_moe else 0
    steps = q8_steps(cfg8, gen, g, dev)
    info["tree_gb"] = {"bf16": tree_nbytes(params16) / 1e9, "int8": tree_nbytes(params8) / 1e9}
    params8_32 = _tree_map(params8, lambda w: w.float() if w.is_floating_point() else w)

    def rel(a, b) -> float:
        return ((a - b).norm() / b.norm()).item()

    for name, (inp, num_pages, live, live_pages) in steps.items():
        shape = (L, num_pages, cfg8.kv_cache_heads, 16, cfg8.kv_cache_entry_dim)
        pool = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)

        def run(prm, cfg, plain, f32=False):
            work = pool.float() if f32 else pool.clone()
            ctx = plain_ops(live_pages) if plain else contextlib.nullcontext()
            with torch.inference_mode(), ctx:
                h, _ = llama.forward_hidden(prm, work, inp, cfg)
                h = h.reshape(-1, h.shape[-1])[live]
                logits = llama.compute_logits(prm, h, cfg)
            return h.float(), logits, work[0].clone()

        ops.reset_launch_counts()
        h_k, lg_k, pool0_k = run(params8, cfg8, plain=False)
        counts = ops.launch_counts()
        h_p, lg_p, pool0_p = run(params8, cfg8, plain=True)
        h_k32, _, _ = run(params8_32, cfg8, plain=False, f32=True)
        h_ref, _, _ = run(params8_32, cfg8, plain=True, f32=True)
        _, lg_16, _ = run(params16, cfg16, plain=False)
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: llama.forward_hidden(params8, pool, inp, cfg8), reps=3, warmup=1)
            fwd16_ms = cuda_ms(lambda: llama.forward_hidden(params16, pool, inp, cfg16), reps=3, warmup=1)
        torch.cuda.synchronize()
        attn = ({"write_kv_pages_decode_full": L, "mla_decode_paged_attention_full": L}
                if cfg8.is_mla and name == "decode" else
                {"write_kv_pages_decode_full": L} if cfg8.is_mla else
                {"write_kv_pages_flat_full": L, "flat_paged_attention_full": L} if name == "flat" else
                {"write_kv_pages_decode_full": L, "decode_paged_attention_full": L})
        want = {fn: 0 for fn in counts}
        want.update(attn)
        want.update(q8_launches(cfg8, 1))
        r = {
            "rows": inp.token_ids.shape[0], "live": int(live.sum().item()), "layers": L,
            "launches": counts, "kernels_vs_plain_rel_err": rel(h_k, h_p),
            "f32_kernels_vs_plain_rel_err": rel(h_k32, h_ref),
            "bf16_kernels_vs_f32": rel(h_k, h_ref), "bf16_plain_vs_f32": rel(h_p, h_ref),
            "layer0_pool_equal": bool(torch.equal(pool0_k, pool0_p)),
            "int8_vs_bf16_logits_rel_err": rel(lg_k, lg_16),
            "int8_vs_bf16_argmax_agreement": (lg_k.argmax(-1) == lg_16.argmax(-1)).float().mean().item(),
            "kernels_vs_plain_argmax_agreement": (lg_k.argmax(-1) == lg_p.argmax(-1)).float().mean().item(),
            "step_ms": fwd_ms, "bf16_step_ms": fwd16_ms,
        }
        info[name] = r
        if counts != want:
            raise AssertionError(f"{model} int8 {name} forward launched {counts}, want {want}")
        if not all(torch.isfinite(t).all() for t in (h_k, h_p, lg_k, lg_16)):
            raise AssertionError(f"{model} int8 {name} forward: non-finite values")
        if cfg8.is_mla:
            # K4''s latent form normalises c_kv with its own sum's order.
            r["layer0_latent"] = latent_rows_apart(pool0_k, pool0_p, cfg8.kv_lora_rank)
            if not r["layer0_latent"]["rope_and_pad_equal"] or r["layer0_latent"]["c_kv_max_ulps"] > 2:
                raise AssertionError(f"{model} int8 {name} forward: layer-0 latent rows "
                                     f"{r['layer0_latent']} from plain")
        elif not r["layer0_pool_equal"]:
            raise AssertionError(f"{model} int8 {name} forward: layer-0 pool bytes differ from plain")
        if r["bf16_kernels_vs_f32"] > 1.5 * r["bf16_plain_vs_f32"]:
            raise AssertionError(
                f"{model} int8 {name} forward: kernels {r['bf16_kernels_vs_f32']} from f32, "
                f"plain {r['bf16_plain_vs_f32']} (limit 1.5x)")
        del pool, h_k, h_p, h_k32, h_ref, lg_k, lg_p, lg_16, pool0_k, pool0_p
        torch.cuda.empty_cache()
    del params8_32
    if n_moe and not counts.get("grouped_matmul_q8_pair"):
        raise AssertionError("the int8 experts never ran K6''s int8 pair")


def q8_serve_check(info: dict, base: str) -> None:
    """The int8 server's chat route and /metrics answer."""
    status, raw = _post(base + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Say hello."}], "max_tokens": 16,
        "temperature": 0.0, "ignore_eos": True})
    if status != 200:
        raise AssertionError(f"/v1/chat/completions returned {status}")
    info["chat_completion_tokens"] = json.loads(raw)["usage"]["completion_tokens"]
    metrics, scrape_ms = _scrape(base)
    info["metrics_series"] = len(metrics)
    info["scrape_ms"] = scrape_ms
    if info["chat_completion_tokens"] != 16 or not metrics:
        raise AssertionError(f"chat gave {info['chat_completion_tokens']} tokens, /metrics {len(metrics)} series")


def async_serve_check(info: dict, base: str) -> None:
    """The async server's /metrics: ``llmd:async_rollbacks_total`` counts
    the staged rows its finished requests rolled back."""
    metrics, _ = _scrape(base)
    info["async_rollbacks_total"] = metrics.get("llmd:async_rollbacks_total")
    info["step_host_gap_ms_total"] = metrics.get("llmd:step_host_gap_ms_total")
    if not info["async_rollbacks_total"]:
        raise AssertionError(f"llmd:async_rollbacks_total is {info['async_rollbacks_total']}")


def fixed_prompts(cfg, n: int, length: int, seed: int) -> list[list[int]]:
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(3, cfg.vocab_size, (length,), generator=gen).tolist() for _ in range(n)]


def path_launches(info: dict, counts: dict, wrappers: tuple) -> None:
    """A phase's own main-path run, read just after the counts were set to
    0: each of ``wrappers`` launched."""
    info["launches"] = counts
    missing = [w for w in wrappers if not counts.get(w)]
    if missing:
        raise AssertionError(f"{missing} never launched in this phase's run: {counts}")


FLAT_WRAPPERS = ("flat_paged_attention_full", "write_kv_pages_flat_full")
MLA_WRAPPERS = ("mla_decode_paged_attention_full", "write_kv_pages_decode_full",
                "grouped_matmul_pair", "grouped_matmul")
BATCH_INTERACTIVE, BATCH_JOBS, BATCH_SLOTS = 8, 16, 16


def batch_run(params: dict, cfg, backlog: bool) -> dict:
    """One engine on the flat step (warmed up: decode-only steps are graph
    replays), 16 slots: the interactive requests alone, or arriving once
    the batch backlog holds every slot (or 12 steps passed). Returns their
    streams and logprobs, TTFT and TPOT, the batch rows' streams, the
    batch counters and the gauge each step, and the kernels' launches."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from llmd_tpu_torch.engine import LLMEngine, PriorityClass, SamplingParams

    eng = LLMEngine(EngineConfig(
        model=cfg, cache=CacheConfig(page_size=16, num_blocks=2048, dtype=cfg.dtype),
        scheduler=SchedulerConfig(max_num_seqs=BATCH_SLOTS, max_num_batched_tokens=1024), seed=0,
    ), params=params, device="cuda")
    eng.warmup()
    # Warm-up requests (cuBLAS, kernels, the allocations of a full
    # 1,024-token step), so that both runs time warm steps.
    eng.generate([[5] * 900, [7] * 300], SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True))
    interactive = fixed_prompts(cfg, BATCH_INTERACTIVE, 256, 31)
    jobs = fixed_prompts(cfg, BATCH_JOBS, 512, 32)
    sp = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True, logprobs=True)
    sp_b = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
    ops.reset_launch_counts()
    runs0 = sum(eng.runner.programs.runs.values())
    programs0 = len(eng.runner.programs.programs)
    tokens: dict[str, list[int]] = {}
    times: dict[str, list[float]] = {}
    reqs = {}
    util, steps_before = [], 0
    if backlog:
        for p in jobs:
            rid = eng.add_request(p, sp_b, priority=int(PriorityClass.BATCH))
            tokens[rid] = []
        while eng.scheduler.num_running < BATCH_SLOTS and steps_before < 12:
            for out in eng.step():
                tokens[out.request_id] += out.new_token_ids
            steps_before += 1
    arrival = time.perf_counter()
    rids = []
    for p in interactive:
        rid = eng.add_request(p, sp)
        rids.append(rid)
        tokens[rid], times[rid] = [], []
        reqs[rid] = next(r for r in eng.scheduler.waiting if r.request_id == rid)
    running_batch_at_arrival = sum(1 for r in eng.scheduler.running if r.is_batch)
    steps = 0
    while eng.has_work():
        outs = eng.step()
        now = time.perf_counter()
        steps += 1
        util.append(eng.stats.batch_backfill_utilization)
        for out in outs:
            tokens[out.request_id] += out.new_token_ids
            if out.request_id in times:
                times[out.request_id] += [now] * len(out.new_token_ids)
    torch.cuda.synchronize()
    st = eng.stats
    ttft = [(times[r][0] - arrival) * 1e3 for r in rids]
    tpot = [(times[r][-1] - times[r][0]) * 1e3 / (len(times[r]) - 1) for r in rids]
    rec = {
        "tokens": [tokens[r] for r in rids], "logprobs": [reqs[r].output_logprobs for r in rids],
        "batch_streams": [t for r, t in tokens.items() if r not in times],
        "ttft_ms_median": statistics.median(ttft), "ttft_ms_max": max(ttft),
        "tpot_ms_median": statistics.median(tpot), "tpot_ms_max": max(tpot),
        "steps_before_arrival": steps_before, "running_batch_rows_at_arrival": running_batch_at_arrival,
        "steps": steps, "batch_tokens": st.batch_tokens, "batch_preemptions": st.batch_preemptions,
        "preemptions": st.preemptions, "batch_backlog_jobs_end": st.batch_backlog_jobs,
        "batch_backfill_utilization_mean": sum(util) / len(util),
        "batch_backfill_utilization_max": max(util),
        "graph_replays": sum(eng.runner.programs.runs.values()) - runs0,
        "graphs_captured_in_run": len(eng.runner.programs.programs) - programs0,
        "launches": ops.launch_counts(),
    }
    if eng.has_work() or eng.allocator.usage() != 0.0:
        raise AssertionError("the batch engine ended with work or pages held")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def batch_phase(params: dict, cfg) -> None:
    """``batch_run`` without and with the backlog on ``cfg`` (llama-3-8b's
    widths; f32 at a cut depth, where the interactive streams must be
    equal, or bf16, where they are held to the model by ``spec_rescore``)."""
    exact = cfg.dtype == "float32"
    with phase("batch", {"model": MODEL, "layout": "flat step", "dtype": cfg.dtype,
                         "layers": cfg.num_layers, "slots": BATCH_SLOTS,
                         "interactive": BATCH_INTERACTIVE, "batch_jobs": BATCH_JOBS}) as info:
        off = batch_run(params, cfg, backlog=False)
        on = batch_run(params, cfg, backlog=True)
        keep = ("ttft_ms_median", "ttft_ms_max", "tpot_ms_median", "tpot_ms_max", "steps",
                "graph_replays", "graphs_captured_in_run")
        info["without_backlog"] = {k: off[k] for k in keep}
        info["with_backlog"] = {k: v for k, v in on.items()
                                if k not in ("tokens", "logprobs", "batch_streams", "launches")}
        info["batch_streams"] = [len(t) for t in on["batch_streams"]]
        agree = spec_agreement(on["tokens"], on["logprobs"], off["tokens"], off["logprobs"])
        info.update(agree)
        path_launches(info, on["launches"], FLAT_WRAPPERS)
        if len(on["batch_streams"]) != BATCH_JOBS or any(len(t) != 24 for t in on["batch_streams"]):
            raise AssertionError(f"not every batch row finished: {info['batch_streams']}")
        if on["running_batch_rows_at_arrival"] != BATCH_SLOTS or on["batch_preemptions"] <= 0:
            raise AssertionError("the interactive requests did not take slots from running batch "
                                 f"rows: {info['with_backlog']}")
        if on["graph_replays"] <= 0 or off["graph_replays"] <= 0:
            raise AssertionError("no decode step was a graph replay")
        if exact:
            if on["tokens"] != off["tokens"]:
                raise AssertionError(f"the f32 interactive streams changed with the backlog: {agree}")
        else:
            prompts = fixed_prompts(cfg, BATCH_INTERACTIVE, 256, 31)
            ref = spec_rescore(params, cfg, prompts, off["tokens"])
            got = spec_rescore(params, cfg, prompts, on["tokens"])
            info["rescore"], info["rescore_without_backlog"] = got, ref
            if ref["top_gap_max"] <= SPEC_TOP_GAP_TOL < got["top_gap_max"] or (
                    ref["top_gap_max"] > SPEC_TOP_GAP_TOL
                    and got["positions_above_tol"] > SPEC_ABOVE_TOL_FACTOR * ref["positions_above_tol"]):
                raise AssertionError(f"an interactive token with the backlog is not the model's "
                                     f"top at its position: {got}, without: {ref}")
    gc.collect()
    torch.cuda.empty_cache()


def batch_exact_phase(layers: int = 4) -> None:
    """``batch_phase`` on llama-3-8b's widths cut to ``layers`` layers in f32."""
    import dataclasses

    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = dataclasses.replace(get_model_config(MODEL), num_layers=layers, dtype="float32")
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
                               fused=True)
    batch_phase(params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()


OFFLOAD_BLOCKS, OFFLOAD_HOST_PAGES, OFFLOAD_PROMPT = 160, 256, 1000
# The tiered-prefix-cache guide's host budget (``--kv-offload-chunks=25000``,
# deploy/guides/tiered-prefix-cache): the offload server runs with it, the
# whole budget pinned when it starts (``HostPagePool``).
GUIDE_OFFLOAD_CHUNKS = 25_000


def offload_run(params: dict, cfg, kv_dtype: str, fs_dir: str,
                async_scheduling: bool = False) -> dict:
    """The offload sequence of ``offload_phase`` on one engine (warmed up;
    max_num_seqs 16, budget 1024). Returns each request's stream and TTFT
    by label, the host tiers' counters after each restore, Q's restored
    pages against ``scatter_pages``' plain arithmetic, the kernels'
    launches and the host RSS."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.config import CacheConfig, EngineConfig, OffloadConfig, SchedulerConfig
    from llmd_tpu_torch.engine import LLMEngine, SamplingParams
    from llmd_tpu_torch.engine.kv_cache import page_hashes_for_tokens
    from llmd_tpu_torch.ops.quant_kv import quantize_pages

    rss0 = host_rss()
    eng = LLMEngine(EngineConfig(
        model=cfg, cache=CacheConfig(page_size=16, num_blocks=OFFLOAD_BLOCKS, dtype=kv_dtype),
        scheduler=SchedulerConfig(max_num_seqs=16, max_num_batched_tokens=1024,
                                  async_scheduling=async_scheduling),
        seed=0, offload=OffloadConfig(cpu_chunks=OFFLOAD_HOST_PAGES, fs_dir=fs_dir),
    ), params=params, device="cuda")
    eng.warmup()
    P, Q, *junk = fixed_prompts(cfg, 8, OFFLOAD_PROMPT, 41)
    sp = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)
    host = eng._host_cache
    rec: dict = {"tokens": {}, "ttft_ms": {}, "host": {}}
    ops.reset_launch_counts()

    def one(label: str, prompt: list[int]) -> None:
        t0 = time.perf_counter()
        rid = eng.add_request(prompt, sp)
        out, first = [], None
        while eng.has_work():
            for o in eng.step():
                if o.request_id == rid:
                    out += o.new_token_ids
                    if first is None:
                        first = time.perf_counter()
        rec["tokens"][label], rec["ttft_ms"][label] = out, (first - t0) * 1e3
        rec["host"][label] = host.stats()

    one("P recompute", P)
    one("P device hit", P)
    for i, p in enumerate(junk[:3]):
        one(f"junk {i}", p)
    one("Q recompute", Q)
    one("Q device hit", Q)
    for i, p in enumerate(junk[3:]):
        one(f"junk {i + 3}", p)
    hp, hq = (page_hashes_for_tokens(x, 16) for x in (P, Q))
    where = {"P on device": sum(map(eng.allocator.has_cached, hp)),
             "Q on device": sum(map(eng.allocator.has_cached, hq)),
             "P in host DRAM": sum(h in host._pages for h in hp),
             "Q in host DRAM": sum(h in host._pages for h in hq),
             "P in files": sum(h in host._fs_lru for h in hp)}
    rec["before_restores"] = where
    if where != {"P on device": 0, "Q on device": 0, "P in host DRAM": 0,
                 "Q in host DRAM": len(hq), "P in files": len(hp)}:
        raise AssertionError(f"the tiers before the restores are not as planned: {where}")
    one("Q host DRAM restore", Q)
    # Q's restored pages on the device: the plain arithmetic of
    # scatter_pages on its host pages, on the CPU.
    pool = eng.runner.kv_cache
    ids = torch.tensor([eng.allocator._cached[h] for h in hq], device="cuda")
    bundle = torch.stack([host._pages[h] for h in hq], dim=1)  # host tensors, [L, n, ...]
    def equal_plain(b) -> bool:
        if isinstance(pool, tuple):
            data, scales = quantize_pages(b)
            return (torch.equal(pool[0][:, ids].to(b.device), data)
                    and torch.equal(pool[1][:, ids].to(b.device), scales))
        return torch.equal(pool[:, ids].to(b.device), b.to(pool.dtype))

    # The CPU's arithmetic is independent of the restore's (an int8 pool's
    # requantization ran on the card); the card's is reported beside it.
    rec["restored_pages_equal_plain"] = equal_plain(bundle.to(pool_parts(pool)[0].device))
    rec["restored_pages_equal_plain_on_cpu"] = equal_plain(bundle)
    one("P file restore", P)
    torch.cuda.synchronize()
    rec["launches"] = ops.launch_counts()
    rec["host_rss_gb"] = [rss0 / 1e9, host_rss() / 1e9]
    rec["page_bytes"] = int(host._pages[hq[0]].nbytes)
    rec["host_slab_bytes"] = eng.offloader.pool.bytes
    rec["stats"] = {k: getattr(eng.stats, k) for k in (
        "offload_pages", "offload_fs_pages", "offload_saves", "offload_restores",
        "prefix_hit_ratio")}
    rec["save_host_ms"] = eng.offloader.save_host_s * 1e3
    rec["restore_host_ms"] = eng.offloader.restore_host_s * 1e3
    if eng.has_work() or eng.allocator.usage() != 0.0:
        raise AssertionError("the offload engine ended with work or pages held")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def offload_phase(params: dict, model: str, kv_dtype: str, async_too: bool = False) -> None:
    """``offload_run`` on ``model``'s ``kv_dtype`` pool (and with
    ``async_too`` again under async stepping), each in a temporary file
    tier of its own: the restores counted, Q's restored pages equal to the
    plain arithmetic, and the restored streams equal to the device hits'
    on a float pool, whose restored pages are the saved ones byte for byte.
    An int8 pool's host pages are dequantized to the model's dtype, and
    requantizing them rounds a row now and then otherwise (as in JAX): its
    restored streams are held to the model (``spec_rescore``) within the
    device hits' gaps, as ``spec_phase`` holds a run."""
    import tempfile

    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(model)
    wrappers = MLA_WRAPPERS if cfg.is_mla else FLAT_WRAPPERS
    runs = {}
    for mode in (False, True) if async_too else (False,):
        with phase("offload", {"model": model, "kv_cache_dtype": kv_dtype,
                               "async_scheduling": mode, "device_pages": OFFLOAD_BLOCKS,
                               "host_pages": OFFLOAD_HOST_PAGES,
                               "prompt_tokens": OFFLOAD_PROMPT}) as info, \
                tempfile.TemporaryDirectory(prefix="kv-fs-") as fs_dir:
            rec = runs[mode] = offload_run(params, cfg, kv_dtype, fs_dir, mode)
            t, h = rec["tokens"], rec["host"]
            full = OFFLOAD_PROMPT // 16
            dram = h["Q host DRAM restore"]["restores"] - h["junk 5"]["restores"]
            files = h["P file restore"]["fs_loads"] - h["Q host DRAM restore"]["fs_loads"]
            info.update(ttft_ms=rec["ttft_ms"], before_restores=rec["before_restores"],
                        pages_restored_from_dram=dram, pages_restored_from_files=files,
                        restored_pages_equal_plain=rec["restored_pages_equal_plain"],
                        restored_pages_equal_plain_on_cpu=rec["restored_pages_equal_plain_on_cpu"],
                        host_page_bytes=rec["page_bytes"], host_slab_bytes=rec["host_slab_bytes"],
                        host_rss_gb=rec["host_rss_gb"],
                        stats=rec["stats"], save_host_ms=rec["save_host_ms"],
                        restore_host_ms=rec["restore_host_ms"], host_tiers_end=h["P file restore"],
                        restored_equal_recompute={"Q": t["Q host DRAM restore"] == t["Q recompute"],
                                                  "P": t["P file restore"] == t["P recompute"]})
            path_launches(info, rec["launches"], wrappers)
            if (dram, files) != (full, full):
                raise AssertionError(f"{dram} pages restored from host DRAM, {files} from files; "
                                     f"want {full} each")
            hit = [t["Q device hit"], t["P device hit"]]
            restored = [t["Q host DRAM restore"], t["P file restore"]]
            info["restored_equal_device_hit"] = restored == hit
            if kv_dtype == "int8":
                prompts = fixed_prompts(cfg, 2, OFFLOAD_PROMPT, 41)[::-1]  # Q, P
                ref = spec_rescore(params, cfg, prompts, hit)
                got = spec_rescore(params, cfg, prompts, restored)
                info["rescore"], info["rescore_device_hit"] = got, ref
                if ref["top_gap_max"] <= SPEC_TOP_GAP_TOL < got["top_gap_max"] or (
                        ref["top_gap_max"] > SPEC_TOP_GAP_TOL and got["positions_above_tol"]
                        > SPEC_ABOVE_TOL_FACTOR * ref["positions_above_tol"]):
                    raise AssertionError(f"a restored token is not the model's top at its "
                                         f"position: {got}, device hits: {ref}")
            elif restored != hit:
                raise AssertionError("a restored stream differs from its device hit's")
            if not rec["restored_pages_equal_plain_on_cpu"]:
                raise AssertionError("Q's restored pages differ from scatter_pages' plain "
                                     "arithmetic on the CPU")
            if any(len(x) != 16 for x in t.values()):
                raise AssertionError("not every request produced 16 tokens")
            if mode:
                sync = runs[False]
                info["tokens_equal_sync"] = t == sync["tokens"]
                info["host_tiers_equal_sync"] = h == sync["host"]
                if t != sync["tokens"] or h != sync["host"]:
                    raise AssertionError("the async offload run's streams or host tiers differ "
                                         "from the sync run's")
        gc.collect()
        torch.cuda.empty_cache()


def offload_batch_serve_check(info: dict, base: str) -> None:
    """The async offload server (``--kv-offload-chunks``,
    ``--kv-offload-fs-dir``, a 160-page pool): a 1,000-token prompt twice
    (the second a device hit), four others (two with ``x-llmd-priority:
    batch``) that push it out of the device pool, then again: restored from
    the host tier, it answers as its device hit did (Generate's token ids);
    /metrics counts the saves, the restores and the batch tokens."""
    from llmd_tpu_torch.models.registry import get_model_config

    async_serve_check(info, base)
    prompts = fixed_prompts(get_model_config(MODEL), 5, OFFLOAD_PROMPT, 51)

    sampling = {"max_tokens": 16, "temperature": 0.0, "ignore_eos": True}

    def generate(prompt, headers=None) -> list[int]:
        """Generate's token ids (random weights' tokens mostly decode to
        no text with the byte tokenizer)."""
        req = urllib.request.Request(
            base + "/vllm.Generation/Generate", data=json.dumps({
                "prompt_token_ids": prompt, "sampling_params": sampling}).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())["token_ids"]

    P = prompts[0]
    texts = [generate(P), generate(P)]
    for i, junk in enumerate(prompts[1:]):
        generate(junk, {"x-llmd-priority": "batch"} if i % 2 else None)
    texts.append(generate(P))
    metrics, _ = _scrape(base)
    info.update({k: metrics.get(f"llmd:{k}") for k in (
        "kv_offload_saves_total", "kv_offload_restores_total", "batch_tokens_total")})
    info["kv_offload_cpu_pages"] = metrics.get("vllm:kv_offload_cpu_pages",
                                               metrics.get("llmd:kv_offload_cpu_pages"))
    info["restored_tokens_equal_device_hit"] = texts[2] == texts[1]
    info["restored_tokens_equal_recompute"] = texts[2] == texts[0]
    if not (info["kv_offload_saves_total"] and info["kv_offload_restores_total"]
            and info["batch_tokens_total"]):
        raise AssertionError(f"offload or batch series not counted: {info}")
    if texts[2] != texts[1] or len(texts[2]) != 16:
        raise AssertionError(f"the restored prompt answered {texts[2]}, its device hit {texts[1]}")


# --------------------------------------------------------------------- #
# P/D disaggregation (``kvtransfer/connector.py``): a producer engine
# exports a finished prefill's KV, a consumer engine imports it.

PD_PROMPT, PD_TOKENS, PD_PROMPTS = 1000, 32, 8


def pd_engine(cfg, params: dict, role: str | None, window: int = 1, fast: bool = False,
              swa_ring: bool = False, warm: bool = False):
    """An engine of the P/D pair (or, ``role`` None, the aggregated one):
    page 16, 2,048 pages, 16 slots, budget 1,024, the shipper on a free
    port; ``window`` its decode window (the chart's decode tier: 8)."""
    from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from llmd_tpu_torch.engine import LLMEngine

    eng = LLMEngine(EngineConfig(
        model=cfg, cache=CacheConfig(page_size=16, num_blocks=2048, dtype=cfg.dtype,
                                     swa_ring=swa_ring),
        scheduler=SchedulerConfig(max_num_seqs=16, max_num_batched_tokens=1024,
                                  decode_window=window),
        seed=0, kv_role=role, kv_transfer_port=0, kv_local_fastpath=fast,
    ), params=params, device="cuda")
    if warm:
        eng.warmup()
    return eng


class LaunchLog:
    """Kernel launches by engine: the counts' moves around each call made
    for that engine (one thread drives both; the transfer's threads launch
    no kernel)."""

    def __init__(self) -> None:
        from llmd_tpu_torch import ops

        self.ops = ops
        self.by: dict[str, collections.Counter] = {}

    def __call__(self, who: str, fn, *a, **k):
        before = self.ops.launch_counts()
        out = fn(*a, **k)
        after = self.ops.launch_counts()
        self.by.setdefault(who, collections.Counter()).update(
            {n: after[n] - before[n] for n in after if after[n] != before[n]})
        return out


def aggregated_request(eng, prompt: list[int], sp, log: LaunchLog | None = None) -> dict:
    """One request alone on an engine: its tokens and its TTFT."""
    t0 = time.perf_counter()
    rid = eng.add_request(list(prompt), sp)
    toks, first = [], None
    while eng.has_work():
        outs = log("aggregated", eng.step) if log else eng.step()
        for o in outs:
            if o.request_id == rid:
                if first is None and o.new_token_ids:
                    torch.cuda.synchronize()
                    first = time.perf_counter()
                toks += o.new_token_ids
    return {"tokens": toks, "ttft_ms": (first - t0) * 1e3}


def settle(eng) -> None:
    """Wait for a producer's staging threads to end."""
    deadline = time.perf_counter() + 120
    while eng.kv_connector._staging_active:
        if time.perf_counter() > deadline:
            raise TimeoutError("a producer's staging thread did not end in 120 s")
        time.sleep(0.002)


def pd_request(producer, consumer, prompt: list[int], sp, log: LaunchLog) -> dict:
    """The sidecar's two phases in one process: the producer's one-token
    prefill with ``do_remote_decode`` (eager-ACK: its token is not read
    back), then the consumer's request with its params (the import runs
    in ``add_request``). Returns the stream, TTFT and its split (the
    producer's answer: its step's host ms and the export's share of it,
    whether the compute stream was still busy then and how long it ran
    on, waited for before the import; the consumer's fetch and apply, the
    rest to the first token), the legs' seconds and bytes, and the
    params."""
    from llmd_tpu_torch.engine import SamplingParams

    t0 = time.perf_counter()
    producer.add_request(list(prompt), SamplingParams(temperature=0.0, max_tokens=1),
                         kv_transfer_params={"do_remote_decode": True})
    params = None
    while producer.has_work():
        for o in log("producer", producer.step):
            params = o.kv_transfer_params if o.finished else params
    t_answer = time.perf_counter()
    # Eager-ACK: is the prefill (and the export's gathers after it) still
    # on the compute stream when the answer is out, and for how long.
    stream = torch.cuda.current_stream()
    busy = not stream.query()
    stream.synchronize()
    device_after_answer_ms = (time.perf_counter() - t_answer) * 1e3
    t_answer_done = time.perf_counter()
    rid = log("consumer", consumer.add_request, list(prompt), sp, kv_transfer_params=params)
    t_added = time.perf_counter()
    import_ms = (t_added - t_answer_done) * 1e3
    toks, first = [], None
    while consumer.has_work():
        for o in log("consumer", consumer.step):
            if o.request_id == rid:
                if first is None and o.new_token_ids:
                    first = time.perf_counter()
                toks += o.new_token_ids
    settle(producer)
    pc, cc = producer.kv_connector, consumer.kv_connector
    return {"tokens": toks, "params": params,
            "ttft_ms": (first - t0) * 1e3, "answer_ms": (t_answer - t0) * 1e3,
            "device_busy_at_answer": busy, "device_after_answer_ms": device_after_answer_ms,
            "producer_step_host_ms": producer.stats.step_host_gap_ms,
            "export_ms": producer.kv_connector.last_export_ms,
            "import_ms": import_ms, "to_first_token_ms": (first - t_added) * 1e3,
            "last_stage_ms": pc.last_stage_ms, "last_fetch_ms": cc.last_fetch_ms,
            "last_apply_ms": cc.last_apply_ms, "staged_bytes": pc.last_staged_bytes,
            "download_s": pc.last_download_s, "register_s": pc.last_register_s,
            "pull_s": cc.last_pull_s, "pulled_bytes": cc.last_pulled_bytes}


def transfer_bytes(cfg, n_full: int, cp: int, groups: list, wire: str, dtype_name: str) -> int:
    """The wire bytes of one export by arithmetic: layers x pages x page
    bytes a cell (chunks padded to ``cp`` pages), its header (27 bytes, the
    dtype's name, the group extension when grouped, the CRC), and in the q8
    form int8 rows and two f16 scales a row."""
    chunks = -(-n_full // cp)
    name = ("int8q:" + dtype_name) if wire == "int8" else dtype_name
    header = 27 + len(name) + (6 if len(groups) > 1 else 0) + 4
    rows_per_layer = cp * cfg.kv_cache_heads * 16
    item = 1 if wire == "int8" else torch.empty((), dtype=getattr(torch, dtype_name)).element_size()
    total = 0
    for _, lg in groups:
        payload = lg * rows_per_layer * cfg.kv_cache_entry_dim * item
        if wire == "int8":
            payload += lg * rows_per_layer * 4
        total += chunks * (header + payload)
    return total


def prompt_pages(eng, prompt: list[int]) -> list[int]:
    """The pool pages holding a prompt's full pages in an engine's prefix
    cache."""
    from llmd_tpu_torch.engine.kv_cache import page_hashes_for_tokens

    return [eng.allocator._cached[h] for h in page_hashes_for_tokens(prompt, 16)]


def held_to_model(info: dict, params: dict, cfg, prompts: list, got: list, ref: list,
                  what: str, rescore=None) -> None:
    """``got``'s every greedy token held to the model (``rescore``, by
    default ``spec_rescore``) within the reference streams' gaps, as
    ``batch_phase`` holds a run."""
    rescore = rescore or spec_rescore
    want = rescore(params, cfg, prompts, ref)
    have = rescore(params, cfg, prompts, got)
    info[f"rescore_{what}"], info["rescore_aggregated"] = have, want
    info[f"streams_equal_aggregated_{what}"] = sum(a == b for a, b in zip(got, ref))
    if want["top_gap_max"] <= SPEC_TOP_GAP_TOL < have["top_gap_max"] or (
            want["top_gap_max"] > SPEC_TOP_GAP_TOL
            and have["positions_above_tol"] > SPEC_ABOVE_TOL_FACTOR * want["positions_above_tol"]):
        raise AssertionError(f"a {what} token is not the model's top at its position: {have}, "
                             f"aggregated: {want}")


def pd_exact_phase(layers: int = 4) -> None:
    """llama-3-8b's widths cut to ``layers`` layers in f32: P/D pairs with
    the in-process fast path on and off and 1 and 4 layer groups give the
    aggregated engine's streams token for token, and the pages imported
    through the exact wire (or claimed on the device) equal the
    producer's pool pages bit for bit."""
    import dataclasses

    from llmd_tpu_torch.engine import SamplingParams
    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = dataclasses.replace(get_model_config(MODEL), num_layers=layers, dtype="float32")
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
                               fused=True)
    sp = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)
    prompts = fixed_prompts(cfg, 8, 300, 61)
    agg = pd_engine(cfg, params, None)
    want = [aggregated_request(agg, p, sp)["tokens"] for p in prompts]
    del agg
    producer = pd_engine(cfg, params, "kv_producer", fast=True)
    consumer = pd_engine(cfg, params, "kv_consumer", fast=True)
    try:
        for v, (fast, groups) in enumerate([(False, 1), (False, 4), (True, 1), (True, 4)]):
            with phase("pd_exact", {"model": MODEL, "layers": layers, "dtype": "float32",
                                    "local_fastpath": fast, "stream_groups": groups}) as info:
                producer.kv_connector.cfg.stream_groups = groups
                consumer.kv_connector.cfg.local_fastpath = fast
                log = LaunchLog()
                ps = prompts[2 * v : 2 * v + 2]
                local0 = consumer.kv_connector.local_imports
                runs = [pd_request(producer, consumer, p, sp, log) for p in ps]
                tokens = [r["tokens"] for r in runs]
                equal_pages = [
                    all(torch.equal(producer.runner.kv_cache[:, a], consumer.runner.kv_cache[:, b])
                        for a, b in zip(prompt_pages(producer, p), prompt_pages(consumer, p)))
                    for p in ps]
                info.update(streams_equal_aggregated=tokens == want[2 * v : 2 * v + 2],
                            pages_bit_equal=equal_pages,
                            num_groups=runs[0]["params"].get("num_groups", 1),
                            local_imports=consumer.kv_connector.local_imports - local0,
                            ttft_ms=[r["ttft_ms"] for r in runs],
                            launches={k: dict(c) for k, c in log.by.items()})
                path_launches(info, dict(log.by["producer"]), FLAT_WRAPPERS)
                path_launches(info, dict(log.by["consumer"]), FLAT_WRAPPERS)
                info["launches"] = {k: dict(c) for k, c in log.by.items()}
                if tokens != want[2 * v : 2 * v + 2]:
                    raise AssertionError("a P/D stream differs from the aggregated engine's")
                if not all(equal_pages):
                    raise AssertionError("imported pages differ from the producer's")
                if info["local_imports"] != (len(ps) if fast else 0):
                    raise AssertionError(f"{info['local_imports']} in-process claims")
                if consumer.kv_connector.import_failures:
                    raise AssertionError("an import failed")
    finally:
        producer.close()
        consumer.close()
    del producer, consumer, params
    gc.collect()
    torch.cuda.empty_cache()


def q8_codec_times(snap: torch.Tensor) -> dict:
    """The q8 codec (plain PyTorch) on one export cell on the card: device
    ms of the quantization and the dequantization beside their byte
    bounds (the cell read once, int8 rows and f16 scales written once)."""
    from llmd_tpu_torch.ops.quant_kv import dequantize_rows_q8, quantize_rows_q8

    rows = snap.numel() // snap.shape[-1]
    in_b = snap.numel() * snap.element_size()
    out_b = snap.numel() + rows * 4
    q, s = quantize_rows_q8(snap)
    q_ms = cuda_ms(lambda: quantize_rows_q8(snap))
    d_ms = cuda_ms(lambda: dequantize_rows_q8(q, s, snap.dtype))
    bound_ms = (in_b + out_b) / HBM_BYTES_PER_S * 1e3
    return {"cell_shape": list(snap.shape), "cell_bytes": in_b, "wire_bytes": out_b,
            "quantize_ms": q_ms, "dequantize_ms": d_ms, "bound_ms": bound_ms,
            "quantize_over_bound": q_ms / bound_ms, "dequantize_over_bound": d_ms / bound_ms}


def pd_phase(params: dict, cfg) -> None:
    """llama-3-8b in bf16 at full width and depth: 8 prompts of 1,000
    tokens, 32 greedy tokens, one at a time, on the aggregated engine
    (windows of 8) and through a P/D pair (producer on the flat step,
    consumer the chart's decode tier: windows of 8), over TCP on the v3
    wire, exact and int8. Reports TTFT both ways and its split, the
    staging legs' GB/s, the bytes against their arithmetic, the q8 codec
    against its bound and each engine's launches; streams are held to the
    model (``held_to_model``), int8 wire pages to JAX's per-row bound."""
    from llmd_tpu_torch.engine import SamplingParams
    from llmd_tpu_torch.kvtransfer.connector import layer_groups

    sp = SamplingParams(temperature=0.0, max_tokens=PD_TOKENS, ignore_eos=True)
    sets = {"auto": fixed_prompts(cfg, PD_PROMPTS, PD_PROMPT, 71),
            "int8": fixed_prompts(cfg, PD_PROMPTS, PD_PROMPT, 72)}
    agg = pd_engine(cfg, params, None, window=8, warm=True)
    aggregated_request(agg, [5] * PD_PROMPT, sp)  # warm steps
    alog = LaunchLog()
    ref = {w: [aggregated_request(agg, p, sp, alog) for p in ps] for w, ps in sets.items()}
    del agg
    gc.collect()
    torch.cuda.empty_cache()
    producer = pd_engine(cfg, params, "kv_producer")
    consumer = pd_engine(cfg, params, "kv_consumer", window=8, warm=True)
    try:
        pd_request(producer, consumer, [7] * PD_PROMPT, sp, LaunchLog())  # warm steps
        for wire, prompts in sets.items():
            with phase("pd", {"model": MODEL, "dtype": cfg.dtype, "wire": wire,
                              "prompts": PD_PROMPTS, "prompt_tokens": PD_PROMPT,
                              "max_tokens": PD_TOKENS, "consumer_decode_window": 8}) as info:
                producer.kv_connector.cfg.transfer_dtype = wire
                log = LaunchLog()
                pc, cc = producer.kv_connector, consumer.kv_connector
                exported0, imported0 = pc.stats()["exported_bytes"], cc.imported_bytes
                runs = [pd_request(producer, consumer, p, sp, log) for p in prompts]
                n_full, groups = PD_PROMPT // 16, layer_groups(cfg.num_layers, 4)
                want_bytes = PD_PROMPTS * transfer_bytes(cfg, n_full, 8, groups, wire, cfg.dtype)
                med = lambda k: statistics.median(r[k] for r in runs)  # noqa: E731
                info.update(
                    ttft_ms_aggregated=[r["ttft_ms"] for r in ref[wire]],
                    ttft_ms_pd=[r["ttft_ms"] for r in runs],
                    ttft_ms_median={"aggregated": statistics.median(r["ttft_ms"] for r in ref[wire]),
                                    "pd": med("ttft_ms")},
                    split_ms_median={k: med(k) for k in (
                        "answer_ms", "producer_step_host_ms", "export_ms",
                        "device_after_answer_ms", "import_ms", "to_first_token_ms",
                        "last_stage_ms", "last_fetch_ms", "last_apply_ms")},
                    answers_before_prefill_end=sum(r["device_busy_at_answer"] for r in runs),
                    answer_ms=[r["answer_ms"] for r in runs],
                    device_after_answer_ms=[r["device_after_answer_ms"] for r in runs],
                    legs_gb_s={"d2h": statistics.median(r["staged_bytes"] / r["download_s"] / 1e9
                                                        for r in runs),
                               "register": statistics.median(r["staged_bytes"] / r["register_s"] / 1e9
                                                             for r in runs),
                               "pull": statistics.median(r["pulled_bytes"] / r["pull_s"] / 1e9
                                                         for r in runs),
                               "land": statistics.median(
                                   r["pulled_bytes"] / (r["last_fetch_ms"] / 1e3 - r["pull_s"]) / 1e9
                                   for r in runs)},
                    staged_bytes_per_export=runs[0]["staged_bytes"],
                    exported_bytes=pc.stats()["exported_bytes"] - exported0,
                    imported_bytes=cc.imported_bytes - imported0, bytes_by_arithmetic=want_bytes,
                    num_groups=runs[0]["params"].get("num_groups", 1),
                    launches={k: dict(c) for k, c in log.by.items()},
                    launches_aggregated=dict(alog.by.get("aggregated", {})))
                if info["exported_bytes"] != want_bytes or info["imported_bytes"] != want_bytes:
                    raise AssertionError(f"bytes exported {info['exported_bytes']}, imported "
                                         f"{info['imported_bytes']}, by arithmetic {want_bytes}")
                path_launches(info, dict(log.by["producer"]), FLAT_WRAPPERS)
                path_launches(info, dict(log.by["consumer"]),
                              ("decode_paged_attention_full", "write_kv_pages_decode_full",
                               *FLAT_WRAPPERS))
                info["launches"] = {k: dict(c) for k, c in log.by.items()}
                if cc.import_failures:
                    raise AssertionError(f"{cc.import_failures} imports failed")
                held_to_model(info, params, cfg, prompts, [r["tokens"] for r in runs],
                              [r["tokens"] for r in ref[wire]], "pd")
                if wire == "int8":
                    rels = []
                    for p in prompts:
                        a = producer.runner.kv_cache[:, prompt_pages(producer, p)].float()
                        b = consumer.runner.kv_cache[:, prompt_pages(consumer, p)].float()
                        D = a.shape[-1] // 2
                        rels.append([((b[..., h] - a[..., h]).norm() / a[..., h].norm()).item()
                                     for h in (slice(None), slice(0, D), slice(D, None))])
                    info["q8_page_rel_err_max"] = max(max(r) for r in rels)
                    if info["q8_page_rel_err_max"] >= 0.01:
                        raise AssertionError(f"q8 pages beyond rel 0.01: {rels}")
                    ids = prompt_pages(producer, prompts[0])[:8]
                    info["q8_codec"] = q8_codec_times(
                        producer.runner.snapshot_pages_device(ids, 8, layers=groups[0]))
    finally:
        producer.close()
        consumer.close()
    del producer, consumer
    gc.collect()
    torch.cuda.empty_cache()


def pd_cut_phase(model: str, layers: int, swa_ring: bool = False) -> None:
    """A P/D pair of ``model`` cut to ``layers`` layers in bf16 (exact
    wire, TCP), 4 prompts of 1,000 tokens, 16 greedy tokens, beside the
    aggregated engine: deepseek-v2-lite's latent pool, gpt-oss-20b in its
    ring (the export carries the sliding section; the consumer preloads
    the pages and a fresh ring). Streams held to the model; launches
    checked on both engines."""
    import dataclasses

    from llmd_tpu_torch.engine import SamplingParams
    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.registry import get_model_config

    base = get_model_config(model)
    cut = {"layer_types": base.layer_types[:layers]} if base.layer_types else {}
    cfg = dataclasses.replace(base, num_layers=layers, **cut)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
                               fused=not cfg.is_mla)
    if model == OSS_MODEL:
        fill_biases(params, seed=3)
    wrappers = MLA_WRAPPERS if cfg.is_mla else FLAT_WRAPPERS
    sp = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)
    prompts = fixed_prompts(cfg, 4, PD_PROMPT, 81)
    with phase("pd", {"model": model, "layers": layers, "dtype": cfg.dtype, "wire": "auto",
                      "kv_swa_ring": swa_ring}) as info:
        agg = pd_engine(cfg, params, None, swa_ring=swa_ring)
        ref = [aggregated_request(agg, p, sp) for p in prompts]
        del agg
        producer = pd_engine(cfg, params, "kv_producer", swa_ring=swa_ring)
        consumer = pd_engine(cfg, params, "kv_consumer", swa_ring=swa_ring)
        try:
            log = LaunchLog()
            runs = [pd_request(producer, consumer, p, sp, log) for p in prompts]
            cc = consumer.kv_connector
            info.update(ttft_ms_aggregated=[r["ttft_ms"] for r in ref],
                        ttft_ms_pd=[r["ttft_ms"] for r in runs],
                        swa_pages=[r["params"]["swa_pages"] for r in runs],
                        num_groups=runs[0]["params"].get("num_groups", 1),
                        imported_requests=cc.imported_requests,
                        imported_bytes=cc.imported_bytes, import_failures=cc.import_failures)
            # The producer only prefills: an MLA prefill's latent attention
            # is the plain Q > 1 form (K5' is the decode kernel).
            path_launches(info, dict(log.by["producer"]),
                          tuple(w for w in wrappers if w != "mla_decode_paged_attention_full"))
            path_launches(info, dict(log.by["consumer"]), wrappers)
            info["launches"] = {k: dict(c) for k, c in log.by.items()}
            if cc.imported_requests != len(prompts) or cc.import_failures:
                raise AssertionError(f"imports {cc.imported_requests}, failures "
                                     f"{cc.import_failures}")
            if swa_ring and not all(info["swa_pages"]):
                raise AssertionError("a ring export carried no sliding section")
            held_to_model(info, params, cfg, prompts, [r["tokens"] for r in runs],
                          [r["tokens"] for r in ref], "pd")
        finally:
            producer.close()
            consumer.close()
    del producer, consumer, params
    gc.collect()
    torch.cuda.empty_cache()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_server(args: list[str], log_name: str, port: int | None = None):
    """A server process on ``port`` (default: a free one) with ``args``;
    (process, base URL, port, log path). The caller waits for its health
    and stops it."""
    port = port or free_port()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    log_path = os.path.join(REPO, "build", log_name)
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "llmd_tpu_torch.serve", "--host", "127.0.0.1",
             "--port", str(port), *args], cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    return proc, f"http://127.0.0.1:{port}", port, log_path


def wait_healthy(servers: list, limit_s: float = 600) -> float:
    t0 = time.perf_counter()
    pending = list(servers)
    while pending:
        for s in list(pending):
            proc, base, _, log_path = s
            if proc.poll() is not None:
                raise RuntimeError(f"server exited with {proc.returncode}; see {log_path}")
            try:
                with urllib.request.urlopen(base + "/health", timeout=5) as r:
                    if r.status == 200:
                        pending.remove(s)
            except OSError:
                pass
        if time.perf_counter() - t0 > limit_s:
            raise TimeoutError(f"servers not healthy in {limit_s} s")
        time.sleep(0.5)
    return time.perf_counter() - t0


def stop_server(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


class ZmtpSubReader:
    """A SUB side of the KV events: a TCP peer speaking ZMTP 3.1 with
    ``events/zmtp.py``'s framing, subscribed to ``topic``; a thread keeps
    each message as (arrival ``perf_counter``, seq, payload)."""

    def __init__(self, host: str, port: int, topic: bytes = b"kv-events") -> None:
        from llmd_tpu_torch.events import zmtp

        self._zmtp = zmtp
        self.sock = socket.create_connection((host, port), timeout=30)
        self.sock.sendall(zmtp.GREETING + zmtp.ready("SUB") + zmtp.command(b"SUBSCRIBE", topic))
        self.sock.settimeout(0.2)
        self.greeted = threading.Event()
        self.messages: list[tuple[float, int, dict]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        zmtp, head, parser, parts = self._zmtp, b"", self._zmtp.FrameParser(), []
        while not self._stop.is_set():
            try:
                data = self.sock.recv(1 << 20)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data:
                return
            t = time.perf_counter()
            if not self.greeted.is_set():
                head += data
                if len(head) < zmtp.GREETING_SIZE:
                    continue
                zmtp.check_greeting(head[: zmtp.GREETING_SIZE])
                data = head[zmtp.GREETING_SIZE:]
                self.greeted.set()
            for flags, body in parser.feed(data):
                if flags & zmtp.FLAG_COMMAND:
                    continue
                parts.append(body)
                if not flags & zmtp.FLAG_MORE:
                    if len(parts) == 3:
                        self.messages.append((t, struct.unpack(">Q", parts[1])[0],
                                              json.loads(parts[2])))
                    parts = []

    def wait_seq(self, seq: int, limit_s: float = 60) -> None:
        t0 = time.perf_counter()
        while not any(m[1] >= seq for m in list(self.messages)):
            if time.perf_counter() - t0 > limit_s:
                raise TimeoutError(f"no KV-event batch {seq} in {limit_s} s")
            time.sleep(0.01)

    def events(self) -> list[dict]:
        return [e for _, _, payload in self.messages for e in payload["events"]]

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self.sock.close()


ES_BLOCKS, ES_HOST_A, ES_HOST_B, ES_PROMPTS, ES_TOKENS = 160, 128, 512, 4, 16


def start_master(log_name: str):
    """``python -m llmd_tpu_torch.kvstore`` on a free port; (process, URL)."""
    port = free_port()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", log_name), "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "llmd_tpu_torch.kvstore", "--host",
                                 "127.0.0.1", "--port", str(port)], cwd=REPO, stdout=log,
                                stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"the kvstore master exited with {proc.returncode}")
        try:
            with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                if r.status == 200:
                    return proc, url
        except OSError:
            pass
        if time.perf_counter() - t0 > 60:
            stop_server(proc)
            raise TimeoutError("the kvstore master did not start in 60 s")
        time.sleep(0.1)


def events_store_phase(params: dict, cfg) -> None:
    """The KV events and the cross-slice store on llama-3-8b (the module
    docstring's ``events_store``): two engines on one master, A publishing
    and B fetching, A's events read by ``ZmtpSubReader``; then the chart's
    decode-tier server on the same master."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.config import CacheConfig, EngineConfig, OffloadConfig, SchedulerConfig
    from llmd_tpu_torch.engine import LLMEngine, SamplingParams
    from llmd_tpu_torch.events import ZMQEventSink
    from llmd_tpu_torch.federation import core as fcore

    # Host seconds of the store's parts, by the thread that spends them.
    split: dict[str, float] = collections.defaultdict(float)
    calls: collections.Counter = collections.Counter()
    split_lock = threading.Lock()

    def timed(fn, key: str):
        def wrap(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                with split_lock:
                    split[key] += time.perf_counter() - t
                    calls[key] += 1
        return wrap

    encode_page, decode_page = fcore.encode_page, fcore.decode_page
    fcore.encode_page = timed(encode_page, "encode_page (publisher thread)")
    fcore.decode_page = timed(decode_page, "decode_page (engine thread)")
    master, url = start_master("chip_smoke_kvstore_master.log")
    sink = reader = a = b = None
    try:
        with phase("events_store", {"model": MODEL, "dtype": cfg.dtype, "device_pages": ES_BLOCKS,
                                    "host_pages": [ES_HOST_A, ES_HOST_B], "prompts": ES_PROMPTS,
                                    "prompt_tokens": OFFLOAD_PROMPT,
                                    "max_tokens": ES_TOKENS}) as info:
            sink = ZMQEventSink("tcp://127.0.0.1:0", pod="engine-a")
            sent: dict[int, float] = {}
            send = sink._sock.send_multipart

            def timed_send(frames):
                sent[struct.unpack(">Q", frames[1])[0]] = time.perf_counter()
                return send(frames)

            sink._sock.send_multipart = timed_send
            reader = ZmtpSubReader("127.0.0.1", int(sink.endpoint.rsplit(":", 1)[1]))
            t0 = time.perf_counter()
            while sink.subscriber_count() != 1:
                if time.perf_counter() - t0 > 30:
                    raise TimeoutError("the SUB reader never subscribed")
                time.sleep(0.01)

            def engine(host_pages: int, policy: str, event_sink=None):
                return LLMEngine(EngineConfig(
                    model=cfg, cache=CacheConfig(page_size=16, num_blocks=ES_BLOCKS),
                    scheduler=SchedulerConfig(max_num_seqs=16, max_num_batched_tokens=1024),
                    seed=0, offload=OffloadConfig(
                        cpu_chunks=host_pages, store_master_url=url, store_segment_bytes=1 << 30,
                        publish_policy=policy)), params=params, device="cuda", event_sink=event_sink)

            a = engine(ES_HOST_A, "save", sink)
            b = engine(ES_HOST_B, "off")
            a._kvstore_client.put = timed(a._kvstore_client.put, "put (publisher thread)")
            a.offloader.flush = timed(a.offloader.flush, "save flush (engine thread)")
            prompts = fixed_prompts(cfg, ES_PROMPTS, OFFLOAD_PROMPT, 51)
            sp = SamplingParams(temperature=0.0, max_tokens=ES_TOKENS, ignore_eos=True)

            def one(eng, prompt: list[int]) -> tuple[list[int], float]:
                t = time.perf_counter()
                rid = eng.add_request(prompt, sp)
                out, first = [], None
                while eng.has_work():
                    for o in eng.step():
                        if o.request_id == rid:
                            out += o.new_token_ids
                            if first is None:
                                first = time.perf_counter()
                return out, (first - t) * 1e3

            ops.reset_launch_counts()
            t0 = time.perf_counter()
            ran_a, hit_a = [], []
            for p in prompts:
                ran_a.append(one(a, p))  # a recompute
                hit_a.append(one(a, p))  # a device hit: a store hit's step shapes
            a._kvstore_client.flush_publishes(120)
            sink.flush()
            a_s = time.perf_counter() - t0
            pulls: list[tuple[int, float]] = []
            get_many = b._kvstore_client.get_many

            def timed_get_many(keys):
                t = time.perf_counter()
                got = get_many(keys)
                pulls.append((sum(len(v) for v in got.values()), time.perf_counter() - t))
                return got

            b._kvstore_client.get_many = timed_get_many
            ran_b = [one(b, p) for p in prompts]
            dram0 = b._host_cache.stats()["restores"]
            hit_tokens, hit_ms = one(b, prompts[0])
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            b._refresh_gauges()
            a._refresh_gauges()
            full = OFFLOAD_PROMPT // 16
            st = b.stats
            info.update(
                ttft_ms={"recompute (A)": [r[1] for r in ran_a], "device hit (A)": [r[1] for r in hit_a],
                         "store hit (B)": [r[1] for r in ran_b], "host DRAM hit (B)": hit_ms},
                ttft_median_ms={"recompute": statistics.median(r[1] for r in ran_a),
                                "device hit": statistics.median(r[1] for r in hit_a),
                                "store hit": statistics.median(r[1] for r in ran_b),
                                "host DRAM hit": hit_ms},
                store_pulls=len(pulls), store_pull_bytes=sum(n for n, _ in pulls),
                store_pull_gb_s=sum(n for n, _ in pulls) / max(1e-9, sum(t for _, t in pulls)) / 1e9,
                store_pull_ms=[t * 1e3 for _, t in pulls],
                host_dram_pages_restored=b._host_cache.stats()["restores"] - dram0,
                b_stats={k: getattr(st, k) for k in (
                    "kvstore_pulls", "kvstore_pull_failures", "kvstore_misses",
                    "kv_federation_hits", "recompute_avoided_tokens", "offload_restores")},
                a_stats={k: getattr(a.stats, k) for k in (
                    "kv_federation_published", "offload_saves", "offload_pages",
                    "kv_publish_paced_bytes_total")},
                a_client=a._kvstore_client.stats(),
                split_ms={k: v * 1e3 for k, v in split.items()}, split_calls=dict(calls),
                # A hit computes the prompt's tail over restored pages: B
                # is held byte for byte to A's device hits, whose steps are
                # B's, on the same page bytes, and each of its tokens to the
                # model within the recompute's gaps (``held_to_model``):
                # in bf16 a hit's stream may part from the recompute's
                # where the top two logprobs tie.
                tokens_equal={"store hit": [r[0] for r in ran_b] == [h[0] for h in hit_a],
                              "host DRAM hit": hit_tokens == hit_a[0][0]},
                store_hit_equals_recompute=[r[0] == q[0] for r, q in zip(ran_b, ran_a)])
            path_launches(info, counts, FLAT_WRAPPERS)
            if not all(info["tokens_equal"].values()):
                raise AssertionError(f"B's streams differ from A's device hits: "
                                     f"{info['tokens_equal']}")
            if any(len(r[0]) != ES_TOKENS for r in ran_a + hit_a):
                raise AssertionError("not every request produced its tokens")
            held_to_model(info, params, cfg, prompts, [r[0] for r in ran_b],
                          [r[0] for r in ran_a], "events_store")
            store_pages = ES_PROMPTS * full
            if not (st.kv_federation_hits == st.kvstore_pulls == b.offloader.store_pages_committed
                    == store_pages and st.recompute_avoided_tokens == store_pages * 16):
                raise AssertionError(f"store counters: {info['b_stats']}, committed "
                                     f"{b.offloader.store_pages_committed}, want {store_pages}")
            if info["host_dram_pages_restored"] <= 0:
                raise AssertionError("B's repeat restored nothing from host DRAM")
            # A's events: every batch, numbered from 0 with no gap.
            last = sink._seq - 1
            reader.wait_seq(last)
            seqs = [m[1] for m in reader.messages]
            events = reader.events()
            stored = collections.Counter(e["medium"] for e in events if e["type"] == "BlockStored")
            removed = sum(1 for e in events if e["type"] == "BlockRemoved")
            lat = [(t - sent[q]) * 1e3 for t, q, _ in reader.messages]
            info.update(events=len(events), batches=len(seqs), stored_by_medium=dict(stored),
                        removed=removed, events_per_s=len(events) / a_s, a_seconds=a_s,
                        publish_to_receive_ms={"median": statistics.median(lat),
                                               "max": max(lat)},
                        publish_failures=sink.publish_failures, dropped=sink.dropped)
            if seqs != list(range(last + 1)):
                raise AssertionError(f"KV-event batches {seqs[:8]}... are not 0..{last} with no gap")
            if {"gpu", "cpu", "store"} - set(stored) or not removed:
                raise AssertionError(f"events: stored {dict(stored)}, removed {removed}")
            if stored["store"] != a._federation.stats()["published"]:
                raise AssertionError(f"{stored['store']} store events for "
                                     f"{a._federation.stats()['published']} publications")
            b.close()
            b = None
            gc.collect()
            torch.cuda.empty_cache()
            serve_store_check(info, url, prompts[0], hit_a[0][0])
    finally:
        fcore.encode_page, fcore.decode_page = encode_page, decode_page
        for x in (reader, sink, b, a):
            if x is not None:
                x.close()
        stop_server(master)
        gc.collect()
        torch.cuda.empty_cache()


def serve_store_check(info: dict, url: str, prompt: list[int], engine_tokens: list[int]) -> None:
    """The chart's decode-tier server with the store guide's flags on the
    master at ``url``: a prompt engine A published is answered from the
    store (Generate: 16 tokens), ``/metrics`` counts the pulls, hits and
    avoided tokens, and its KV events reach a reader under its advertised
    address."""
    port, events_port = free_port(), free_port()
    argv = ["--model", MODEL, f"--served-model-name={MODEL}", "--max-model-len=8192",
            f"--port={port}", "--tensor-parallel-size=1",
            f"--advertised-address=127.0.0.1:{port}",
            f"--kv-events-endpoint=tcp://0.0.0.0:{events_port}",
            '--kv-transfer-config={"kv_connector":"TPUConnector","kv_role":"kv_consumer"}',
            "--max-num-seqs=64", "--max-num-batched-tokens=8192", "--decode-window=8",
            "--moe-backend=grouped", "--kv-offload-chunks=512", f"--kv-store-master-url={url}",
            "--kv-store-segment-bytes=1073741824", f"--kv-store-data-port={free_port()}",
            "--skip-warmup"]
    server = start_server(argv, "chip_smoke_events_store_server.log", port=port)
    reader = None
    try:
        info["server_startup_s"] = wait_healthy([server])
        reader = ZmtpSubReader("127.0.0.1", events_port)
        if not reader.greeted.wait(30):
            raise TimeoutError("the server's event socket never greeted")
        time.sleep(0.2)  # the subscription reaches the server's socket
        t0 = time.perf_counter()
        status, raw = _post(server[1] + "/vllm.Generation/Generate", {
            "prompt_token_ids": prompt,
            "sampling_params": {"max_tokens": ES_TOKENS, "temperature": 0.0, "ignore_eos": True}})
        info["server_request_ms"] = (time.perf_counter() - t0) * 1e3
        tokens = json.loads(raw)["token_ids"]
        m, _ = _scrape(server[1])
        keys = ("kvstore_pulls_total", "kv_federation_hits_total", "recompute_avoided_tokens_total",
                "kv_offload_restores_total", "kvstore_misses_total")
        info["server_metrics"] = {k: m.get(f"llmd:{k}") for k in keys}
        info["server_tokens_equal_engine_a"] = tokens == engine_tokens
        full = OFFLOAD_PROMPT // 16
        if status != 200 or len(tokens) != ES_TOKENS:
            raise AssertionError(f"the server answered {status} with {len(tokens)} tokens")
        if (m["llmd:kvstore_pulls_total"] != full or m["llmd:kv_federation_hits_total"] != full
                or m["llmd:recompute_avoided_tokens_total"] != full * 16):
            raise AssertionError(f"the server's store counters: {info['server_metrics']}")
        t0 = time.perf_counter()
        while not any(e["type"] == "BlockStored" for e in reader.events()):
            if time.perf_counter() - t0 > 30:
                raise TimeoutError("no BlockStored event from the server")
            time.sleep(0.05)
        pods = {payload["pod"] for _, _, payload in reader.messages}
        info["server_events"] = len(reader.events())
        info["server_event_pods"] = sorted(pods)
        if pods != {f"127.0.0.1:{port}"}:
            raise AssertionError(f"the server's events name {pods}")
    finally:
        if reader is not None:
            reader.close()
        stop_server(server[0])


def pd_serve_phase(info: dict) -> None:
    """Two port servers on the card in llm-d's P/D roles (the chart's
    ``--kv-transfer-config`` and ``--advertised-address``, 1,024 pages
    each, the decode tier's windows of 8): this script plays the routing
    sidecar. Both bind every interface, as the chart's pods do, so the
    producer's ``remote_host`` comes from ``--advertised-address`` alone.
    Each prompt's prefill goes to the producer (``max_tokens`` 1,
    ``do_remote_decode``), its decode to the consumer with the returned
    params (streamed, token ids annotated; the group-streamed import, whose
    fetch thread scatters while the consumer steps): 16 tokens, TTFT of
    both phases; /metrics counts the exports and imports on both. Each
    stream is held to the model (``held_to_model``) against the producer's
    own aggregated answer (Generate) for its prompt. Then the producer
    exports one more prompt and is stopped: the consumer answers it alone
    with the producer's aggregated tokens, and counts the failed import."""
    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.registry import get_model_config

    ship = free_port()
    common = ["--model", MODEL, "--num-gpu-blocks-override", "1024", "--decode-window", "8",
              "--host", "0.0.0.0"]
    kv = '{"kv_connector":"TPUConnector","kv_role":"%s"%s}'
    servers = []
    try:
        ports = free_port(), free_port()
        prod = start_server([*common, "--skip-warmup", "--advertised-address",
                             f"127.0.0.1:{ports[0]}", "--kv-transfer-config",
                             kv % ("kv_producer", f',"transfer_port":{ship}')],
                            "chip_smoke_pd_producer.log", port=ports[0])
        servers.append(prod)
        cons = start_server([*common, "--advertised-address", f"127.0.0.1:{ports[1]}",
                             "--kv-transfer-config", kv % ("kv_consumer", "")],
                            "chip_smoke_pd_consumer.log", port=ports[1])
        servers.append(cons)
        info["startup_s"] = wait_healthy(servers)
        cfg = get_model_config(MODEL)
        prompts = fixed_prompts(cfg, 5, PD_PROMPT, 91)
        decode = {"max_tokens": 16, "temperature": 0.0, "ignore_eos": True}
        phase1_ms, ttft_ms, streams, refs = [], [], [], []
        for p in prompts[:4]:
            t0 = time.perf_counter()
            status, raw = _post(prod[1] + "/v1/completions", {
                "prompt": p, "max_tokens": 1, "temperature": 0.0,
                "kv_transfer_params": {"do_remote_decode": True}})
            phase1_ms.append((time.perf_counter() - t0) * 1e3)
            params = json.loads(raw)["kv_transfer_params"]
            if status != 200 or params["remote_port"] != ship or params["remote_host"] != "127.0.0.1":
                raise AssertionError(f"the prefill answered {status}, {params}")
            got = _stream(cons[1], "/v1/completions",
                          {"prompt": p, **decode, "stream": True, "kv_transfer_params": params},
                          {"x-llmd-stream-tokens": "1"})
            ttft_ms.append(phase1_ms[-1] + got["first_ms"])
            streams.append([t for f in got["frames"] for t in f.get("token_ids") or []])
            status, raw = _post(prod[1] + "/vllm.Generation/Generate",
                                {"prompt_token_ids": p, "sampling_params": decode})
            if status != 200:
                raise AssertionError(f"the producer's Generate answered {status}")
            refs.append(json.loads(raw)["token_ids"])
        info.update(phase1_ms=phase1_ms, two_phase_ttft_ms=ttft_ms,
                    tokens=[len(s) for s in streams])
        if any(len(s) != 16 for s in streams + refs):
            raise AssertionError(f"decode streams of {info['tokens']} tokens, references of "
                                 f"{[len(r) for r in refs]}")
        pm, _ = _scrape(prod[1])
        cm, _ = _scrape(cons[1])
        keys = ("kv_transfer_exported_requests_total", "kv_transfer_exported_bytes_total",
                "kv_transfer_imported_requests_total", "kv_transfer_imported_bytes_total",
                "kv_transfer_import_failures_total", "kv_stream_groups_total")
        info["producer_metrics"] = {k: pm.get(f"llmd:{k}") for k in keys}
        info["consumer_metrics"] = {k: cm.get(f"llmd:{k}") for k in keys}
        if (pm["llmd:kv_transfer_exported_requests_total"] < 4
                or cm["llmd:kv_transfer_imported_requests_total"] != 4
                or cm["llmd:kv_transfer_import_failures_total"] != 0
                or cm["llmd:kv_transfer_imported_bytes_total"] <= 0
                or cm["llmd:kv_stream_groups_total"] <= 0):
            raise AssertionError(f"transfer counters: {info}")
        # The decoder-only fallback: the producer's own aggregated answer
        # (a full prefill, the consumer's layout) is the reference.
        p = prompts[4]
        gen = {"prompt_token_ids": p, "sampling_params": decode}
        status, raw = _post(prod[1] + "/vllm.Generation/Generate", gen)
        reference = json.loads(raw)["token_ids"]
        status, raw = _post(prod[1] + "/v1/completions", {
            "prompt": p, "max_tokens": 1, "temperature": 0.0,
            "kv_transfer_params": {"do_remote_decode": True}})
        params = json.loads(raw)["kv_transfer_params"]
        stop_server(prod[0])
        servers.remove(prod)
        status, raw = _post(cons[1] + "/vllm.Generation/Generate",
                            {**gen, "kv_transfer_params": params})
        fallback = json.loads(raw)["token_ids"]
        cm2, _ = _scrape(cons[1])
        info["fallback_equals_reference"] = fallback == reference
        info["fallback_import_failures"] = cm2["llmd:kv_transfer_import_failures_total"]
        if status != 200 or fallback != reference:
            raise AssertionError(f"the decoder alone answered {fallback} ({status}), the "
                                 f"producer {reference}")
        if cm2["llmd:kv_transfer_import_failures_total"] != 1:
            raise AssertionError("the failed import is not counted")
    finally:
        for s in servers:
            stop_server(s[0])
    for _, _, _, log_path in (prod, cons):
        with open(log_path) as f:
            if "binds all interfaces" in f.read():
                raise AssertionError(f"{log_path}: the advertised address was not taken")
    # The servers draw their weights as this script does (seed 0).
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
                               fused=True)
    held_to_model(info, params, cfg, prompts[:4], streams, refs, "pd_serve")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# the decode pager on a Mistral-7B-v0.1-shaped model

PAGER_DIR = os.path.join(REPO, "build", "mistral-7b-v0.1")
# Mistral-7B-v0.1's published geometry (HF mistralai/Mistral-7B-v0.1,
# config.json): every layer slides (a uniform window, no layer_types).
MISTRAL_HF = {
    "architectures": ["MistralForCausalLM"], "vocab_size": 32000, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "rope_theta": 10000.0, "sliding_window": 4096,
    "rms_norm_eps": 1e-5, "max_position_embeddings": 32768, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
PAGER_SEQS, PAGER_PROMPT, PAGER_TOKENS = 4, 12_288, 128
PAGER_BLOCKS, PAGER_REF_BLOCKS, PAGER_HOST_PAGES = 1024, 4096, 4096
PAGER_HORIZON, PAGER_BUDGET, PAGER_WINDOW_K = 256, 1024, 8
# The park run: sequences inside their window while they decode, whose
# pages grow past the pool (a sequence past its window frees a page at the
# step before it claims one, and a stalled prefill chunk preempts nobody,
# so the long requests never park).
PARK_SEQS, PARK_PROMPT, PARK_TOKENS = 8, 2560, 256


def mistral_config(out_dir: str = PAGER_DIR, layers: int | None = None):
    """Mistral-7B-v0.1's ``config.json`` (``layers`` cuts the depth),
    written to ``out_dir`` and read by the port's loader."""
    from llmd_tpu_torch.models.loader import config_from_hf

    os.makedirs(out_dir, exist_ok=True)
    hf = dict(MISTRAL_HF, **({"num_hidden_layers": layers} if layers else {}))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf, f, indent=1)
    return config_from_hf(out_dir)


def pager_resident_bound(cfg) -> int:
    """A sequence's resident pages with the pager on: the window and the
    horizon, one step's budget of new pages, the partial frontier and a
    decode window's page."""
    return -(-(cfg.sliding_window + PAGER_HORIZON) // 16) + PAGER_BUDGET // 16 + 2


def pager_run(params: dict, cfg, prompts: list, blocks: int, paging: bool,
              max_tokens: int = PAGER_TOKENS) -> dict:
    """``prompts`` (greedy, ``max_tokens`` each) on one engine of as many
    slots (flat step, decode windows of ``PAGER_WINDOW_K``, budget
    ``PAGER_BUDGET``; warmed up, so decode windows are graph replays), with
    the pager on (a host tier of ``PAGER_HOST_PAGES``) or off. Returns the
    streams, each request's TTFT,
    the decode rate, each sequence's peak resident pages after a step, the
    pager's counters and host ms, and the kernels' launches."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.config import CacheConfig, EngineConfig, OffloadConfig, SchedulerConfig
    from llmd_tpu_torch.engine import LLMEngine, SamplingParams

    eng = LLMEngine(EngineConfig(
        model=cfg, cache=CacheConfig(page_size=16, num_blocks=blocks),
        scheduler=SchedulerConfig(max_num_seqs=len(prompts), max_num_batched_tokens=PAGER_BUDGET,
                                  decode_window=PAGER_WINDOW_K),
        offload=(OffloadConfig(cpu_chunks=PAGER_HOST_PAGES, decode_paging=True,
                               pager_horizon_tokens=PAGER_HORIZON) if paging else None),
        seed=0), params=params, device="cuda")
    t_warm = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    rec: dict = {"warmup_s": time.perf_counter() - t_warm}
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, sp) for p in prompts]
    out = {r: [] for r in rids}
    first: dict = {}
    peak = {r: 0 for r in rids}
    steps = 0
    emitted = []  # (time, tokens) a step
    while eng.has_work():
        n = 0
        for o in eng.step():
            out[o.request_id] += o.new_token_ids
            first.setdefault(o.request_id, time.perf_counter())
            n += len(o.new_token_ids)
        emitted.append((time.perf_counter(), n))
        steps += 1
        for req in eng.scheduler.running:
            peak[req.request_id] = max(peak[req.request_id],
                                       len(req.block_ids) - len(req.paged_out))
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    # Decode alone: the tokens after the last request's first token, over
    # the time from it to the end.
    t_all = max(first.values())
    rec.update(
        tokens=[out[r] for r in rids], steps=steps, seconds=t_end - t0,
        ttft_ms=[(first[r] - t0) * 1e3 for r in rids],
        decode_tok_s=sum(n for t, n in emitted if t > t_all) / (t_end - t_all),
        peak_resident_pages=[peak[r] for r in rids],
        launches=ops.launch_counts(), branches=ops.branch_launch_counts(),
        preemptions=eng.scheduler.num_preemptions,
    )
    if eng.pager is not None:
        pg = eng.pager
        rec["pager"] = {k: getattr(pg, k) for k in (
            "pages_spilled_total", "pages_restored_total", "parks_total", "refunds_total",
            "prefetch_late_total", "paged_out_bytes")}
        rec["tick_host_ms_per_step"] = pg.tick_host_s * 1e3 / steps
        rec["restore_host_ms"] = pg.restore_host_s * 1e3
        eng._refresh_gauges()
        rec["kv_paged_out_bytes_gauge"] = eng.stats.kv_paged_out_bytes
    if eng.has_work() or any(len(v) != max_tokens for v in out.values()):
        raise AssertionError("the pager engine left work or short streams")
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def rescore_long(params: dict, cfg, prompts: list, streams: list) -> dict:
    """``spec_rescore`` for long prompts: each sequence (prompt + stream but
    its last token) teacher-forced through the flat step in chunks of 1,024
    tokens on a pool of its own (K1' and K2', the window applied), and at
    every output position the gap of the emitted token's logprob below the
    top logprob. The bucketed plain forward of ``spec_rescore`` would hold
    a 12k x 12k score matrix a head."""
    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.common import StepInput

    dev, page, chunk = torch.device("cuda"), 16, 1024
    max_pages = -(-cfg.max_model_len // page)
    gaps = []
    for prompt, stream in zip(prompts, streams):
        seq = list(prompt) + list(stream[:-1])
        P, N = len(prompt), len(stream)
        n_pages = -(-len(seq) // page)
        pool = torch.zeros((cfg.num_layers, n_pages + 1, cfg.kv_cache_heads, page,
                            cfg.kv_cache_entry_dim), dtype=getattr(torch, cfg.dtype), device=dev)
        table = torch.zeros((1, max_pages), dtype=torch.int32, device=dev)
        table[0, :n_pages] = 1 + torch.arange(n_pages, dtype=torch.int32, device=dev)
        hs = []
        with torch.inference_mode():
            for s in range(0, len(seq), chunk):
                ids = seq[s : s + chunk]
                n = len(ids)
                T = -(-n // 16) * 16  # pads after the live tokens, as the flat step has them
                live = torch.arange(T, device=dev) < n
                pos = torch.where(live, torch.arange(s, s + T, device=dev), 0).int()
                inp = StepInput(
                    token_ids=torch.tensor(ids + [0] * (T - n), device=dev)[:, None],
                    positions=pos[:, None], kv_lens=torch.where(live, pos + 1, 0).int(),
                    page_table=table, token_rows=torch.zeros(T, dtype=torch.int32, device=dev),
                    num_live=torch.tensor([n], dtype=torch.int32, device=dev))
                h, pool = llama.forward_hidden(params, pool, inp, cfg)
                lo = max(P - 1 - s, 0)
                if lo < n:
                    hs.append(h[lo:n, 0])
            logp = torch.log_softmax(llama.compute_logits(params, torch.cat(hs), cfg).float(), -1)
            emitted = torch.tensor(stream, device=dev)[:, None]
            gaps.append(logp.max(dim=-1).values - logp.gather(1, emitted)[:, 0])
        del pool, hs, logp
    gap = torch.stack(gaps)
    return {"top_gap_max": gap.max().item(), "top_gap_per_request": gap.amax(1).tolist(),
            "positions_above_tol": int((gap > SPEC_TOP_GAP_TOL).sum()),
            "positions": gap.numel()}


def pager_kernels_phase(info: dict, cfg) -> dict:
    """K1' and K3' with the window branch at Mistral-7B-v0.1's shapes (H 32,
    K 8, D 128, window 4,096) over a 12,288-token context, the pager's
    shapes: K1' on a flat step of one 1,024-token prefill chunk ending at
    12,288 and three decode rows at 12,288-12,416, K3' on a decode step of
    the four rows (bucket 4). Each held to its plain version and timed
    beside its bound (the in-window positions), the plain version and SDPA
    (``attention_branch_case``); a 2-layer pool (one layer is read)."""
    dev, dt, page = torch.device("cuda"), torch.bfloat16, 16
    gen = torch.Generator().manual_seed(5151)
    g = torch.Generator(device=dev).manual_seed(52)
    K, H, D, window = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim, cfg.sliding_window
    max_pages = -(-cfg.max_model_len // page)
    ctx = [PAGER_PROMPT + 1, PAGER_PROMPT + 64, PAGER_PROMPT + PAGER_TOKENS]
    flat = mixed_step(cfg, page, max_pages, [(PAGER_PROMPT - PAGER_BUDGET, PAGER_BUDGET)],
                      ctx, gen, dev)
    need = [-(-c // page) for c in (*ctx, PAGER_PROMPT + 32)]
    perm = torch.randperm(sum(need) + 8, generator=gen).to(torch.int32)
    table = torch.zeros((PAGER_SEQS, max_pages), dtype=torch.int32)
    off = 0
    for r, n in enumerate(need):
        table[r, :n] = perm[off : off + n]
        off += n
    lens = torch.tensor([*ctx, PAGER_PROMPT + 32], dtype=torch.int32)
    dec = {"B": PAGER_SEQS, "n_live": PAGER_SEQS, "ctx": lens.tolist(),
           "num_pages": sum(need) + 8, "live_pages": max(need),
           "page_table": table.to(dev), "kv_lens": lens.to(dev)}
    out = {}
    for kind, step in (("flat", flat), ("decode", dec)):
        data = torch.randn((2, step["num_pages"], K, page, 2 * D), generator=g, device=dev, dtype=dt)
        rows = step["T"] if kind == "flat" else step["B"]
        q = torch.randn((rows, 1, H, D), generator=g, device=dev, dtype=dt)
        e = attention_branch_case(kind, q, data, None, 1, step, page, window, None)
        e["name"] += f"@mistral-7b-v0.1-ctx{PAGER_PROMPT}"
        e["model"] = "mistral-7b-v0.1"
        out[e["name"]] = e
        del data, q
        torch.cuda.empty_cache()
    for name, e in out.items():
        info[name] = {k: e[k] for k in ("bound_by", "items", "spans") + WRITE_KEYS if k in e}
    return out


def pager_phase() -> tuple[dict, dict]:
    """The decode pager on Mistral-7B-v0.1's shape (32 layers, bf16, page
    16, random weights from seed 0; ``pager_run`` for each run).

    ``pager`` four requests of 12,288 prompt + 128 greedy tokens, about 3x
    what a 1,024-page pool holds: the pager off on 4,096 pages (the
    reference), the pager on 4,096 pages (it spills and parks nothing: its
    streams must be the reference's bit for bit) and the pager on 1,024
    pages (it spills; every token is held to the model within the
    reference's gaps, ``held_to_model`` with ``rescore_long``). Every
    sequence's peak resident pages stay within ``pager_resident_bound``.
    ``pager_park`` eight requests of 2,560 + 256 tokens, inside the window
    while they decode, whose pages outgrow the 1,024-page pool: victims
    park and are restored, and every token is held to the model within
    the gaps of the pager-off run on 4,096 pages. Then the kernel rows at
    these shapes and a server with ``--kv-decode-paging`` on a 2-layer cut
    of the model (its HF directory written here) answering a 6,000-token
    request that spills. Returns the kernel rows and the branch launches of
    the runs that are their main path: the 1,024-page run's for K1' and
    K2', the spill-only run's for K3' and K4' (it decodes in windows; a run
    with a request waiting decodes on the flat step)."""
    from llmd_tpu_torch.models import llama

    with phase("pager_kernels", {"model": "mistral-7b-v0.1"}) as info:
        cfg = mistral_config()
        rows = pager_kernels_phase(info, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    bound_pages = pager_resident_bound(cfg)

    def report(info: dict, runs: dict) -> None:
        for name, rec in runs.items():
            info[name] = {k: v for k, v in rec.items() if k not in ("tokens", "branches")}
            if rec.get("pager") and max(rec["peak_resident_pages"]) > bound_pages:
                raise AssertionError(f"{name}: resident pages {rec['peak_resident_pages']} "
                                     f"over {bound_pages}")

    with phase("pager", {"model": "mistral-7b-v0.1", "prompt": PAGER_PROMPT,
                         "tokens": PAGER_TOKENS, "requests": PAGER_SEQS,
                         "device_pages": PAGER_BLOCKS, "host_pages": PAGER_HOST_PAGES,
                         "horizon": PAGER_HORIZON, "budget": PAGER_BUDGET,
                         "resident_bound_pages": bound_pages}) as info:
        info["layer_windows"] = sorted(set(cfg.layer_windows))
        info["context_pages"] = -(-(PAGER_PROMPT + PAGER_TOKENS) // 16)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = llama.init_params(cfg, gen, "cuda", fused=True)
        prompts = fixed_prompts(cfg, PAGER_SEQS, PAGER_PROMPT, 61)
        ref = pager_run(params, cfg, prompts, PAGER_REF_BLOCKS, paging=False)
        spill = pager_run(params, cfg, prompts, PAGER_REF_BLOCKS, paging=True)
        small = pager_run(params, cfg, prompts, PAGER_BLOCKS, paging=True)
        report(info, {"off": ref, "on_4096_pages": spill, "on_1024_pages": small})
        info["spill_only_streams_equal_off"] = spill["tokens"] == ref["tokens"]
        if not info["spill_only_streams_equal_off"]:
            raise AssertionError("the spill-only run's streams are not the pager-off run's")
        for name, rec in (("4,096", spill), ("1,024", small)):
            if rec["pager"]["parks_total"] or not rec["pager"]["pages_spilled_total"]:
                raise AssertionError(f"the {name}-page run: {rec['pager']}")
        info["streams_equal_off_1024_pages"] = sum(a == b for a, b in zip(small["tokens"], ref["tokens"]))
        held_to_model(info, params, cfg, prompts, small["tokens"], ref["tokens"], "1024_pages",
                      rescore=rescore_long)
        path_launches(info, small["launches"], FLAT_WRAPPERS)
        path_launches(info, spill["launches"], (*FLAT_WRAPPERS, "decode_paged_attention_full",
                                                "write_kv_pages_decode_full"))
        info["launches"] = {"on_1024_pages": small["launches"], "on_4096_pages": spill["launches"]}
        info["ttft_ms_median_on_1024_vs_off"] = [statistics.median(small["ttft_ms"]),
                                                 statistics.median(ref["ttft_ms"])]
        info["decode_tok_s_on_1024_vs_off"] = [small["decode_tok_s"], ref["decode_tok_s"]]
        branches = {"flat": small["branches"], "decode": spill["branches"]}
    with phase("pager_park", {"model": "mistral-7b-v0.1", "prompt": PARK_PROMPT,
                              "tokens": PARK_TOKENS, "requests": PARK_SEQS,
                              "device_pages": PAGER_BLOCKS, "host_pages": PAGER_HOST_PAGES}) as info:
        prompts = fixed_prompts(cfg, PARK_SEQS, PARK_PROMPT, 62)
        ref = pager_run(params, cfg, prompts, PAGER_REF_BLOCKS, paging=False, max_tokens=PARK_TOKENS)
        park = pager_run(params, cfg, prompts, PAGER_BLOCKS, paging=True, max_tokens=PARK_TOKENS)
        report(info, {"off": ref, "on_1024_pages": park})
        pg = park["pager"]
        if not (pg["parks_total"] and pg["pages_restored_total"]) or pg["refunds_total"]:
            raise AssertionError(f"the park run did not park and restore: {pg}")
        info["streams_equal_off"] = sum(a == b for a, b in zip(park["tokens"], ref["tokens"]))
        held_to_model(info, params, cfg, prompts, park["tokens"], ref["tokens"], "park",
                      rescore=rescore_long)
        path_launches(info, park["launches"], FLAT_WRAPPERS)
        info["ttft_ms_median_on_vs_off"] = [statistics.median(park["ttft_ms"]),
                                            statistics.median(ref["ttft_ms"])]
        info["decode_tok_s_on_vs_off"] = [park["decode_tok_s"], ref["decode_tok_s"]]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with phase("pager_serve", {"model": "mistral-7b-v0.1", "layers": 2}) as info:
        pager_serve_check(info)
    return rows, branches


def pager_serve_check(info: dict) -> None:
    """``python -m llmd_tpu_torch.serve`` on Mistral-7B-v0.1's shape cut to
    2 layers (an HF directory of random weights written here) with
    ``--kv-decode-paging``: a 6,000-token Generate request is answered,
    and ``/metrics`` shows the pages it spilled."""
    from llmd_tpu_torch.models import llama

    out_dir = PAGER_DIR + "-2l"
    cfg = mistral_config(out_dir, layers=2)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
                               fused=True)
    write_hf_checkpoint(cfg, params, out_dir)
    mistral_config(out_dir, layers=2)  # the Mistral config over the writer's Llama one
    del params
    torch.cuda.empty_cache()
    argv = ["--model", out_dir, "--tokenizer", "byte", "--max-model-len", "8192",
            "--num-gpu-blocks-override", "512", "--max-num-seqs", "4",
            "--max-num-batched-tokens", "1024", "--kv-offload-chunks", "1024",
            "--kv-decode-paging", "--kv-pager-horizon-tokens", str(PAGER_HORIZON),
            "--skip-warmup"]
    server = start_server(argv, "chip_smoke_pager_server.log")
    try:
        info["startup_s"] = wait_healthy([server])
        prompt = fixed_prompts(cfg, 1, 6000, 71)[0]
        t0 = time.perf_counter()
        status, raw = _post(server[1] + "/vllm.Generation/Generate", {
            "prompt_token_ids": prompt,
            "sampling_params": {"max_tokens": 16, "temperature": 0.0, "ignore_eos": True}})
        info["request_ms"] = (time.perf_counter() - t0) * 1e3
        tokens = json.loads(raw)["token_ids"]
        m, _ = _scrape(server[1])
        info["kv_paged_out_bytes"] = m.get("llmd:kv_paged_out_bytes")
        if status != 200 or len(tokens) != 16 or not info["kv_paged_out_bytes"]:
            raise AssertionError(f"the pager server answered {status} with {len(tokens)} "
                                 f"tokens, {info['kv_paged_out_bytes']} bytes paged out")
    finally:
        stop_server(server[0])
        shutil.rmtree(out_dir, ignore_errors=True)


# --------------------------------------------------------------------- #
# LoRA adapters and the paged adapter pool on llama-3-8b

LORA_RANK, LORA_ALPHA = 16, 32.0
LORA_PROMPT, LORA_TOKENS, LORA_WINDOW_K = 192, 32, 8
LORA_DIR = os.path.join(REPO, "build", "lora-adapters")


def write_peft_adapter(cfg, out_dir: str, seed: int, zero_b: bool = False) -> str:
    """An HF PEFT adapter directory for ``cfg`` (rank ``LORA_RANK`` on
    q_proj and v_proj, alpha ``LORA_ALPHA``): seeded random A and B (B all
    zero with ``zero_b``), bf16, in PEFT's tensor names."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "adapter_config.json"), "w") as f:
        json.dump({"r": LORA_RANK, "lora_alpha": LORA_ALPHA, "target_modules": ["q_proj", "v_proj"],
                   "bias": "none", "peft_type": "LORA"}, f)
    g = torch.Generator().manual_seed(seed)
    H, D = cfg.hidden_size, cfg.head_dim
    tensors = {}
    for i in range(cfg.num_layers):
        for proj, width in (("q_proj", cfg.num_heads * D), ("v_proj", cfg.num_kv_heads * D)):
            pre = f"base_model.model.model.layers.{i}.self_attn.{proj}"
            tensors[f"{pre}.lora_A.weight"] = (
                torch.randn((LORA_RANK, H), generator=g) * H**-0.5).bfloat16()
            b = torch.randn((width, LORA_RANK), generator=g) * 0.05
            tensors[f"{pre}.lora_B.weight"] = (b * 0 if zero_b else b).bfloat16()
    write_safetensors(os.path.join(out_dir, "adapter_model.safetensors"), tensors)
    return out_dir


def with_lora_slots(params: dict, cfg) -> dict:
    """``params`` (shared, not copied) with ``cfg``'s adapter slots added
    (zeros: every slot the base model until an install)."""
    from llmd_tpu_torch.models import llama

    slots = llama.lora_slots(cfg, cfg.num_layers, "cuda", getattr(torch, cfg.dtype))
    return {**params, "layers": {**params["layers"], **slots}}


def merged_params(params: dict, cfg, w: dict) -> dict:
    """``params`` with adapter ``w`` merged into q|k|v in f32 (``W + A B``
    on the q and v columns; an int8 tree's q|k|v dequantized first), then
    rounded to the model's dtype: the adapter's model, for the rescore."""
    layers = params["layers"]
    Nq, K, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "wqkv_scale" in layers:  # int8, K-major [L, out, in]
        wf = (layers["wqkv"].float() * layers["wqkv_scale"][:, :, None]).transpose(1, 2)
    else:
        wf = layers["wqkv"].to(torch.float32, copy=True)  # the tree is not written
    dev = wf.device
    wf[..., : Nq * D] += torch.bmm(w["la_q"].to(dev).float(), w["lb_q"].to(dev).float())
    wf[..., (Nq + K) * D :] += torch.bmm(w["la_v"].to(dev).float(), w["lb_v"].to(dev).float())
    out = {k: v for k, v in layers.items() if k not in ("wqkv_scale", "la_q", "la_v", "lb_q", "lb_v")}
    out["wqkv"] = wf.to(getattr(torch, cfg.dtype))
    del wf
    return {**params, "layers": out}


def decode_step_ms(eng, prompts: list, sp, slots: list) -> float:
    """``prompts`` on adapter ``slots``, to the end: the median CUDA-event
    time of the decode-only steps (a window's graph replay and its
    readback) over the window's tokens."""
    for p, slot in zip(prompts, slots):
        eng.add_request(p, sp, lora_id=slot)
    times = []
    while eng.has_work():
        decoding = all(r.in_decode for r in eng.scheduler.running) and not eng.scheduler.waiting
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        eng.step()
        end.record()
        end.synchronize()
        if decoding:
            times.append(start.elapsed_time(end) / LORA_WINDOW_K)
    return statistics.median(times)


def lora_engine(params: dict, cfg):
    """The LoRA phase's engine (flat step, decode windows, warmed up)."""
    from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from llmd_tpu_torch.engine import LLMEngine

    eng = LLMEngine(EngineConfig(
        model=cfg, cache=CacheConfig(page_size=16, num_blocks=1024),
        scheduler=SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=2048,
                                  decode_window=LORA_WINDOW_K),
        seed=0), params=params, device="cuda")
    eng.warmup()
    return eng


def lora_engine_run(params: dict, cfg, adapters: list, quantization: str | None) -> dict:
    """llama-3-8b with 4 adapter slots of rank 16 (flat step, decode windows
    of 8, warmed up): the PEFT directories ``adapters`` loaded into slots 1-4
    (slot 4's B is zero), then one mixed batch: prompt 0 on the base model
    and on slot 4, prompts 1-3 on slots 1-3. Then slot 1 is written again,
    after the graphs were captured, with slot 2's adapter, and prompt 2
    runs on slots 1 and 2 together. Returns the streams, the graphs
    captured, the launches and the decode steps' ms with and without
    adapters in the batch (every row of an engine with slots computes its
    slot's terms, slot 0's zeros included) and on an engine without
    slots."""
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.engine import SamplingParams
    from llmd_tpu_torch.models.loader import load_lora_adapter
    from llmd_tpu_torch.models.registry import get_model_config

    eng = lora_engine(with_lora_slots(params, cfg), cfg)
    captured = set(eng.runner.programs.programs)
    weights = [load_lora_adapter(cfg, d) for d in adapters]
    for slot, w in enumerate(weights, start=1):
        eng.set_lora_weights(slot, w)
    prompts = fixed_prompts(cfg, 4, LORA_PROMPT, 81)
    sp = SamplingParams(temperature=0.0, max_tokens=LORA_TOKENS, ignore_eos=True)

    def drive(rows) -> list:
        rids = [eng.add_request(prompts[p], sp, lora_id=slot) for p, slot in rows]
        out = {r: [] for r in rids}
        while eng.has_work():
            for o in eng.step():
                out[o.request_id] += o.new_token_ids
        return [out[r] for r in rids]

    ops.reset_launch_counts()
    replays0 = sum(eng.runner.programs.runs.values())
    mixed = drive([(0, 0), (0, 4), (1, 1), (2, 2), (3, 3)])
    rec = {"streams": mixed, "launches": ops.launch_counts(),
           "replays": sum(eng.runner.programs.runs.values()) - replays0}
    eng.set_lora_weights(1, weights[1])  # after capture: the next replays read it
    rec["reinstalled"] = drive([(2, 1), (2, 2)])
    rec["graphs_captured_after_warmup"] = sorted(map(str, set(eng.runner.programs.programs) - captured))

    rec["decode_ms_per_token_base"] = decode_step_ms(eng, prompts, sp, [0] * 4)
    rec["decode_ms_per_token_adapters"] = decode_step_ms(eng, prompts, sp, [1, 2, 3, 1])
    rec["prompts"] = prompts
    rec["weights"] = weights
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    plain = lora_engine(params, get_model_config(MODEL, quantization=quantization))
    rec["decode_ms_per_token_no_slots"] = decode_step_ms(plain, prompts, sp, [0] * 4)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    return rec



def lora_phase(params: dict, params8: dict) -> None:
    """LoRA on llama-3-8b, bf16 and int8 weights (``lora_engine_run``): the
    zero-B adapter's stream is the base stream bit for bit, each adapter's
    stream is held to that adapter's model (``merged_params``, teacher-
    forced by ``spec_rescore``) within the base stream's gaps under the
    base model, the reinstalled slot gives slot 2's stream in the same
    batch, and no graph is captured after warmup. The yardstick of the
    rescore is the base stream under the base model with q|k|v merged the
    same way (the zero-B adapter: for int8 weights, q|k|v dequantized, so
    that the gate counts what the adapters add, not what the
    dequantization does). Then a server with
    ``--lora-pool-slots 2`` over the four adapters: requests for each, the
    load and unload routes, and the cold loads, evictions and
    ``vllm:lora_requests_info`` on ``/metrics``."""
    from llmd_tpu_torch.models.registry import get_model_config

    shutil.rmtree(LORA_DIR, ignore_errors=True)
    for quantization, tree in ((None, params), ("int8", params8)):
        with phase("lora", {"model": MODEL, "quantization": quantization, "slots": 4,
                            "rank": LORA_RANK}) as info:
            cfg = get_model_config(MODEL, num_lora_adapters=4, lora_rank=LORA_RANK,
                                   quantization=quantization)
            base_cfg = get_model_config(MODEL, quantization=quantization)
            adapters = [write_peft_adapter(cfg, os.path.join(LORA_DIR, f"a{i}"), 90 + i,
                                           zero_b=i == 3) for i in range(4)]
            rec = lora_engine_run(tree, cfg, adapters, quantization)
            s = rec["streams"]
            info["zero_b_equals_base"] = s[1] == s[0]
            info["reinstalled_slot_equals_slot2"] = rec["reinstalled"][0] == rec["reinstalled"][1]
            info["adapter_streams_differ_from_base_prompt"] = [s[i + 2] != s[0] for i in range(3)]
            info["graphs_captured_after_warmup"] = rec["graphs_captured_after_warmup"]
            info["replays"] = rec["replays"]
            info["launches"] = rec["launches"]
            info["decode_ms_per_token"] = {"base": rec["decode_ms_per_token_base"],
                                           "adapters": rec["decode_ms_per_token_adapters"],
                                           "engine_without_slots": rec["decode_ms_per_token_no_slots"]}
            if not info["zero_b_equals_base"]:
                raise AssertionError("the zero-B adapter's stream is not the base stream")
            if not info["reinstalled_slot_equals_slot2"]:
                raise AssertionError("slot 1 reinstalled with slot 2's adapter streams otherwise")
            if rec["graphs_captured_after_warmup"] or not rec["replays"]:
                raise AssertionError(f"graphs after warmup {rec['graphs_captured_after_warmup']}, "
                                     f"replays {rec['replays']}")
            # The yardstick: the base stream under the base model with q|k|v
            # as the merge leaves it (the zero-B adapter merged: exact for
            # bf16, dequantized for int8).
            same = merged_params(tree, cfg, rec["weights"][3])
            base = spec_rescore(same, base_cfg, rec["prompts"][:1], s[:1])
            del same
            info["rescore_base"] = base
            for i in range(3):
                merged = merged_params(tree, cfg, rec["weights"][i])
                have = spec_rescore(merged, base_cfg, rec["prompts"][i + 1 : i + 2], s[i + 2 : i + 3])
                off = spec_rescore(tree, base_cfg, rec["prompts"][i + 1 : i + 2], s[i + 2 : i + 3])
                del merged
                torch.cuda.empty_cache()
                info[f"rescore_adapter{i + 1}"] = have
                info[f"rescore_adapter{i + 1}_under_base_model"] = off
                if have["top_gap_max"] > SPEC_TOP_GAP_TOL and have["positions_above_tol"] > max(
                        1, SPEC_ABOVE_TOL_FACTOR * base["positions_above_tol"]):
                    raise AssertionError(f"adapter {i + 1}'s stream is not its model's: {have}")
            path_launches(info, rec["launches"], (*FLAT_WRAPPERS, "decode_paged_attention_full",
                                                  "write_kv_pages_decode_full"))
        gc.collect()
        torch.cuda.empty_cache()
    with phase("lora_serve", {"model": MODEL, "pool_slots": 2, "adapters": 4}) as info:
        lora_serve_check(info, adapters)
    shutil.rmtree(LORA_DIR, ignore_errors=True)


def lora_serve_check(info: dict, adapters: list) -> None:
    """A llama-3-8b server with ``--lora-pool-slots 2`` over four adapters
    (``--lora-adapters`` name=PEFT dir): a completion for each adapter in
    turn (two cold loads and two evictions at least), then the load route
    with a ``LORA1`` file and the unload route, and ``/metrics``."""
    from llmd_tpu_torch.lora import encode_adapter
    from llmd_tpu_torch.models.loader import load_lora_adapter
    from llmd_tpu_torch.models.registry import get_model_config

    spec = ",".join(f"ad{i}={d}" for i, d in enumerate(adapters))
    server = start_server(["--model", MODEL, "--max-model-len", "8192", "--tokenizer", "byte",
                           "--lora-adapters", spec, "--lora-pool-slots", "2",
                           "--lora-rank", str(LORA_RANK), "--skip-warmup"],
                          "chip_smoke_lora_server.log")
    blob = os.path.join(LORA_DIR, "extra.lora")
    cfg = get_model_config(MODEL, num_lora_adapters=2, lora_rank=LORA_RANK)
    with open(blob, "wb") as f:
        f.write(encode_adapter(load_lora_adapter(cfg, adapters[0])))
    try:
        info["startup_s"] = wait_healthy([server])
        base = server[1]
        statuses = []
        for name in ("ad0", "ad1", "ad2", "ad3", "ad0", "ad2", MODEL, "ad-typo"):
            status, _ = _call(base + "/v1/completions", {"model": name, "prompt": "hello there",
                                                         "max_tokens": 8, "temperature": 0.0})
            statuses.append(status)
        for path, body in (("/v1/load_lora_adapter", {"lora_name": "extra", "lora_path": blob}),
                           ("/v1/completions", {"model": "extra", "prompt": "hi", "max_tokens": 4}),
                           ("/v1/unload_lora_adapter", {"lora_name": "extra"}),
                           ("/v1/unload_lora_adapter", {"lora_name": "extra"})):
            statuses.append(_call(base + path, body)[0])
        info["statuses"] = statuses
        _, raw = _call(base + "/v1/models")
        info["model_ids"] = [m["id"] for m in json.loads(raw)["data"]]
        _, raw = _call(base + "/metrics")
        text = raw.decode()
        m, _ = _scrape(base)
        keys = ("lora_cold_loads_total", "lora_pool_evictions_total", "lora_pool_resident_adapters",
                "lora_load_failures_total")
        info["metrics"] = {k: m.get(f"llmd:{k}") for k in keys}
        info["lora_requests_info"] = [ln for ln in text.splitlines()
                                      if ln.startswith("vllm:lora_requests_info")]
        if statuses != [200] * 7 + [404, 200, 200, 200, 404]:
            raise AssertionError(f"the LoRA server answered {statuses}")
        if (info["metrics"]["lora_cold_loads_total"] or 0) < 2 or (
                info["metrics"]["lora_pool_evictions_total"] or 0) < 2 or not info["lora_requests_info"]:
            raise AssertionError(f"the LoRA server's metrics: {info['metrics']}, "
                                 f"{info['lora_requests_info']}")
    finally:
        stop_server(server[0])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from llmd_tpu_torch.config import CacheConfig, EngineConfig
    from llmd_tpu_torch.ops import _build
    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.registry import get_model_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    with phase("device", {"kind": kind, "count": torch.cuda.device_count()}) as info:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
        info["nvidia_smi"] = smi
        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
    print(smi, flush=True)
    with phase("build", {}) as info:
        info["built"] = _build.build_all()
    with phase("kernels", {}) as info:
        table = kernels_phase(info)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("decode_kernels", {}) as info:
        table.update(decode_kernels_phase(info))
    gc.collect()
    torch.cuda.empty_cache()
    with phase("oss_kernels", {}) as info:
        table.update(oss_kernels_phase(info))
    gc.collect()
    torch.cuda.empty_cache()
    with phase("qwen_kernels", {"model": QWEN_MODEL}) as info:
        table.update(qwen_kernels_phase(info))
    gc.collect()
    torch.cuda.empty_cache()
    with phase("quant_kernels", {}) as info:
        table.update(quant_kernels_phase(info))
    gc.collect()
    torch.cuda.empty_cache()
    q8_counts: dict[str, dict] = {}  # the int8 engine run each int8 row's launches come from

    def q8_runner(model: str) -> dict:
        """The int8 tree a runner draws from seed 0 (the bf16 tree's draws,
        quantized), its init's peak device memory held to the int8 tree and
        the pool plus 2 GB (``runner_init_memory``)."""
        with phase("runner_init", {"model": model, "quantization": "int8"}) as info:
            params8 = runner_init_memory(info, EngineConfig(
                model=get_model_config(model, quantization="int8"),
                cache=CacheConfig(page_size=16, num_blocks=2048)))
        gc.collect()
        torch.cuda.empty_cache()
        return params8
    with phase("forward", {}) as info:
        cfg = get_model_config(MODEL)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = llama.init_params(cfg, gen, "cuda", fused=True)
        forward_phase(info, params)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("engine", {"layout": "flat step"}) as info:
        flat_counts, flat_branches, flat_tokens, _ = engine_phase(info, params)
    with phase("engine", {"layout": "flat step", "async_scheduling": True}) as info:
        _, _, tokens, _ = engine_phase(info, params, async_scheduling=True)
        compare_sync_async(info, tokens, flat_tokens)
    with phase("engine", {"layout": "split engine, decode_window 8"}) as info:
        window_counts, window_branches, _, _ = engine_phase(info, params)
    with phase("engine", {"layout": "flat step, decode_window 8"}) as info:
        _, _, bf16_tokens, _ = engine_phase(info, params)
    with phase("engine", {"layout": "flat step, decode_window 8", "async_scheduling": True}) as info:
        _, _, tokens, _ = engine_phase(info, params, async_scheduling=True)
        compare_sync_async(info, tokens, bf16_tokens)
    with phase("engine", {"layout": "flat step, decode_window 8", "kv_cache_dtype": "int8"}) as info:
        _, int8_branches, int8_tokens, _ = engine_phase(info, params, kv_dtype="int8")
        compare_greedy(info, int8_tokens, bf16_tokens, gate=True)
        first_token_witness(info, params, MODEL, int8_tokens, bf16_tokens)
    params8 = q8_runner(MODEL)
    with phase("forward", {"model": MODEL, "quantization": "int8"}) as info:
        q8_forward_phase(info, MODEL, params, params8)
    with phase("engine", {"layout": "flat step", "quantization": "int8"}) as info:
        q8_counts[MODEL], _, q8_tokens, _ = engine_phase(info, params8, quantization="int8")
        compare_greedy(info, q8_tokens, bf16_tokens, gate=False)
    with phase("engine", {"layout": "flat step", "quantization": "int8", "async_scheduling": True}) as info:
        _, _, tokens, _ = engine_phase(info, params8, quantization="int8", async_scheduling=True)
        compare_sync_async(info, tokens, q8_tokens)
    with phase("engine", {"layout": "flat step, decode_window 8", "quantization": "int8"}) as info:
        engine_phase(info, params8, quantization="int8")
    spec_exact_phase()
    spec_counts = spec_phase(params, MODEL)
    spec_phase(params8, MODEL, quantization="int8")
    lora_phase(params, params8)
    del params8
    gc.collect()
    torch.cuda.empty_cache()
    batch_exact_phase()
    batch_phase(params, get_model_config(MODEL))
    offload_phase(params, MODEL, "bfloat16", async_too=True)
    offload_phase(params, MODEL, "int8")
    pd_exact_phase()
    pd_phase(params, get_model_config(MODEL))
    events_store_phase(params, get_model_config(MODEL))
    pager_rows, pager_branches = pager_phase()
    table.update(pager_rows)
    t_stats = time.perf_counter()
    surface = stats_update_cost(params)
    surface["stats_update_s"] = time.perf_counter() - t_stats
    with phase("checkpoint", {}) as info:
        checkpoint_phase(info, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with phase("layouts", {}) as info:
        layouts_phase(info)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("moe_mla_kernels", {}) as info:
        table.update(moe_mla_kernels_phase(info))
    gc.collect()
    torch.cuda.empty_cache()
    with phase("forward", {"model": DS_MODEL}) as info:
        ds_cfg = get_model_config(DS_MODEL)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = llama.init_params(ds_cfg, gen, "cuda")
        ds_forward_phase(info, params)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("engine", {"model": DS_MODEL, "layout": "default (bucketed unified step)"}) as info:
        ds_counts, _ = ds_engine_phase(info, params)
    with phase("engine", {"model": DS_MODEL, "layout": "split engine, decode_window 8"}) as info:
        ds_engine_phase(info, params)
    offload_phase(params, DS_MODEL, "bfloat16")
    pd_cut_phase(DS_MODEL, 4)
    params8 = llama.init_params(get_model_config(DS_MODEL, quantization="int8"),
                                torch.Generator(device="cuda").manual_seed(0), "cuda")
    with phase("forward", {"model": DS_MODEL, "quantization": "int8"}) as info:
        q8_forward_phase(info, DS_MODEL, params, params8)
    with phase("engine", {"model": DS_MODEL, "layout": "default (bucketed unified step)",
                          "quantization": "int8"}) as info:
        q8_counts[DS_MODEL], ds_q8_tokens = ds_engine_phase(info, params8, quantization="int8")
    with phase("engine", {"model": DS_MODEL, "layout": "default (bucketed unified step)",
                          "quantization": "int8", "async_scheduling": True}) as info:
        _, tokens = ds_engine_phase(info, params8, quantization="int8", async_scheduling=True)
        compare_sync_async(info, tokens, ds_q8_tokens)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    spec_phase(params8, DS_MODEL, quantization="int8")
    del params8
    gc.collect()
    torch.cuda.empty_cache()
    spec_exact_phase(OSS_MODEL, layers=6, swa_ring=True, need_accepted=False)
    with phase("forward", {"model": OSS_MODEL}) as info:
        oss_cfg = get_model_config(OSS_MODEL)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = llama.init_params(oss_cfg, gen, "cuda", fused=True)
        fill_biases(params, seed=3)
        oss_forward_phase(info, params)
    gc.collect()
    torch.cuda.empty_cache()
    oss_counts, oss_runs, oss_tokens = {}, {}, {}
    for layout, kv_dtype in OSS_LAYOUTS:
        with phase("engine", {"model": OSS_MODEL, "layout": layout, "kv_cache_dtype": kv_dtype}) as info:
            oss_counts[layout], oss_runs[layout], oss_tokens[layout], _ = engine_phase(
                info, params, OSS_MODEL, kv_dtype)
            if kv_dtype == "int8":
                # Reported, not gated: the witness below is the check.
                compare_greedy(info, oss_tokens[layout], oss_tokens["flat step"], gate=False)
                first_token_witness(info, params, OSS_MODEL, oss_tokens[layout],
                                    oss_tokens["flat step"])
    gc.collect()
    torch.cuda.empty_cache()
    params8 = q8_runner(OSS_MODEL)
    fill_biases(params8, seed=3)
    with phase("forward", {"model": OSS_MODEL, "quantization": "int8"}) as info:
        q8_forward_phase(info, OSS_MODEL, params, params8)
    with phase("engine", {"model": OSS_MODEL, "layout": "flat step", "quantization": "int8"}) as info:
        q8_counts[OSS_MODEL], _, _, _ = engine_phase(info, params8, OSS_MODEL, quantization="int8")
    del params8
    gc.collect()
    torch.cuda.empty_cache()
    with phase("ring_kernels", {"model": OSS_MODEL}) as info:
        ring_kernels_phase(info)
    ring_tokens = {}
    for layout, kv_dtype in OSS_LAYOUTS:
        ring_tokens[layout] = ring_engine_phases(params, layout, kv_dtype)
    with phase("engine", {"model": OSS_MODEL, "layout": "flat step", "kv_cache_dtype": "bfloat16",
                          "kv_swa_ring": True, "async_scheduling": True}) as info:
        prompts = ring_prompts(get_model_config(OSS_MODEL))
        _, _, tokens, _ = engine_phase(info, params, OSS_MODEL, prompts=prompts, swa_ring=True,
                                       async_scheduling=True)
        compare_sync_async(info, tokens, ring_tokens["flat step"])
    gc.collect()
    torch.cuda.empty_cache()
    spec_phase(params, OSS_MODEL, swa_ring=True)
    with phase("hybrid_prefix", {"model": OSS_MODEL, "layout": "flat step"}) as info:
        hybrid_prefix_phase(info, params)
    with phase("capacity", {"model": OSS_MODEL, "layout": "flat step"}) as info:
        capacity_phase(info, params)
    pd_cut_phase(OSS_MODEL, 4, swa_ring=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    qwen_runs, q8_counts[QWEN_MODEL] = qwen_phases()
    gc.collect()
    torch.cuda.empty_cache()
    sink = OtlpSink()
    try:
        with phase("serve", {"layout": "flat step"}) as info:
            registry_texts = serve_phase(info, [], surface=surface, sink=sink)
            plain_startup_s = info["startup_s"]
    finally:
        sink.close()
    chart = ("--served-model-name", MODEL, "--max-model-len", "8192", "--block-size", "16",
             "--tokenizer", "byte")
    try:
        with phase("serve", {"layout": "flat step", "from": "HF checkpoint"}) as info:
            # The chart's flags this port takes, on the directory the checkpoint
            # phase wrote: the same seed-0 weights, so the same completions.
            texts = serve_phase(info, [], CKPT_DIR, name=MODEL, flags=chart)
            info["texts_equal_registry_server"] = texts == registry_texts
            if texts != registry_texts:
                raise AssertionError(f"the checkpoint server answered {texts}, the registry server {registry_texts}")
        with phase("serve", {"layout": "flat step", "from": "HF checkpoint",
                             "quantization": "int8"}) as info:
            # The chart's int8 flag on the same directory: the loader
            # quantizes each leaf as it maps it.
            serve_phase(info, [], CKPT_DIR, name=MODEL, flags=(*chart, "--quantization", "int8"),
                        check=q8_serve_check)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    with phase("serve", {"model": QWEN_MODEL, "layout": "flat step"}) as info:
        serve_phase(info, [], QWEN_MODEL)
    with phase("serve", {"layout": "split engine, decode_window 4"}) as info:
        serve_phase(info, ["--no-unified-step", "--decode-window", "4"])
    with phase("serve", {"layout": "flat step", "async_scheduling": True,
                         "kv_offload_chunks": GUIDE_OFFLOAD_CHUNKS, "device_pages": OFFLOAD_BLOCKS,
                         "batch_header": True}) as info, \
            tempfile.TemporaryDirectory(prefix="kv-fs-") as fs_dir:
        # The registry server's first completion is the same request; the
        # tiered offload with the guide's flags and the batch header ride
        # along (``offload_batch_serve_check``). Its start pins the guide's
        # host budget: its seconds and resident set beside the plain
        # server's start.
        texts = serve_phase(info, ["--async-scheduling",
                                   f"--kv-offload-chunks={GUIDE_OFFLOAD_CHUNKS}",
                                   f"--kv-offload-fs-dir={fs_dir}",
                                   "--num-gpu-blocks-override", str(OFFLOAD_BLOCKS)],
                            check=offload_batch_serve_check)
        info["startup_s_plain_server"] = plain_startup_s
        info["texts_equal_sync_server"] = texts == [registry_texts[0], registry_texts[-1]]
        if not info["texts_equal_sync_server"]:
            raise AssertionError(f"the async server answered {texts}, the sync server "
                                 f"{[registry_texts[0], registry_texts[-1]]}")
    with phase("serve", {"layout": "flat step", "speculative_ngram": True}) as info:
        texts = serve_phase(info, ["--speculative-ngram"], check=spec_serve_check)
        info["texts_equal_plain_server"] = texts == [registry_texts[0], registry_texts[-1]]
        if not info["texts_equal_plain_server"]:
            raise AssertionError(f"the speculative server answered {texts}, the plain server "
                                 f"{[registry_texts[0], registry_texts[-1]]}")
    with phase("serve", {"model": DS_MODEL, "layout": "default (bucketed unified step)"}) as info:
        serve_phase(info, [], DS_MODEL)
    with phase("serve", {"model": OSS_MODEL, "layout": "flat step"}) as info:
        serve_phase(info, [], OSS_MODEL)
    with phase("serve", {"model": OSS_MODEL, "layout": "flat step", "kv_swa_ring": True}) as info:
        serve_phase(info, ["--kv-swa-ring"], OSS_MODEL)
    with phase("serve", {"layout": "flat step", "kv_cache_dtype": "int8"}) as info:
        serve_phase(info, ["--kv-cache-dtype", "int8"])
    with phase("pd_serve", {"model": MODEL, "roles": ["kv_producer", "kv_consumer"],
                            "device_pages": 1024, "decode_window": 8}) as info:
        pd_serve_phase(info)
    # Each kernel's launches come from the engine run that is its main path:
    # the unbranched K1'/K3' rows from llama-3-8b's flat and split-window
    # runs; a branched row (the fused writes, the window, sink and int8
    # branches) from its model's int8-pool run for an int8 branch, else its
    # flat step run (K1', K2') or split-window run (K3', K4'); K5', K6' and
    # K4''s latent form (their rows name a wrapper and a model) from
    # deepseek-v2-lite's default engine, where every write of the wrapper
    # is a latent one, and gpt-oss-20b's flat step engine (the 128-head row
    # of K5' is a kernel-level shape: its launches are the wrapper's on
    # deepseek-v2-lite's path); the store-only K4' is on no model's path
    # (its row says ``on_path`` false; 0 launches, held and timed all the
    # same); qwen3-32b's
    # rows from its flat step (K1', K2') or split-window (K3', K4') run.
    main_path = {
        "flat_paged_attention": ("flat_paged_attention_full", flat_counts),
        "flat_paged_attention@prefill": ("flat_paged_attention_full", flat_counts),
        "flat_paged_attention@decode64": ("flat_paged_attention_full", flat_counts),
        # The verify-shaped rows: llama-3-8b's speculative flat engine.
        "flat_paged_attention@verify64x5": ("flat_paged_attention_full", spec_counts["spec"]),
        "flat_kv_write[rope]@verify64x5": ("write_kv_pages_flat_full", spec_counts["spec"]),
        "decode_paged_attention": ("decode_paged_attention_full", window_counts),
        # The window branch at Mistral-7B-v0.1's shapes: the pager's runs.
        **{name: (f"{e['wrapper']}[{e['branch']}]",
                  pager_branches["flat" if e["wrapper"].startswith("flat") else "decode"])
           for name, e in pager_rows.items()},
    }
    model_counts = {DS_MODEL: ds_counts, OSS_MODEL: oss_counts["flat step"],
                    **{f"{m} int8": c for m, c in q8_counts.items()}}

    def branch_runs(model: str, wrapper: str, branch: str) -> dict:
        int8 = "int8" in branch.split("+")
        flat = wrapper.startswith(("flat", "write_kv_pages_flat"))
        if model == MODEL:
            return int8_branches if int8 else flat_branches if flat else window_branches
        if model == QWEN_MODEL:
            return qwen_runs["flat step" if flat else "split engine, decode_window 8"]
        return oss_runs["flat step, decode_window 8" if int8 else
                        "flat step" if flat else "split engine, decode_window 8"]

    rows = []
    for name, entry in table.items():
        if entry.get("on_path") is False:  # the store-only K4'
            launches = 0
        elif name in main_path:
            fn, counts = main_path[name]
            launches = counts[fn]
        elif "branch" not in entry:
            launches = model_counts[entry["model"]][entry["wrapper"]]
        else:
            runs = branch_runs(entry["model"], entry["wrapper"], entry["branch"])
            launches = runs.get(f"{entry['wrapper']}[{entry['branch']}]", 0)
        if launches == 0 and entry.get("on_path") is not False:
            raise AssertionError(f"{name} never launched on its main path")
        rows.append({**{k: v for k, v in entry.items()
                        if k not in ("model", "wrapper", "branch", "launches")},
                     "launches": launches})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
