"""Where a step's time goes on the GPU.

    python -m llmd_tpu_torch.profile_step [--model llama-3-8b] [--batch 32]
        [--prompt-len 1000] [--decode-steps 16] [--decode-window 8]
        [--kv-cache-dtype int8] [--kv-swa-ring]

Serves ``--batch`` greedy requests of ``--prompt-len`` random tokens
through ``LLMEngine`` (random weights from ``--seed``) and traces three
windows with ``torch.profiler``: the second step of the default engine (a
prefill-heavy step of ``max_num_batched_tokens`` live tokens; the first
allocates the working memory that warmup's captures handed back),
``--decode-steps`` steps of it once every request decodes, and, in a second
engine with ``decode_window = --decode-window``, as many fused decode
windows as cover the same number of tokens. The default engine runs the
flat step, or for an MLA model (``--model deepseek-v2-lite``) the bucketed
unified step and one-iteration decode windows; ``--model gpt-oss-20b`` runs
its sliding and full layers on the flat step, and ``--kv-cache-dtype int8``
puts any GQA model's KV in the int8 pool, and ``--kv-swa-ring`` puts a
sliding-window model's sliding layers in the ring pool (its lines carry the
pools' bytes, ``kv_bytes``, either way). Every engine runs ``warmup``
first, as the server does, so decode-only steps (the flat decode steps and
every decode window) are CUDA graph replays; each line carries the
engine's warmup seconds, the graphs it captured, the device memory it kept
and the replays by key. For each window it prints one JSON line: host
milliseconds per step (the step ends in its device->host copy), the
device's busy milliseconds per step (the sum of its CUDA kernels' times;
one stream, so kernels do not overlap), the device's idle share, kernel
launches per step, device milliseconds per step by group (the port's
kernels, GEMMs, the rest), the costliest other kernels, the same host and
device times per token of a decode row, so that the fused window stands
beside the flat decode step, the live tokens a second at the untraced
step time, and the engine's host gap a step (``EngineStats``) beside the
untraced host time; the decode line also carries the host cost of building and
staging a flat decode step's static inputs (``staging_us``). The profiler adds host time to every operator, so each
window's steps are also timed without it (``untraced_host_ms_per_step``),
before the profiler first starts. Runs on a GPU only.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.engine.scheduler import ScheduledSeq
from llmd_tpu_torch.models import llama
from llmd_tpu_torch.models.registry import get_model_config

_GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")
# Kernel names hold these (K1'/K3' bf16 kernels and their span merges carry
# their library's tag type, e.g. tile_attention_kernel<flat_paged_attention_kernel, ...>;
# the kernels of K5' and its merge are mla_decode_attention_*_kernel, those
# of K6' grouped_gemm_*_kernel).
_PORT_KERNELS = (
    "flat_paged_attention", "flat_kv_write", "decode_paged_attention",
    "decode_kv_write", "mla_decode_attention", "grouped_gemm",
)


def _group(kernel: str) -> str:
    for name in _PORT_KERNELS:
        if name in kernel:
            return name
    if any(m in kernel.lower() for m in _GEMM_MARKS):
        return "gemm"
    return "other"


def time_steps(eng: LLMEngine, n: int) -> tuple[float, float]:
    """Host milliseconds per step of ``n`` engine steps, profiler off, and
    the engine's own count of their host gap (``EngineStats.step_host_gap_ms``:
    the step's host work outside the wait for its readback), per step."""
    gap0 = eng.stats.step_host_gap_ms_total
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    return ms, (eng.stats.step_host_gap_ms_total - gap0) / n


def trace_steps(eng: LLMEngine, n: int, untraced_ms: float) -> dict:
    """Run ``n`` engine steps under the profiler; per-step averages beside
    ``untraced_ms``, the same kind of steps' host time without it."""
    live0 = eng.runner.live_tokens_total
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
    by_group: dict[str, float] = collections.defaultdict(float)
    other: dict[str, float] = collections.defaultdict(float)
    launches = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        g = _group(e.name)
        by_group[g] += ms
        if g == "other":
            other[e.name[:80]] += ms
        launches += 1
    if not launches:
        raise RuntimeError("the profiler recorded no CUDA kernel: no device time to report")
    busy = sum(by_group.values()) / n
    top = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    live = (eng.runner.live_tokens_total - live0) / n
    # Tokens one row gains in a step: 1, or K in a fused decode window.
    row_tokens = max(live / max(len(eng.scheduler.running), 1), 1.0)
    return {
        "steps": n,
        "live_tokens_per_step": live,
        "host_ms_per_step": host_ms,
        "untraced_host_ms_per_step": untraced_ms,
        # live tokens a second at the untraced step time (a decode step's:
        # decode tok/s)
        "untraced_tok_per_s": live / untraced_ms * 1e3,
        "device_busy_ms_per_step": busy,
        "idle_share": 1.0 - busy / host_ms,
        "untraced_idle_share": 1.0 - busy / untraced_ms,
        "kernels_per_step": launches / n,
        "device_ms_per_step": {g: ms / n for g, ms in sorted(by_group.items())},
        "top_other_ms_per_step": {k: ms / n for k, ms in top},
        "tokens_per_row_per_step": row_tokens,
        "untraced_host_ms_per_row_token": untraced_ms / row_tokens,
        "device_busy_ms_per_row_token": busy / row_tokens,
    }


def staging_us(eng: LLMEngine, n: int = 200) -> dict:
    """Host microseconds a flat decode step of the running requests spends
    building its arrays (``stage_unified``: page tables, and under the ring
    the ring-view table) and staging them into its program's static
    inputs (the pinned host buffer and its copy to the device), each the
    mean of ``n`` calls, profiler off."""
    runner = eng.runner
    seqs = [ScheduledSeq(req, 1) for req in eng.scheduler.running]
    t0 = time.perf_counter()
    for _ in range(n):
        staged = runner.stage_unified([], seqs)
    build = (time.perf_counter() - t0) * 1e6 / n
    key = ("flat", len(staged.arrays["stream"]), staged.all_greedy)
    inputs = runner.programs.programs[key].inputs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        inputs.stage(staged.arrays)
    torch.cuda.synchronize()
    return {"build_us": build, "stage_us": (time.perf_counter() - t0) * 1e6 / n,
            "static_input_bytes": inputs.host.numel()}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m llmd_tpu_torch.profile_step")
    p.add_argument("--model", default="llama-3-8b")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--prompt-len", type=int, default=1000)
    p.add_argument("--decode-steps", type=int, default=16)
    p.add_argument("--decode-window", type=int, default=8)
    p.add_argument("--max-num-batched-tokens", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kv-cache-dtype", default=None,
                   help="KV pool dtype: the weights' (default) or int8")
    p.add_argument("--kv-swa-ring", action="store_true",
                   help="the sliding layers' KV in the ring pool (CacheConfig.swa_ring)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_model_config(args.model)
    page = 16
    # Requests prefilled early decode while later ones prefill, so each
    # runs long enough to still be decoding in both passes over its window
    # (untraced, then traced).
    prefill_steps = -(-args.batch * args.prompt_len // args.max_num_batched_tokens) + 1
    max_tokens = prefill_steps + 2 * args.decode_steps + 2 * args.decode_window + 8
    per_seq = -(-(args.prompt_len + max_tokens) // page)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = llama.init_params(cfg, gen, "cuda", fused=True)
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True)

    warmups: dict[str, dict] = {}

    def loaded_engine(name: str, **sched) -> LLMEngine:
        """An engine on the shared weights, warmed up (its seconds, graphs
        and kept device memory recorded under ``name``), with ``--batch``
        requests queued."""
        config = EngineConfig(
            model=cfg,
            cache=CacheConfig(page_size=page, num_blocks=args.batch * per_seq + 64,
                              dtype=args.kv_cache_dtype or cfg.dtype,
                              enable_prefix_caching=False, swa_ring=args.kv_swa_ring),
            scheduler=SchedulerConfig(max_num_seqs=max(64, args.batch),
                                      max_num_batched_tokens=args.max_num_batched_tokens,
                                      **sched),
            seed=args.seed,
        )
        eng = LLMEngine(config, params=params, device="cuda")
        gc.collect()  # an engine dropped earlier holds its pool until collected
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        graphs = eng.warmup()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        torch.cuda.empty_cache()
        warmups[name] = {"warmup_s": seconds, "warmup_graphs": graphs,
                         "warmup_kept_bytes": torch.cuda.memory_reserved() - reserved,
                         "kv_bytes": eng.runner.kv_bytes()}
        warm = SamplingParams(temperature=0.0, max_tokens=2 + sched.get("decode_window", 1),
                              ignore_eos=True)
        eng.generate([[5] * 64, [7] * 16], warm)  # warm-up: cuBLAS, kernels
        rng = np.random.default_rng(args.seed)
        for _ in range(args.batch):
            eng.add_request(rng.integers(3, cfg.vocab_size, size=args.prompt_len).tolist(), sp)
        return eng

    def prefilling(eng: LLMEngine) -> LLMEngine:
        """After one untimed step: the first step after warmup allocates
        its working memory, which the captures handed back."""
        eng.step()
        return eng

    def decoding(eng: LLMEngine) -> LLMEngine:
        sched = eng.scheduler
        while sched.waiting or not all(r.in_decode for r in sched.running):
            eng.step()
        eng.step()  # first all-decode step, unmeasured
        return eng

    # Every untraced time is taken before the profiler first starts: once
    # its tracing library is loaded, launches stay slower in the process.
    window = f"decode_window_{args.decode_window}"
    steps = {
        "decode": (decoding(loaded_engine("decode")), args.decode_steps),
        window: (
            decoding(loaded_engine(window, decode_window=args.decode_window)),
            max(1, args.decode_steps // args.decode_window),
        ),
    }
    untraced = {"prefill": time_steps(prefilling(loaded_engine("prefill")), 1)}
    for name, (eng, n) in steps.items():
        untraced[name] = time_steps(eng, n)
    staging = staging_us(steps["decode"][0])
    windows = {"prefill": trace_steps(prefilling(loaded_engine("prefill")), 1, untraced["prefill"][0])}
    for name, (eng, n) in steps.items():
        windows[name] = trace_steps(eng, n, untraced[name][0])
    for name, w in windows.items():
        replays = {str(k): n for k, n in steps[name][0].runner.programs.runs.items()} if name in steps else {}
        print(json.dumps({"window": name, "model": args.model, "batch": args.batch,
                          "kv_cache_dtype": args.kv_cache_dtype or cfg.dtype,
                          "kv_swa_ring": args.kv_swa_ring,
                          "prompt_len": args.prompt_len, "card": card, **warmups[name],
                          "graph_replays": replays,
                          "untraced_host_gap_ms_per_step": untraced[name][1],
                          **({"host_staging": staging} if name == "decode" else {}), **w}),
              flush=True)


if __name__ == "__main__":
    main()
