"""Where a flat step's time goes on the GPU.

    python -m llmd_tpu_torch.profile_step [--model llama-3-8b] [--batch 32]
        [--prompt-len 1000] [--decode-steps 16]

Serves ``--batch`` greedy requests of ``--prompt-len`` random tokens
through ``LLMEngine`` (random weights from ``--seed``) and traces two
windows with ``torch.profiler``: the first step (a prefill-heavy step of
``max_num_batched_tokens`` live tokens) and ``--decode-steps`` steps once
every request decodes. For each window it prints one JSON line: host
milliseconds per step (the step ends in its device->host copy), the
device's busy milliseconds per step (the sum of its CUDA kernels' times;
one stream, so kernels do not overlap), the device's idle share, kernel
launches per step, device milliseconds per step by group (the port's two
kernels, GEMMs, the rest) and the costliest other kernels. Runs on a GPU
only.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.models.registry import get_model_config

_GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")


def _group(kernel: str) -> str:
    if "flat_paged_attention" in kernel:
        return "flat_paged_attention"
    if "flat_kv_write" in kernel:
        return "flat_kv_write"
    if any(m in kernel.lower() for m in _GEMM_MARKS):
        return "gemm"
    return "other"


def trace_steps(eng: LLMEngine, n: int) -> dict:
    """Run ``n`` engine steps under the profiler; per-step averages."""
    live0 = eng.runner.live_tokens_total
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
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
    busy = sum(by_group.values())
    top = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    return {
        "steps": n,
        "live_tokens_per_step": (eng.runner.live_tokens_total - live0) / n,
        "host_ms_per_step": host_ms / n,
        "device_busy_ms_per_step": busy / n,
        "idle_share": 1.0 - busy / host_ms,
        "kernels_per_step": launches / n,
        "device_ms_per_step": {g: ms / n for g, ms in sorted(by_group.items())},
        "top_other_ms_per_step": {k: ms / n for k, ms in top},
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m llmd_tpu_torch.profile_step")
    p.add_argument("--model", default="llama-3-8b")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--prompt-len", type=int, default=1000)
    p.add_argument("--decode-steps", type=int, default=16)
    p.add_argument("--max-num-batched-tokens", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_model_config(args.model)
    page = 16
    # Requests prefilled early decode while later ones prefill, so each
    # runs long enough to still be decoding in the traced window.
    prefill_steps = -(-args.batch * args.prompt_len // args.max_num_batched_tokens) + 1
    max_tokens = prefill_steps + args.decode_steps + 8
    per_seq = -(-(args.prompt_len + max_tokens) // page)
    config = EngineConfig(
        model=cfg,
        cache=CacheConfig(page_size=page, num_blocks=args.batch * per_seq + 64,
                          dtype=cfg.dtype, enable_prefix_caching=False),
        scheduler=SchedulerConfig(max_num_seqs=max(64, args.batch),
                                  max_num_batched_tokens=args.max_num_batched_tokens),
        seed=args.seed,
    )
    eng = LLMEngine(config, device="cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    sp = SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True)
    eng.generate([[5] * 64, [7] * 16], sp)  # warm-up: cuBLAS, kernels
    rng = np.random.default_rng(args.seed)
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True)
    for _ in range(args.batch):
        eng.add_request(rng.integers(3, cfg.vocab_size, size=args.prompt_len).tolist(), sp)
    windows = {"prefill": trace_steps(eng, 1)}
    sched = eng.scheduler
    while sched.waiting or not all(r.in_decode for r in sched.running):
        eng.step()
    eng.step()  # first all-decode step, untraced
    windows["decode"] = trace_steps(eng, args.decode_steps)
    for name, w in windows.items():
        print(json.dumps({"window": name, "model": args.model, "batch": args.batch,
                          "prompt_len": args.prompt_len, "card": card, **w}), flush=True)


if __name__ == "__main__":
    main()
