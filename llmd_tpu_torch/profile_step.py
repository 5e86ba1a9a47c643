"""Where a step's time goes on the GPU.

    python -m llmd_tpu_torch.profile_step [--model llama-3-8b] [--batch 32]
        [--prompt-len 1000] [--decode-steps 16] [--decode-window 8]
        [--kv-cache-dtype int8] [--kv-swa-ring] [--quantization int8]
        [--windows prefill]
    python -m llmd_tpu_torch.profile_step --engine [--async-scheduling | --ab]
        [--speculative-ngram | --kv-offload-chunks N [--kv-offload-fs-dir DIR]]
        [--prompt-kind repeat] [...]
    python -m llmd_tpu_torch.profile_step --engine --batch-load [--batch-jobs 64]

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
pools' bytes, ``kv_bytes``, either way), and ``--quantization int8`` runs
int8 weights (``ops/quant.py``: the ``quantize_rows`` kernel, its fused
forms and K6''s int8 branch, grouped as ``quantize_rows``,
``add_rms_norm_quant``, ``glu_quant`` and ``grouped_gemm``). Every engine runs ``warmup``
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
untraced host time; for an MLA model, the "other" group's device ms and
kernels a step by family (``_FAMILIES``: the latent chain, the absorption
einsums, the router, the MoE sort, gather and combine, ..., the rest; the
model's functions run inside ``record_function`` ranges for it: in the
traced prefill step itself, and for each decode window in one more step
run as its program's eager body, since a graph replay's kernels carry no
caller); the decode line also carries the host cost of building and
staging a flat decode step's static inputs (``staging_us``). The profiler adds host time to every operator, so each
window's steps are also timed without it (``untraced_host_ms_per_step``),
before the profiler first starts: up to ``PREFILL_STEPS`` prefill steps
(the per-step times and their median ride along, with the garbage
collector's passes and milliseconds inside them), the decode windows'
steps as above. The prefill line also carries the costliest Python
functions of as many more prefill steps by own time (``cProfile``: a
second set, so the timed steps stay unprofiled). ``--windows`` keeps only
the named windows (``prefill``, ``decode``, the decode window). Runs on a
GPU only.

``--engine`` times the ``LLMEngine.step`` loop itself rather than the
runner's programs: the same ``--batch`` requests through the default
engine, synchronous, with ``--async-scheduling`` the two-slot pipeline
(``SchedulerConfig.async_scheduling``), with ``--ab`` both in turns (sync,
async, async, sync) on the shared weights. Each run times ``PREFILL_STEPS``
steps of the prefill phase (after the first step) and ``--decode-steps``
steps once every request decodes: host ms a step, the engine's host gap a
step (``EngineStats.step_host_gap_ms``: under async stepping, from the
readback to the next dispatch), live tokens a step and generated tokens a
second; ``async_rollbacks_total`` too; an untraced run's prefill phase
also carries the costliest Python functions of ``PREFILL_STEPS`` more
steps (``host_profile``). Then, after every untraced run,
each mode runs once more under the profiler for the device's busy ms a
step and its idle share (1 - busy / the untraced host ms a step). A window
of n ``step()`` calls spans n readbacks; under async stepping the step in
flight when it starts is read back inside it and the last one it
dispatches is waited for at its end.

``--engine --ab --speculative-ngram`` sets speculative decoding against
its absence instead (off, on, on, off; ``--async-scheduling`` picks the
pipeline of all four) and ``--spec-verify-window`` the fused verify
window (default 1: one-shot verify steps; the engine without speculative
decoding runs window-1 steps). The decode window is timed after untimed
windows of as many steps, until one prepares no new program (a
speculative step's shape follows its drafts, and a new one is captured
at its first use; each timed window reports the programs prepared inside
it, and those prepared in the untimed windows before it with the
seconds those took: what a server pays on its first steps of each
shape), on requests long enough for 1 + k tokens a step.
Each run's windows then carry the speculative counters of their steps
(drafts proposed and accepted, their mean accepted length a verify
row-step) and, traced, the device ms a step by kernel group (K1' is
``flat_paged_attention``, K6' ``grouped_gemm``). ``--prompt-kind repeat``
builds each prompt from one random block of 64 tokens repeated, so drafts
fire (the default, ``random``, draws every token).

``--engine --ab --kv-offload-chunks N`` sets the tiered offload (a host
cache of N pages, ``EngineConfig.offload``) against its absence (off, on,
on, off; prefix caching on in all four, so that pages are committed;
``--async-scheduling`` picks the pipeline): each window also carries the
offload's host ms a step (the save path's enqueue, its wait and the host
inserts, ``OffloadConnector.save_host_s``) and the bytes it saved, and each
run with offload on a line of the page legs' rates (``page_legs``: the
save's copies into pinned host slots and the restore's copies back, 64 of
its pages, GB/s over each call's wall time, median of 5).
``--kv-offload-fs-dir DIR`` adds the file tier (each run with offload on
in a fresh directory under DIR, removed after it): with a host cache
smaller than the run's commits, the saved pages spill to files, and each
window also carries the spill writer's ms a step (its own thread,
``HostKVCache.fs_write_s``) and the pages it spilled.

``--engine --batch-load`` measures the batch tier: ``--batch``
interactive requests arrive at an engine whose slots a backlog of
``--batch-jobs`` batch requests (``PriorityClass.BATCH``, prompts of a
quarter of ``--prompt-len``, as many decode steps as the interactive
requests' times 4) fills (stepped until every slot holds a batch row, at
most 64 steps), so that their admission preempts batch rows, and at an
idle engine, in turns (without, with, with, without), untraced; each run
reports the interactive requests' TTFT (from their arrival) and TPOT,
median and p99, the steps until they all finished, the batch tokens
computed and batch rows preempted meanwhile, and the mean
``batch_backfill_utilization`` of those steps.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import cProfile
import functools
import gc
import importlib
import pstats
import json
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from llmd_tpu_torch.config import CacheConfig, EngineConfig, OffloadConfig, SchedulerConfig
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.engine.scheduler import ScheduledSeq
from llmd_tpu_torch.models import llama
from llmd_tpu_torch.models.registry import get_model_config

_GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")
# Kernel names hold these (K1'/K3' bf16 kernels and their span merges carry
# their library's tag type, e.g. tile_attention_kernel<flat_paged_attention_kernel, ...>;
# the kernels of K5' and its merge are mla_decode_attention_*_kernel, those
# of K6' grouped_gemm_*_kernel).
# K4''s latent form is latent_kv_write_kernel<...>, first: its decode
# addressing's tag names decode_kv_write.
_PORT_KERNELS = (
    "latent_kv_write", "flat_paged_attention", "flat_kv_write", "decode_paged_attention",
    "decode_kv_write", "mla_decode_attention", "grouped_gemm", "quantize_rows",
    "add_rms_norm_quant", "glu_quant",
)

# An MLA model's "other" kernels by family. For the traced steps each
# function below (module under llmd_tpu_torch, attribute) runs inside a
# ``record_function`` range of its family; a kernel's family is that of the
# innermost range around the op that launched it, or the absorption einsums
# where an aten::einsum encloses the op, else "rest" (the residual adds,
# the embedding, the step's inputs). The latent chain is what
# models/mla.py:mla_write runs itself (before K4''s latent form: rms_norm,
# apply_rope, cat, pad and the store's copies).
_FAMILIES = {
    "router": (("models.moe", "router_topk"),),
    "expert gated units": (("ops.grouped_gemm", "expert_mlp_grouped"),
                           ("models.moe", "shared_expert_ffn"), ("models.llama", "_mlp")),
    "moe sort, gather and combine": (("models.moe", "moe_apply_grouped"),
                                     ("models.llama", "moe_block_grouped")),
    "projections": (("models.mla", "pdot"), ("models.mla", "qpdot"), ("models.moe", "pdot"),
                    ("models.moe", "qpdot"), ("models.llama", "pdot"), ("models.llama", "qpdot")),
    "latent attention": (("ops", "mla_paged_attention_full"),),
    "latent chain": (("models.mla", "mla_write"),),
    "mla read": (("models.mla", "mla_read"),),
    "norms": (("models.llama", "rms_norm"),),
    "logits and sampler": (("models.llama", "compute_logits"), ("engine.runner", "sample_tokens")),
}
_RANGE = "family:"


@contextlib.contextmanager
def family_ranges():
    """Run each function of ``_FAMILIES`` inside a range of its family."""

    def ranged(family, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with record_function(_RANGE + family):
                return fn(*args, **kwargs)
        return call

    saved = []
    try:
        for family, targets in _FAMILIES.items():
            for module, name in targets:
                mod = importlib.import_module(f"llmd_tpu_torch.{module}")
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, ranged(family, saved[-1][2]))
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def _group(kernel: str) -> str:
    for name in _PORT_KERNELS:
        if name in kernel:
            return name
    if any(m in kernel.lower() for m in _GEMM_MARKS):
        return "gemm"
    return "other"


def _family(op) -> str:
    """The family of a CPU op traced under ``family_ranges``."""
    while op is not None:
        if op.name == "aten::einsum":
            return "absorption einsums"
        if op.name.startswith(_RANGE):
            return op.name[len(_RANGE):]
        op = op.cpu_parent
    return "rest"


def other_by_family(prof, n: int) -> dict:
    """Device ms a step of the "other" kernels of a trace of ``n`` eager
    steps under ``family_ranges``, by family, and their launches a step."""
    ms: dict[str, float] = collections.defaultdict(float)
    count: dict[str, float] = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        for k in e.kernels:
            if _group(k.name) == "other" and not k.name.startswith(_RANGE):
                fam = _family(e)
                ms[fam] += k.duration / 1e3 / n
                count[fam] += 1 / n
    return {"ms_per_step": dict(sorted(ms.items(), key=lambda kv: -kv[1])),
            "kernels_per_step": dict(sorted(count.items(), key=lambda kv: -kv[1])),
            "total_ms_per_step": sum(ms.values())}


def family_step(eng: LLMEngine) -> dict:
    """One engine step traced under ``family_ranges``, its decode program
    run as its eager body (a graph replay's kernels carry no caller): the
    "other" kernels by family (``other_by_family``). It takes its tokens
    from the slack of ``main``'s token budget."""
    progs = eng.runner.programs
    replay = progs.replay
    progs.replay = progs.eager
    try:
        torch.cuda.synchronize()
        with family_ranges(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.step()
            torch.cuda.synchronize()
    finally:
        progs.replay = replay
    return other_by_family(prof, 1)


# Prefill steps timed (and as many profiled), where the prompts give them.
PREFILL_STEPS = 6


def time_steps(eng: LLMEngine, n: int) -> tuple[float, float, dict]:
    """Host milliseconds per step of ``n`` engine steps, profiler off, the
    engine's own count of their host gap (``EngineStats.step_host_gap_ms``:
    the step's host work outside the wait for its readback), per step, and
    each step's milliseconds with the garbage collector's passes and time
    among them (a step ends in its readback, so one step's time is its
    own)."""
    gap0 = eng.stats.step_host_gap_ms_total
    gcs = {"collections": 0, "ms": 0.0, "start": 0.0}

    def on_gc(phase, info):
        if phase == "start":
            gcs["start"] = time.perf_counter()
        else:
            gcs["collections"] += 1
            gcs["ms"] += (time.perf_counter() - gcs["start"]) * 1e3

    torch.cuda.synchronize()
    each = []
    gc.callbacks.append(on_gc)
    try:
        t0 = time.perf_counter()
        for _ in range(n):
            t = time.perf_counter()
            eng.step()
            each.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
    finally:
        gc.callbacks.remove(on_gc)
    steps = {"host_ms_each_step": each, "host_ms_median_step": sorted(each)[n // 2],
             "gc_collections": gcs["collections"], "gc_ms": gcs["ms"]}
    return ms, (eng.stats.step_host_gap_ms_total - gap0) / n, steps


def host_profile(eng: LLMEngine, n: int, top: int = 25) -> list:
    """``n`` engine steps under ``cProfile``: the ``top`` functions by own
    time, as [file:line(function), calls, own ms a step, cumulative ms a
    step]."""
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [[f"{f.split('/')[-1]}:{line}({fn})", nc, tt * 1e3 / n, ct * 1e3 / n]
            for (f, line, fn), (_, nc, tt, ct, _) in rows]


def trace_steps(eng: LLMEngine, n: int, untraced_ms: float, families: bool = False) -> dict:
    """Run ``n`` engine steps under the profiler; per-step averages beside
    ``untraced_ms``, the same kind of steps' host time without it. With
    ``families`` (eager steps: prefill) the "other" kernels are split by
    family too (``family_ranges``, ``other_by_family``)."""
    live0 = eng.runner.live_tokens_total
    torch.cuda.synchronize()
    ranges = family_ranges() if families else contextlib.nullcontext()
    with ranges, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
    by_group: dict[str, float] = collections.defaultdict(float)
    other: dict[str, float] = collections.defaultdict(float)
    launches = 0
    for e in prof.events():
        # A family range is on the device's timeline too, spanning kernels.
        if e.device_type != DeviceType.CUDA or e.name.startswith(_RANGE):
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
        **({"other_by_family": other_by_family(prof, n)} if families else {}),
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


def engine_window(eng: LLMEngine, n: int, traced: bool) -> dict:
    """``n`` calls of ``eng.step()``: host ms a step, the engine's host gap
    a step, live tokens a step, generated tokens a second and rollbacks
    (with offload, its save path's host ms a step and bytes); ``traced``:
    under the profiler, with the device's busy ms a step and kernels a
    step."""
    st, runner, sched = eng.stats, eng.runner, eng.scheduler
    live0, gen0, gap0 = runner.live_tokens_total, st.generation_tokens, st.step_host_gap_ms_total
    steps0, rolled0 = st.engine_steps_total, st.async_rollbacks_total
    off = eng.offloader
    host = eng._host_cache
    save0 = ((off.save_host_s, off.saved_bytes, host.fs_write_s, host.fs_spills)
             if off is not None else None)
    spec0 = (sched.spec_proposed_tokens, sched.spec_accepted_tokens, sum(sched.spec_accept_len_hist))
    torch.cuda.synchronize()
    with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if traced
          else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"steps": n, "host_ms_per_step": wall * 1e3 / n,
           "host_gap_ms_per_step": (st.step_host_gap_ms_total - gap0)
           / max(1, st.engine_steps_total - steps0),
           "live_tokens_per_step": (runner.live_tokens_total - live0) / n,
           "generated_tok_per_s": (st.generation_tokens - gen0) / wall,
           "async_rollbacks": st.async_rollbacks_total - rolled0}
    if off is not None:
        out.update(offload_save_host_ms_per_step=(off.save_host_s - save0[0]) * 1e3 / n,
                   offload_saved_bytes=off.saved_bytes - save0[1],
                   offload_fs_write_ms_per_step=(host.fs_write_s - save0[2]) * 1e3 / n,
                   offload_fs_spills=host.fs_spills - save0[3])
    if sched.spec_k:
        proposed, accepted, rows = (
            now - then for now, then in zip(
                (sched.spec_proposed_tokens, sched.spec_accepted_tokens,
                 sum(sched.spec_accept_len_hist)), spec0))
        out.update(spec_proposed=proposed, spec_accepted=accepted,
                   spec_mean_accepted_len=accepted / max(1, rows))
    if traced:
        busy, launches = 0.0, 0
        by_group: dict[str, float] = collections.defaultdict(float)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms = e.time_range.elapsed_us() / 1e3
                busy += ms
                by_group[_group(e.name)] += ms / n
                launches += 1
        if not launches:
            raise RuntimeError("the profiler recorded no CUDA kernel: no device time to report")
        out.update(device_busy_ms_per_step=busy / n, kernels_per_step=launches / n,
                   idle_share=1.0 - busy / n / out["host_ms_per_step"],
                   device_ms_per_step=dict(sorted(by_group.items())))
    return out


def page_legs(eng: LLMEngine, n: int = 64, reps: int = 5) -> dict:
    """GB/s of the offload's two legs on ``n`` pages of the engine's pool:
    the save's copies to the host (``launch_page_copies`` into pinned slots
    of a ``HostPagePool``, then ``wait_copies``) and the restore's copies
    back (``scatter_pages`` from those slots, synchronized at its end);
    the pages' bytes over each call's wall time, median of ``reps``."""
    from llmd_tpu_torch.kvtransfer.offload import HostPagePool

    runner = eng.runner
    pool = HostPagePool(runner.page_shape, runner.staging_dtype, pin=runner.device.type == "cuda")
    slots = [pool.take() for _ in range(n)]
    ids = list(range(1, n + 1))
    nbytes = sum(t.nbytes for t in slots)
    saves, restores = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.wait_copies(runner.launch_page_copies(ids, slots))
        saves.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        runner.scatter_pages(ids, slots)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t0)
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    return {"pages": n, "bytes": nbytes, "save_ms": med(saves) * 1e3,
            "restore_ms": med(restores) * 1e3, "d2h_gb_per_s": nbytes / med(saves) / 1e9,
            "h2d_gb_per_s": nbytes / med(restores) / 1e9}


def pcts(xs: list[float]) -> dict:
    xs = sorted(xs)
    return {"median": xs[len(xs) // 2], "p99": xs[min(len(xs) - 1, int(0.99 * len(xs)))],
            "n": len(xs)}


def batch_load_runs(args, loaded_engine, card: str, warmups: dict, sp_interactive,
                    interactive: list, jobs: list) -> None:
    """``--engine --batch-load``: the interactive requests at an engine
    running the batch backlog and at one without it, in turns (without,
    with, with, without); one JSON line a run."""
    from llmd_tpu_torch.engine import PriorityClass

    def run(backlog: bool) -> dict:
        eng = loaded_engine("batch" if backlog else "plain", queue=False)
        eng.step()  # allocates the working memory the captures handed back
        sp_batch = SamplingParams(temperature=0.0, max_tokens=args.decode_steps * 4, ignore_eos=True)
        if backlog:
            for p in jobs:
                eng.add_request(p, sp_batch, priority=int(PriorityClass.BATCH))
            slots = eng.config.scheduler.max_num_seqs
            for _ in range(64):
                if eng.scheduler.num_running >= slots:
                    break
                eng.step()
        st = eng.stats
        tok0, pre0 = st.batch_tokens, st.batch_preemptions
        running_batch = sum(1 for r in eng.scheduler.running if r.is_batch)
        arrive: dict[str, float] = {}
        times: dict[str, list[float]] = {}
        t0 = time.perf_counter()
        for p in interactive:
            rid = eng.add_request(p, sp_interactive)
            arrive[rid] = time.perf_counter()
            times[rid] = []
        steps, util = 0, []
        while any(len(times[r]) < sp_interactive.max_tokens for r in times):
            outs = eng.step()
            now = time.perf_counter()
            steps += 1
            util.append(st.batch_backfill_utilization)
            for o in outs:
                if o.request_id in times:
                    times[o.request_id] += [now] * len(o.new_token_ids)
        wall = time.perf_counter() - t0
        ttft = [(t[0] - arrive[r]) * 1e3 for r, t in times.items()]
        tpot = [(t[-1] - t[0]) * 1e3 / (len(t) - 1) for t in times.values()]
        rec = {"mode": "batch backlog" if backlog else "no backlog", "batch_jobs": len(jobs) if backlog else 0,
               "batch_rows_running_at_arrival": running_batch,
               "interactive": len(interactive), "ttft_ms": pcts(ttft), "tpot_ms": pcts(tpot),
               "steps": steps, "wall_s": wall, "batch_tokens_meanwhile": st.batch_tokens - tok0,
               "batch_preemptions_meanwhile": st.batch_preemptions - pre0,
               "batch_backfill_utilization_mean": sum(util) / len(util),
               **warmups["batch" if backlog else "plain"]}
        del eng
        gc.collect()
        return rec

    for backlog in (False, True, True, False):
        print(json.dumps({"window": "batch_load", "model": args.model, "prompt_len": args.prompt_len,
                          "quantization": args.quantization, "card": card, **run(backlog)}),
              flush=True)


def engine_runs(args, modes: list[bool], loaded_engine, n_prefill: int, card: str,
                warmups: dict) -> None:
    """``--engine``: the step loop of each mode in ``modes`` (False: sync,
    True: async; with ``--speculative-ngram``, False: speculative decoding
    off, True: on; with ``--kv-offload-chunks``, False: offload off, True:
    on), untraced in that order, then traced once a mode; one JSON line a
    run, and with offload on a line of the page legs' rates."""
    legs = []

    def run(mode: bool, traced: bool) -> dict:
        if args.kv_offload_chunks:
            name = "offload" if mode else "no offload"
            sched = dict(async_scheduling=args.async_scheduling, offload=mode)
        elif args.speculative_ngram:
            name = "spec" if mode else "plain"
            sched = dict(async_scheduling=args.async_scheduling, speculative_ngram=mode)
            if mode:
                sched.update(spec_verify_window=args.spec_verify_window)
        else:
            name = "async" if mode else "sync"
            sched = dict(async_scheduling=mode)
        eng = loaded_engine(name, **sched)
        eng.step()  # allocates the working memory the captures handed back
        prefill = engine_window(eng, n_prefill, traced)
        if not traced:
            prefill["host_profile"] = host_profile(eng, n_prefill)
        sched = eng.scheduler
        while sched.waiting or not all(r.in_decode for r in sched.running):
            eng.step()
        eng.step()
        programs, untimed = len(eng.runner.programs.programs), 0.0
        if args.speculative_ngram:
            # A speculative step's shape (a flat step's stream length, a
            # verify program's rows) follows its drafts, and a decode step
            # of a new shape is captured at its first use: untimed windows
            # first, until one prepares no new program (at most four), so
            # that the timed one replays. A server pays those captures on
            # its first steps of each shape.
            for _ in range(4):
                before = len(eng.runner.programs.programs)
                t0 = time.perf_counter()
                for _ in range(args.decode_steps):
                    eng.step()
                untimed += time.perf_counter() - t0
                if len(eng.runner.programs.programs) == before:
                    break
        captured = len(eng.runner.programs.programs) - programs
        programs = len(eng.runner.programs.programs)
        decode = engine_window(eng, args.decode_steps, traced)
        decode["programs_prepared_in_window"] = len(eng.runner.programs.programs) - programs
        decode.update(programs_prepared_before_window=captured, untimed_windows_s=untimed)
        rec = {"mode": name, "traced": traced, "prefill": prefill, "decode": decode,
               **warmups[name]}
        if eng.offloader is not None:
            rec["offload_host_stats"] = eng._host_cache.stats()
            if not traced:
                legs.append(page_legs(eng))
            eng.close()
            if args.kv_offload_fs_dir:
                shutil.rmtree(eng._host_cache.fs_dir, ignore_errors=True)
        del eng
        gc.collect()
        return rec

    untraced = [run(m, False) for m in modes]
    traced = {m: run(m, True) for m in dict.fromkeys(modes)}
    for rec, mode in [*zip(untraced, modes), *((r, m) for m, r in traced.items())]:
        if not rec["traced"]:
            # Idle share at the untraced step time, from the traced run's busy ms.
            for window in ("prefill", "decode"):
                busy = traced[mode][window]["device_busy_ms_per_step"]
                rec[window]["device_busy_ms_per_step_traced"] = busy
                rec[window]["idle_share"] = 1.0 - busy / rec[window]["host_ms_per_step"]
        print(json.dumps({"window": "engine", "model": args.model, "batch": args.batch,
                          "prompt_len": args.prompt_len, "prompt_kind": args.prompt_kind,
                          "kv_cache_dtype": args.kv_cache_dtype or "model",
                          "kv_swa_ring": args.kv_swa_ring, "quantization": args.quantization,
                          "kv_offload_chunks": args.kv_offload_chunks,
                          "card": card, **rec}), flush=True)
    for rec in legs:
        print(json.dumps({"window": "page_legs", "model": args.model,
                          "kv_cache_dtype": args.kv_cache_dtype or "model", "card": card, **rec}),
              flush=True)


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
    p.add_argument("--quantization", default=None, choices=["int8"],
                   help="int8 weights (ModelConfig.quantization)")
    p.add_argument("--windows", nargs="+", default=None,
                   help="only these windows: prefill, decode, decode_window_<K>")
    p.add_argument("--engine", action="store_true",
                   help="time the LLMEngine.step loop, sync (default) or async")
    p.add_argument("--async-scheduling", action="store_true",
                   help="with --engine: the engine's two-slot pipeline")
    p.add_argument("--ab", action="store_true",
                   help="with --engine: sync and async in turns (sync, async, async, sync)")
    p.add_argument("--speculative-ngram", action="store_true",
                   help="with --engine --ab: speculative decoding off and on in turns")
    p.add_argument("--spec-verify-window", type=int, default=1,
                   help="with --speculative-ngram: the fused verify window (1: one-shot)")
    p.add_argument("--prompt-kind", default="random", choices=["random", "repeat"],
                   help="random tokens, or one random 64-token block repeated")
    p.add_argument("--kv-offload-chunks", type=int, default=0,
                   help="with --engine --ab: the tiered offload (a host cache of N pages) "
                        "off and on in turns")
    p.add_argument("--kv-offload-fs-dir", default=None,
                   help="with --kv-offload-chunks: the file tier, each run in a fresh "
                        "directory under this one")
    p.add_argument("--batch-load", action="store_true",
                   help="with --engine: interactive TTFT and TPOT with and without a "
                        "batch backlog, in turns")
    p.add_argument("--batch-jobs", type=int, default=64,
                   help="with --batch-load: the backlog's batch requests")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_model_config(args.model, quantization=args.quantization)
    page = 16
    # Requests prefilled early decode while later ones prefill, so each
    # runs long enough to still be decoding in both passes over its window
    # (untraced, then traced).
    prefill_steps = -(-args.batch * args.prompt_len // args.max_num_batched_tokens) + 1
    # Timed and profiled steps after the untimed first, and one to spare.
    n_prefill = max(1, min(PREFILL_STEPS, (prefill_steps - 3) // 2))
    max_tokens = prefill_steps + 2 * args.decode_steps + 2 * args.decode_window + 8
    if args.speculative_ngram:
        # A step emits up to 1 + k = 5 tokens a row (k at its default, 4);
        # the rows must still decode through the untimed and timed windows.
        max_tokens = 5 * (prefill_steps + 5 * args.decode_steps) + 8
    per_seq = -(-(args.prompt_len + max_tokens) // page)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = llama.init_params(cfg, gen, "cuda", fused=True)
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True)

    warmups: dict[str, dict] = {}

    def loaded_engine(name: str, offload: bool = False, queue: bool = True,
                      **sched) -> LLMEngine:
        """An engine on the shared weights, warmed up (its seconds, graphs
        and kept device memory recorded under ``name``), with ``--batch``
        requests queued unless ``queue`` is false; ``offload``: a host cache
        of ``--kv-offload-chunks`` pages."""
        blocks = args.batch * per_seq + 64
        if args.batch_load:
            blocks += args.batch_jobs * per_seq
        config = EngineConfig(
            model=cfg,
            cache=CacheConfig(page_size=page, num_blocks=blocks,
                              dtype=args.kv_cache_dtype or cfg.dtype,
                              enable_prefix_caching=bool(args.kv_offload_chunks),
                              swa_ring=args.kv_swa_ring),
            scheduler=SchedulerConfig(max_num_seqs=max(64, args.batch),
                                      max_num_batched_tokens=args.max_num_batched_tokens,
                                      **sched),
            seed=args.seed,
            offload=OffloadConfig(
                cpu_chunks=args.kv_offload_chunks,
                fs_dir=(tempfile.mkdtemp(prefix="kv-fs-", dir=args.kv_offload_fs_dir)
                        if args.kv_offload_fs_dir else None)) if offload else None,
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
        if queue:
            for prompt in prompts(args.batch, args.seed):
                eng.add_request(prompt, sp)
        return eng

    def prompts(n: int, seed: int) -> list[list[int]]:
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(n):
            if args.prompt_kind == "repeat":
                block = rng.integers(3, cfg.vocab_size, size=64)
                out.append(np.resize(block, args.prompt_len).tolist())
            else:
                out.append(rng.integers(3, cfg.vocab_size, size=args.prompt_len).tolist())
        return out

    if args.engine and args.batch_load:
        sp_i = SamplingParams(temperature=0.0, max_tokens=args.decode_steps, ignore_eos=True)
        jobs = [p[: max(1, args.prompt_len // 4)] for p in prompts(args.batch_jobs, args.seed + 1)]
        batch_load_runs(args, loaded_engine, card, warmups, sp_i, prompts(args.batch, args.seed),
                        jobs)
        return
    if args.engine:
        modes = [False, True, True, False] if args.ab else [args.async_scheduling]
        engine_runs(args, modes, loaded_engine, n_prefill, card, warmups)
        return

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
    wanted = set(args.windows or ("prefill", "decode", window))
    steps = {}
    if "decode" in wanted:
        steps["decode"] = (decoding(loaded_engine("decode")), args.decode_steps)
    if window in wanted:
        steps[window] = (decoding(loaded_engine(window, decode_window=args.decode_window)),
                         max(1, args.decode_steps // args.decode_window))
    untraced, profiled = {}, None
    if "prefill" in wanted:
        eng = prefilling(loaded_engine("prefill"))
        untraced["prefill"] = time_steps(eng, n_prefill)
        profiled = host_profile(eng, n_prefill)
        del eng
    for name, (eng, n) in steps.items():
        untraced[name] = time_steps(eng, n)
    # An MLA engine has no flat step to stage.
    staging = (staging_us(steps["decode"][0]) if "decode" in steps and steps["decode"][0].runner.flat
               else None)
    windows = {}
    if "prefill" in wanted:
        windows["prefill"] = trace_steps(prefilling(loaded_engine("prefill")), 1, untraced["prefill"][0],
                                         families=cfg.is_mla)
    for name, (eng, n) in steps.items():
        windows[name] = trace_steps(eng, n, untraced[name][0])
        if cfg.is_mla:
            windows[name]["other_by_family"] = {
                **family_step(eng), "steps": "one eager body (no graph replay)"}
    for name, w in windows.items():
        replays = {str(k): n for k, n in steps[name][0].runner.programs.runs.items()} if name in steps else {}
        print(json.dumps({"window": name, "model": args.model, "batch": args.batch,
                          "kv_cache_dtype": args.kv_cache_dtype or cfg.dtype,
                          "kv_swa_ring": args.kv_swa_ring, "quantization": args.quantization,
                          "prompt_len": args.prompt_len, "card": card, **warmups[name],
                          "graph_replays": replays,
                          "untraced_host_gap_ms_per_step": untraced[name][1],
                          "untraced_steps": untraced[name][2],
                          **({"host_profile": profiled} if name == "prefill" and profiled else {}),
                          **({"host_staging": staging} if name == "decode" and staging else {}), **w}),
              flush=True)


if __name__ == "__main__":
    main()
