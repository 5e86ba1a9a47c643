#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``llmd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``llmd_tpu_torch/ops/csrc`` and drives
its main path at the full width of llama-3-8b (random weights from a seed):

1. ``device``  the card's name, and its name and power limit from nvidia-smi.
2. ``build``   nvcc of every kernel source, all started together.
3. ``kernels`` each kernel on one mixed flat step at llama-3-8b shapes
               (3 prefill chunks + 32 decode rows, bf16, 32-layer pool)
               against its plain PyTorch version on the same inputs, and
               timed beside its bound, the plain version and one PyTorch
               library call computing the same function.
4. ``forward`` one mixed flat step of the 32-layer model through the
               kernels and through the plain versions on the card.
5. ``engine``  ``LLMEngine`` serving 8 greedy requests (chunked prefill and
               a prefix-cache hit included); every kernel's launch count
               must equal layers x steps.
6. ``serve``   ``python -m llmd_tpu_torch.serve`` answering three
               ``/v1/completions`` requests (one streamed).

Each phase prints one JSON line. Any failure raises and exits non-zero
without printing a result. On success the line before the last is the
kernel table and the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of ``llmd_tpu``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import socket
import statistics
import subprocess
import sys
import time
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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mixed_step(cfg, page, max_pages, prefills, decode_ctx, gen, dev):
    """A packed flat step: prefill chunks (prefix, chunk) then one-token
    decode rows at context lengths ``decode_ctx``; every row gets its own
    physical pages (a random permutation of the pool). Returns the
    per-token tensors, the page table and the pool size in pages."""
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
        "num_pages": num_pages, "rows_spec": rows_spec,
    }


def kernels_phase(info: dict) -> dict:
    from llmd_tpu_torch import ops
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
    k = torch.randn((T, 1, K, D), generator=g, device=dev, dtype=dt)
    v = torch.randn((T, 1, K, D), generator=g, device=dev, dtype=dt)
    es = pool.element_size()
    info.update(T=T, live_tokens=total, pool_pages=s["num_pages"], layers=L)
    out = []

    # --- K2': flat KV write. The pool bytes must equal the plain version's
    # exactly: both are pure copies of the same bf16 values.
    ref = pool.clone()
    args = (layer, k, v, s["page_table"], s["rows"], s["positions"], total)
    ops.write_kv_pages_flat_full(pool, *args)
    ops.write_kv_pages_flat_plain(ref, *args)
    torch.cuda.synchronize()
    if not torch.equal(pool, ref):
        raise AssertionError("flat_kv_write: pool bytes differ from the plain version")
    err = (pool[layer].float() - ref[layer].float()).abs().max().item()
    del ref
    pos_l = s["positions"][:total].long()
    phys = s["page_table"][s["rows"][:total].long(), pos_l // page].long()
    slot = pos_l % page
    heads = torch.arange(K, device=dev)
    kv_live = torch.cat([k[:total, 0], v[:total, 0]], dim=-1)
    layer_view = pool[layer]
    nbytes = 2 * (2 * total * K * D * es) + 3 * 4 * total  # k|v in, pool out, indices
    b_ms, b_by = bound(nbytes, 0.0)
    out.append({
        "name": "flat_kv_write", "route": "cuda",
        "source": "llmd_tpu_torch/ops/csrc/flat_kv_write.cu",
        "replaces": "llmd_tpu/ops/kv_write.py:212",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.write_kv_pages_flat_full(pool, *args)),
        "plain_ms": cuda_ms(lambda: ops.write_kv_pages_flat_plain(pool, *args)),
        "bound_ms": b_ms, "bound_by": b_by,
        # one index_put_ with the (page, head, slot) indices precomputed
        "library_ms": cuda_ms(lambda: layer_view.index_put_(
            (phys[:, None], heads[None, :], slot[:, None]), kv_live)),
    })

    # --- K1': flat paged attention, against the plain version within
    # atol 2e-2 + rtol 1e-2: both reduce in f32 and round the output to
    # bf16 once; summation order differs, so an output may land one bf16
    # ulp apart (2^-8 relative, 0.0078 at 1.0).
    aargs = (q, pool, layer, s["rows"], s["page_table"], s["kv_lens"])
    got = ops.flat_paged_attention_full(*aargs)
    want = ops.flat_paged_attention_plain(*aargs)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if not torch.isfinite(got).all() or (diff > 2e-2 + 1e-2 * want.float().abs()).any():
        raise AssertionError(f"flat_paged_attention: max abs err {err} vs plain")
    # Bound: every row's distinct live K|V read once, q read, out written;
    # operations: QK and PV, 2 flops per multiply-add, per live token.
    ctx = [p0 + w for p0, w in s["rows_spec"]]
    kv_bytes = sum(ctx) * K * 2 * D * es
    qo_bytes = 2 * total * H * D * es
    flops = 4.0 * H * D * s["kv_lens"].sum().item()
    b_ms, b_by = bound(kv_bytes + qo_bytes, flops)
    lib_ms = _sdpa_yardstick(q, pool, layer, s, page)
    out.append({
        "name": "flat_paged_attention", "route": "cuda",
        "source": "llmd_tpu_torch/ops/csrc/flat_paged_attention.cu",
        "replaces": "llmd_tpu/ops/ragged_paged_attention.py:344",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.flat_paged_attention_full(*aargs)),
        "plain_ms": cuda_ms(lambda: ops.flat_paged_attention_plain(*aargs), reps=20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
    })
    for e in out:
        info[e["name"]] = {key: e[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
    return {e["name"]: e for e in out}


def _sdpa_yardstick(q, pool, layer, s, page) -> float:
    """Time of one ``scaled_dot_product_attention`` call on the same step,
    with each row's live context gathered to a dense, padded layout
    beforehand (the gather is not timed)."""
    import torch.nn.functional as F

    T, _, H, D = q.shape
    K = pool.shape[2]
    spec = s["rows_spec"]
    R = len(spec)
    qmax = max(w for _, w in spec)
    smax = max(p0 + w for p0, w in spec)
    dev = q.device
    Qd = torch.zeros((R, H, qmax, D), dtype=q.dtype, device=dev)
    Kd = torch.zeros((R, K, smax, D), dtype=q.dtype, device=dev)
    Vd = torch.zeros_like(Kd)
    mask = torch.zeros((R, 1, qmax, smax), dtype=torch.bool, device=dev)
    mask[..., 0] = True  # pad query slots: keep one key so no row is empty
    t = 0
    for r, (p0, w) in enumerate(spec):
        n = p0 + w
        pages = s["page_table"][r, : -(-n // page)].long()
        kv = pool[layer, pages].permute(1, 0, 2, 3).reshape(K, -1, 2 * D)[:, :n]
        Kd[r, :, :n] = kv[..., :D]
        Vd[r, :, :n] = kv[..., D:]
        Qd[r, :, :w] = q[t : t + w, 0].transpose(0, 1)
        mask[r, 0, :w, :n] = (
            torch.arange(n, device=dev)[None, :]
            <= torch.arange(p0, p0 + w, device=dev)[:, None]
        )
        t += w
    G = H // K
    Kd = Kd.repeat_interleave(G, dim=1)
    Vd = Vd.repeat_interleave(G, dim=1)
    return cuda_ms(lambda: F.scaled_dot_product_attention(Qd, Kd, Vd, attn_mask=mask))


@contextlib.contextmanager
def plain_ops():
    """Route the model's two flat ops to their plain versions (the
    reference run of the forward phase), restoring the kernels after."""
    from llmd_tpu_torch import ops

    saved = ops.write_kv_pages_full_flat, ops.paged_attention_full_flat

    def write(kv_cache, layer, k, v, page_table, rows, positions, total):
        return ops.write_kv_pages_flat_plain(
            kv_cache, layer, k, v, page_table, rows, positions.reshape(-1), total
        )

    def attend(q, kv_cache, layer, rows, page_table, kv_lens, sm_scale=None):
        return ops.flat_paged_attention_plain(
            q, kv_cache, layer, rows, page_table, kv_lens, sm_scale
        )

    ops.write_kv_pages_full_flat, ops.paged_attention_full_flat = write, attend
    try:
        yield
    finally:
        ops.write_kv_pages_full_flat, ops.paged_attention_full_flat = saved


def forward_phase(info: dict, params: dict) -> None:
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.models import llama
    from llmd_tpu_torch.models.common import StepInput
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(MODEL)
    dev, page = torch.device("cuda"), 16
    gen = torch.Generator().manual_seed(7)
    decode_ctx = torch.randint(200, 1001, (16,), generator=gen).tolist()
    s = mixed_step(cfg, page, -(-cfg.max_model_len // page),
                   [(0, 300), (600, 200)], decode_ctx, gen, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    shape = (cfg.num_layers, s["num_pages"], cfg.num_kv_heads, page, 2 * cfg.head_dim)
    pool = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    total = s["total"]
    live = torch.arange(s["T"], device=dev) < total
    ids = torch.randint(0, cfg.vocab_size, (s["T"],), generator=g, device=dev)
    inp = StepInput(
        token_ids=torch.where(live, ids, 0)[:, None],
        positions=s["positions"][:, None],
        kv_lens=s["kv_lens"],
        page_table=s["page_table"],
        token_rows=s["rows"],
        num_live=total,
    )

    def run(p: dict, pool: torch.Tensor, plain: bool) -> tuple[torch.Tensor, torch.Tensor]:
        pool = pool.clone()
        with torch.inference_mode(), plain_ops() if plain else contextlib.nullcontext():
            h, _ = llama.forward_hidden(p, pool, inp, cfg)
        return h[:total, 0].float(), pool

    def rel(a: torch.Tensor, b: torch.Tensor) -> float:
        return ((a - b).norm() / b.norm()).item()

    ops.reset_launch_counts()
    h_k, pool_k = run(params, pool, plain=False)
    counts = ops.launch_counts()
    h_p, pool_p = run(params, pool, plain=True)
    # The same step in f32 (the same weights, upcast): kernels against
    # plain versions, and the reference both bf16 runs are measured from.
    params32 = _tree_map(params, lambda w: w.float())
    h_k32, _ = run(params32, pool.float(), plain=False)
    h_ref, _ = run(params32, pool.float(), plain=True)
    del params32
    with torch.inference_mode():
        # Whole-step times in bf16 (a step rewrites the same K|V, so the
        # pool keeps its contents), CUDA events.
        fwd_ms = cuda_ms(lambda: llama.forward_hidden(params, pool_k, inp, cfg), reps=3, warmup=1)
        with plain_ops():
            fwd_plain_ms = cuda_ms(
                lambda: llama.forward_hidden(params, pool_p, inp, cfg), reps=3, warmup=1
            )
    torch.cuda.synchronize()
    if set(counts.values()) != {cfg.num_layers}:
        raise AssertionError(f"forward launched {counts}, want {cfg.num_layers} each")
    info.update(
        live_tokens=total, T=s["T"], layers=cfg.num_layers,
        f32_rel_err=rel(h_k32, h_ref), bf16_rel_err=rel(h_k, h_p),
        bf16_kernels_vs_f32=rel(h_k, h_ref), bf16_plain_vs_f32=rel(h_p, h_ref),
        layer0_pool_equal=bool(torch.equal(pool_k[0], pool_p[0])),
        step_ms=fwd_ms, step_plain_ms=fwd_plain_ms,
    )
    if not all(torch.isfinite(h).all() for h in (h_k, h_p, h_k32, h_ref)):
        raise AssertionError("forward: non-finite hidden states")
    # Layer 0 writes K|V computed from the same inputs on both paths:
    # the kernel's pool bytes must equal the plain version's.
    if not info["layer0_pool_equal"]:
        raise AssertionError("forward: layer-0 pool bytes differ between the paths")
    # f32: the two paths differ only in the attention's summation order
    # (about 1e-6 relative per layer), amplified through 32 random layers.
    if info["f32_rel_err"] > 1e-3:
        raise AssertionError(f"forward: f32 relative error {info['f32_rel_err']} (limit 1e-3)")
    # bf16: a one-ulp difference in an attention output grows through 32
    # layers of bf16 matmuls, so the two bf16 runs are not compared with
    # each other; instead the kernels' run may be no further from the f32
    # run than 1.5 times the plain run's distance.
    if info["bf16_kernels_vs_f32"] > 1.5 * info["bf16_plain_vs_f32"]:
        raise AssertionError(
            f"forward: bf16 kernels {info['bf16_kernels_vs_f32']} from f32, "
            f"plain {info['bf16_plain_vs_f32']} (limit 1.5x)"
        )


def _tree_map(tree: dict, fn) -> dict:
    return {k: _tree_map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def engine_phase(info: dict, params: dict) -> dict:
    from llmd_tpu_torch import ops
    from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from llmd_tpu_torch.engine import LLMEngine, SamplingParams
    from llmd_tpu_torch.models.registry import get_model_config

    cfg = get_model_config(MODEL)
    config = EngineConfig(
        model=cfg,
        cache=CacheConfig(page_size=16, num_blocks=2048, dtype="bfloat16"),
        scheduler=SchedulerConfig(max_num_seqs=64, max_num_batched_tokens=1024),
        seed=0,
    )
    eng = LLMEngine(config, params=params, device="cuda")
    gen = torch.Generator().manual_seed(11)
    # 1500 > max_num_batched_tokens: that prompt prefills in chunks.
    lengths = [16, 100, 300, 700, 1500, 64, 900]
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist() for n in lengths]
    sp = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True)
    ops.reset_launch_counts()
    tokens: dict[str, list[int]] = {}
    ttft: dict[str, float] = {}
    cached: dict[str, int] = {}
    t0 = time.perf_counter()
    # The 8th request repeats the 700-token prompt after the first wave has
    # committed its pages: its prefill starts from a prefix-cache hit.
    step_log: list[tuple[int, float]] = []  # (live tokens, host ms) per step
    for wave in (prompts, [prompts[3]]):
        tw = time.perf_counter()
        for p in wave:
            tokens[eng.add_request(p, sp)] = []
        while eng.has_work():
            live0, ts = eng.runner.live_tokens_total, time.perf_counter()
            # step() ends in the step's one device->host copy, so the host
            # clock spans the device work.
            for out in eng.step():
                tokens[out.request_id] += out.new_token_ids
                ttft.setdefault(out.request_id, time.perf_counter() - tw)
                cached[out.request_id] = out.num_cached_tokens
            step_log.append((eng.runner.live_tokens_total - live0,
                             (time.perf_counter() - ts) * 1e3))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = eng.stats.engine_steps_total
    counts = ops.launch_counts()
    rids = list(tokens)
    decode_ms = [ms for n, ms in step_log if n <= len(prompts)]
    info.update(
        requests=len(rids), steps=steps, wall_s=wall,
        output_tok_per_s=sum(len(t) for t in tokens.values()) / wall,
        ttft_median_s=statistics.median(ttft.values()), ttft_max_s=max(ttft.values()),
        decode_steps=len(decode_ms), decode_step_ms_median=statistics.median(decode_ms),
        prefill_steps=[[n, ms] for n, ms in step_log if n > len(prompts)],
        prefix_cached_tokens=cached[rids[-1]], repeat_matches_first=tokens[rids[-1]] == tokens[rids[3]],
        launches=counts,
    )
    if any(len(t) != 32 for t in tokens.values()):
        raise AssertionError(f"not every request produced 32 tokens: {[len(t) for t in tokens.values()]}")
    if cached[rids[-1]] <= 0:
        raise AssertionError("the repeated prompt did not hit the prefix cache")
    want = cfg.num_layers * steps
    if any(n != want for n in counts.values()):
        raise AssertionError(f"launch counts {counts} != layers x steps = {want}")
    del eng
    return counts


def _post(url: str, body: dict) -> tuple[int, bytes]:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read()


def serve_phase(info: dict) -> None:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    log_path = os.path.join(REPO, "build", "chip_smoke_serve.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "llmd_tpu_torch.serve", "--model", MODEL,
             "--host", "127.0.0.1", "--port", str(port)],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
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
            usages = []
            for body in (
                {"prompt": "The port serves llama-3-8b.", "max_tokens": 16},
                {"prompt": [3 + i % 250 for i in range(600)], "max_tokens": 16},
            ):
                status, raw = _post(base + "/v1/completions",
                                    {**body, "temperature": 0.0, "ignore_eos": True})
                if status != 200:
                    raise AssertionError(f"/v1/completions returned {status}")
                usages.append(json.loads(raw)["usage"]["completion_tokens"])
            status, raw = _post(base + "/v1/completions", {
                "prompt": "Stream this.", "max_tokens": 16, "temperature": 0.0,
                "ignore_eos": True, "stream": True,
            })
            frames = [
                json.loads(line[6:]) for line in raw.decode().splitlines()
                if line.startswith("data: {")
            ]
            if status != 200 or "usage" not in frames[-1]:
                raise AssertionError(f"streamed completion failed: {status}")
            usages.append(frames[-1]["usage"]["completion_tokens"])
            info["completion_tokens"] = usages
            if usages != [16, 16, 16]:
                raise AssertionError(f"completion_tokens {usages}, want 16 each")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
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
    with phase("forward", {}) as info:
        cfg = get_model_config(MODEL)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = llama.fuse_projections(llama.init_params(cfg, gen, "cuda"))
        forward_phase(info, params)
    with phase("engine", {}) as info:
        counts = engine_phase(info, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with phase("serve", {}) as info:
        serve_phase(info)
    emit({"kernels": [
        {**e, "launches": counts[fn]}
        for e, fn in ((table["flat_kv_write"], "write_kv_pages_flat_full"),
                      (table["flat_paged_attention"], "flat_paged_attention_full"))
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
