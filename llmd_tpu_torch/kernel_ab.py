"""Time the MoE and MLA kernels of two checkouts of this repository in one
process on one card, in turns (other, this, this, other).

    python -m llmd_tpu_torch.kernel_ab --other path/to/checkout

``--other`` is the root of another checkout (for example the parent commit,
unpacked with ``git archive`` into a directory ``.gitignore`` lists). Each
turn imports that tree's ``llmd_tpu_torch``, builds its kernels into that
tree's ``build/`` and times, at ``chip_smoke.py``'s shapes with random bf16
inputs from a seed: K6' (``ops.grouped_matmul``) at deepseek-v2-lite's and
gpt-oss-20b's expert shapes, a decode and a prefill step each, alone and as
an MoE layer's gate and up (``ops.grouped_matmul_pair`` where the tree has
it, else two calls), and K5' (``ops.mla_decode_paged_attention_full``) on a
decode step of 48 live rows at 1k-4k context (16 heads, and 128 where the
tree takes them). Times are device milliseconds a call: 20 calls captured in
a CUDA graph, the median of 7 replays. Prints one JSON line a turn, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_ops(root: str):
    """``llmd_tpu_torch.ops`` of the checkout at ``root``, kernels built."""
    for name in [m for m in sys.modules if m == "llmd_tpu_torch" or m.startswith("llmd_tpu_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        from llmd_tpu_torch import ops
        from llmd_tpu_torch.ops import _build

        _build.build_all()
    finally:
        sys.path.pop(0)
    return ops


def device_ms(fn, calls: int = 20, reps: int = 7) -> float:
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
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[reps // 2]


def inputs(dev) -> dict:
    gen = torch.Generator().manual_seed(2024)
    g = torch.Generator(device=dev).manual_seed(31)
    gemm = {}
    for name, (T, E, k, K, N) in {
        "deepseek-v2-lite decode 48 rows": (48, 64, 6, 2048, 1408),
        "deepseek-v2-lite prefill 1024 tokens": (1024, 64, 6, 2048, 1408),
        "gpt-oss-20b decode 32 tokens": (32, 32, 4, 2880, 2880),
        "gpt-oss-20b prefill 1024 tokens": (1024, 32, 4, 2880, 2880),
    }.items():
        ids = torch.rand((T, E), generator=gen).argsort(dim=1)[:, :k]
        gs = torch.bincount(ids.reshape(-1), minlength=E).to(torch.int32).to(dev)
        x = torch.randn((T * k, K), generator=g, device=dev).to(torch.bfloat16)
        w = [(torch.randn((E, K, N), generator=g, device=dev) * K**-0.5).to(torch.bfloat16)
             for _ in range(2)]
        gemm[name] = (x, w, gs)
    page, Dl, rank, L, B = 16, 640, 512, 27, 64
    ctx = torch.randint(1024, 4097, (48,), generator=gen).tolist()
    need = [-(-n // page) for n in ctx]
    perm = torch.randperm(sum(need) + 8, generator=gen).to(torch.int32)
    table = torch.zeros((B, 2048), dtype=torch.int32)
    off = 0
    for r, n in enumerate(need):
        table[r, :n] = perm[off : off + n]
        off += n
    pool = torch.randn((L, sum(need) + 8, 1, page, Dl), generator=g, device=dev, dtype=torch.bfloat16)
    latent = {H: (torch.randn((B, 1, H, Dl), generator=g, device=dev, dtype=torch.bfloat16), pool,
                  L // 2, table.to(dev), torch.tensor(ctx + [0] * (B - 48), dtype=torch.int32, device=dev),
                  rank, 192**-0.5) for H in (16, 128)}
    return {"gemm": gemm, "latent": latent}


def turn(ops, data) -> dict:
    row = {}
    for name, (x, (wa, wb), gs) in data["gemm"].items():
        row[f"{name}, gate"] = device_ms(lambda: ops.grouped_matmul(x, wa, gs))
        if hasattr(ops, "grouped_matmul_pair"):
            pair = lambda: ops.grouped_matmul_pair(x, wa, wb, gs)  # noqa: E731
        else:
            pair = lambda: (ops.grouped_matmul(x, wa, gs), ops.grouped_matmul(x, wb, gs))  # noqa: E731
        row[f"{name}, gate and up"] = device_ms(pair)
    for H, args in data["latent"].items():
        try:
            row[f"latent decode, {H} heads"] = device_ms(lambda: ops.mla_decode_paged_attention_full(*args))
        except ValueError as e:  # a tree whose kernel refuses the head count
            row[f"latent decode, {H} heads"] = f"refused: {e}"
    return row


def main() -> int:
    p = argparse.ArgumentParser(prog="python -m llmd_tpu_torch.kernel_ab")
    p.add_argument("--other", required=True, help="root of the other checkout")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    data = inputs(dev)
    trees = {"other": os.path.abspath(args.other), "this": REPO}
    for side in ("other", "this", "this", "other"):
        print(json.dumps({"tree": side, **turn(load_ops(trees[side]), data)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
