"""Time the MoE and MLA kernels of two checkouts of this repository in one
process on one card, in turns (other, this, this, other).

    python -m llmd_tpu_torch.kernel_ab --other path/to/checkout
    python -m llmd_tpu_torch.kernel_ab --sweep

``--other`` is the root of another checkout (for example the parent commit,
unpacked with ``git archive`` into a directory ``.gitignore`` lists). Each
turn imports that tree's ``llmd_tpu_torch``, builds its kernels into that
tree's ``build/`` and times, at ``chip_smoke.py``'s shapes with random bf16
inputs from a seed: K6' (``ops.grouped_matmul``) at deepseek-v2-lite's and
gpt-oss-20b's expert shapes, a decode and a prefill step each, alone and as
an MoE layer's gate and up (``ops.grouped_matmul_pair`` where the tree has
it, else two calls), and K5' (``ops.mla_decode_paged_attention_full``) on a
decode step of 48 live rows at 1k-4k context (16 heads, and 128 where the
tree takes them). The int8 branch of K6' (``ops.matmul_q8``,
``ops.grouped_matmul_q8`` and ``_pair``, where the tree has them) at
``chip_smoke.py``'s ``quant_kernels`` shapes: llama-3-8b's and
qwen3-32b's dense products at a 32-row decode step, llama-3-8b's at 64 rows
and a 1,024-token prefill, deepseek-v2-lite's dense-layer down (K 10,944)
at a 128-token step, and the experts' pair and down at
deepseek-v2-lite's and gpt-oss-20b's decode and prefill steps; random int8
rows and weights from a seed, each checkout fed its weights in its own
layout (K-major ``[.., N, K]`` where its ``ops.grouped_gemm.Q8_K_MAJOR``
says so, else ``[.., K, N]``; both copies are made once). Times are device
milliseconds a call: 20 calls captured in a CUDA graph, the median of 7
replays. Prints one JSON line a turn, then the card's name and power limit.

``--sweep`` times this tree's int8 rows alone, once in every column tile
``ops.grouped_gemm.q8_plan`` could give the row's form (swap-AB: 64 or 128
columns; prefill: 128 or 256), each held bit-equal to the plain version
first: the data ``q8_plan``'s cost model is fitted to. One JSON line a
row.
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
    q8 = {}
    gi = torch.Generator(device=dev).manual_seed(41)

    def rq(shape):
        return torch.randint(-127, 128, shape, generator=gi, device=dev, dtype=torch.int8)

    def scales(shape):
        return torch.rand(shape, generator=gi, device=dev) / 127

    for name, (M, K, N) in Q8_DENSE.items():
        w = rq((N, K))
        q8[name] = (rq((M, K)), scales(M), (w, w.T.contiguous()), scales(N), None, None)
    for name, (T, E, k, K, N, pair) in Q8_GROUPED.items():
        ids = torch.rand((T, E), generator=gen).argsort(dim=1)[:, :k]
        gs = torch.bincount(ids.reshape(-1), minlength=E).to(torch.int32).to(dev)
        w = rq((E, N, K))
        wb = rq((E, N, K)) if pair else None
        q8[name] = (rq((T * k, K)), scales(T * k), (w, w.mT.contiguous()), scales((E, N)),
                    None if wb is None else (wb, wb.mT.contiguous()), gs)
    return {"gemm": gemm, "latent": latent, "q8": q8}


# int8 products: name -> (M, K, N) dense, (T, E, k, K, N, pair) grouped.
Q8_DENSE = {
    "int8 dense decode 32, wqkv": (32, 4096, 6144), "int8 dense decode 32, wo": (32, 4096, 4096),
    "int8 dense decode 32, w_gu": (32, 4096, 28672), "int8 dense decode 32, w_down": (32, 14336, 4096),
    "int8 dense decode 32, lm_head": (32, 4096, 128256), "int8 dense decode 64, w_gu": (64, 4096, 28672),
    "int8 dense prefill 1024, wqkv": (1024, 4096, 6144), "int8 dense prefill 1024, w_gu": (1024, 4096, 28672),
    "int8 dense prefill 1024, w_down": (1024, 14336, 4096),
    "int8 qwen3-32b decode 32, wqkv": (32, 5120, 10240), "int8 qwen3-32b decode 32, wo": (32, 8192, 5120),
    "int8 qwen3-32b decode 32, w_gu": (32, 5120, 51200), "int8 qwen3-32b decode 32, w_down": (32, 25600, 5120),
    "int8 deepseek dense prefill 128, w_down": (128, 10944, 2048),
}
Q8_GROUPED = {
    "int8 deepseek decode 48, pair": (48, 64, 6, 2048, 1408, True),
    "int8 deepseek decode 48, down": (48, 64, 6, 1408, 2048, False),
    "int8 deepseek prefill 1024, pair": (1024, 64, 6, 2048, 1408, True),
    "int8 gpt-oss decode 32, pair": (32, 32, 4, 2880, 2880, True),
    "int8 gpt-oss decode 32, down": (32, 32, 4, 2880, 2880, False),
    "int8 gpt-oss prefill 1024, pair": (1024, 32, 4, 2880, 2880, True),
}


def turn(ops, data) -> dict:
    row = {}
    if hasattr(ops, "matmul_q8"):
        k_major = getattr(sys.modules["llmd_tpu_torch.ops.grouped_gemm"], "Q8_K_MAJOR", False)
        pick = (lambda w: w[0]) if k_major else (lambda w: w[1])  # noqa: E731
        for name, (xq, a, w, sw, wb, gs) in data["q8"].items():
            bf = torch.bfloat16
            if gs is None:
                fn = lambda: ops.matmul_q8(xq, a, pick(w), sw, bf)  # noqa: E731
            elif wb is not None:
                fn = lambda: ops.grouped_matmul_q8_pair(xq, a, pick(w), sw, pick(wb), sw, gs, bf)  # noqa: E731
            else:
                fn = lambda: ops.grouped_matmul_q8(xq, a, pick(w), sw, gs, bf)  # noqa: E731
            row[name] = device_ms(fn)
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


def sweep(ops, data) -> None:
    """Each int8 row in every column tile of its form."""
    gg = sys.modules["llmd_tpu_torch.ops.grouped_gemm"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = gg.q8_plan
    bf = torch.bfloat16
    try:
        for name, (xq, a, w, sw, wb, gs) in data["q8"].items():
            w, wb = w[0], None if wb is None else wb[0]
            M, (G, N, K) = xq.shape[0], (1, *w.shape) if gs is None else w.shape
            if gs is None:
                fn = lambda: (ops.matmul_q8(xq, a, w, sw, bf),)  # noqa: E731
                plain = lambda: (ops.matmul_q8_plain(xq, a, w, sw, bf),)  # noqa: E731
            elif wb is not None:
                fn = lambda: ops.grouped_matmul_q8_pair(xq, a, w, sw, wb, sw, gs, bf)  # noqa: E731
                plain = lambda: ops.grouped_matmul_q8_pair_plain(xq, a, w, sw, wb, sw, gs, bf)  # noqa: E731
            else:
                fn = lambda: (ops.grouped_matmul_q8(xq, a, w, sw, gs, bf),)  # noqa: E731
                plain = lambda: (ops.grouped_matmul_q8_plain(xq, a, w, sw, gs, bf),)  # noqa: E731
            base = chosen(M, G, N, K, sms, wb is not None)
            want = plain()
            row = {}
            for cols in (64, 128) if base.swap else (128, 256):
                plan = gg.Q8Plan(base.swap, base.rows, cols)
                gg.q8_plan = lambda *args, plan=plan, **kw: plan
                got = fn()
                if not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise AssertionError(f"{name} {plan}: the kernel differs from the plain version")
                row[f"{cols} columns"] = device_ms(fn)
                gg.q8_plan = chosen
            print(json.dumps({"row": name, "chosen": base._asdict(), "ms": row}), flush=True)
    finally:
        gg.q8_plan = chosen


def main() -> int:
    p = argparse.ArgumentParser(prog="python -m llmd_tpu_torch.kernel_ab")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--other", help="root of the other checkout")
    mode.add_argument("--sweep", action="store_true", help="every form of this tree's int8 rows")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    data = inputs(dev)
    if args.sweep:
        sweep(load_ops(REPO), data)
    else:
        trees = {"other": os.path.abspath(args.other), "this": REPO}
        for side in ("other", "this", "this", "other"):
            print(json.dumps({"tree": side, **turn(load_ops(trees[side]), data)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
