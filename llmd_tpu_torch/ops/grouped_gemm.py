"""Grouped GEMM for MoE expert compute: tokens sorted by expert, each expert
multiplies only its own rows.

``grouped_matmul`` launches the CUDA kernel ``csrc/grouped_gemm.cu``, which
replaces the TPU kernel ``llmd_tpu/ops/grouped_gemm.py:grouped_matmul``
(``megablox.gmm``, a library Pallas kernel). JAX takes that kernel only for
lane-tiled shapes (H and F multiples of 128) and ``lax.ragged_dot``
elsewhere; the port's kernel has no such gate and takes whatever its
``_check`` accepts. It is bound by bytes at both a decode step and a 1k-token
prefill step: every expert's weights are read once. In bf16/f16 it is a
persistent ``wgmma`` kernel fed by TMA; ``grouped_tiles`` is its work map in
plain PyTorch (the kernel walks the same items), and ``tile_choice`` picks
its tile from M and G alone. See the kernel source for its design.
``grouped_matmul_pair`` runs two weight tensors of one shape (an MoE layer's
gate and up) over the same rows in one launch. ``grouped_matmul_plain`` and
``grouped_matmul_pair_plain`` are the plain PyTorch versions: one masked
product per group over the static group count, so they read nothing back to
the host; the wrappers take them for CPU tensors only.

Around the kernel, in plain PyTorch as JAX leaves them to XLA:
``expert_mlp_grouped`` (gate and up as one pair call, the config's GLU,
down, and gpt-oss's per-expert biases) and ``moe_apply_grouped`` (stable
sort by expert, gather, grouped MLP, weighted combine). The group
sizes are counted with ``scatter_add_`` (``torch.bincount`` on CUDA reads
its input's maximum back to size its output) and the combine sums each
token's rows in ascending sorted position, the order of JAX's scatter-add
on the CPU, without ``index_add_``'s atomics.

The int8 branch (W8A8, ``ops/quant.py``; its own source,
``csrc/grouped_gemm_s8.cu``): ``grouped_matmul_q8`` takes rows already
quantized (int8 x with one f32 scale a row, from ``quantize_rows``) against
int8 weights stored K-major, ``[G, N, K]`` (the HF ``[out, in]`` layout;
s8 ``wgmma`` reads 8-bit operands from shared memory only K-major), with
per-(group, column) f32 scales; it accumulates in s32 and rescales
``(f32(acc) * a_scale) * w_scale`` into the output's dtype: bit-equal to
``grouped_matmul_q8_plain``. ``grouped_matmul_q8_pair`` is its gate|up
form (one quantized input, two weight tensors, one launch) and
``matmul_q8`` its dense form (w ``[N, K]``), one group of M rows and no
group sizes: every dense int8 product of the models (projections, shared
experts, MLA's projections, ``lm_head``) runs it. ``q8_plan`` picks the
kernel's form from ``(M, G, N, K, SMs)``: swap-AB at a decode step (the
weight tile on wgmma's 64-row side, the rows on its N side), the usual
orientation at prefill, and the column tile; an item sums all of its K
(no split K: it never paid at the models' shapes). JAX computes
these products with ``lax.ragged_dot`` and ``dot_general`` outside any
kernel, on ``[.., K, N]`` leaves. The plain versions multiply in f64,
exact for these integers (every partial sum stays below 2^31), and round
the sums to f32 as the kernel's s32 -> f32 conversion does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from llmd_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The bf16/f16 kernel's tiles (BM rows x BN columns), by the code it takes.
TILES = {0: (64, 128), 1: (128, 128)}
_MAX_GROUPS = 1024  # the kernel keeps the groups' prefix sums in shared memory
# The int8 branch's s32 sums stay exact while K * 127^2 < 2^31.
_MAX_K_S8 = (2**31 - 1) // 127**2
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("grouped_gemm")
        lib.grouped_gemm.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        lib.grouped_gemm.restype = ctypes.c_int
        _lib = lib
    return _lib


_lib_s8 = None


def _kernel_s8():
    global _lib_s8
    if _lib_s8 is None:
        lib = _build.load("grouped_gemm_s8")
        lib.grouped_gemm_s8.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p
        ]
        lib.grouped_gemm_s8.restype = ctypes.c_int
        _lib_s8 = lib
    return _lib_s8.grouped_gemm_s8


def tile_choice(M: int, G: int) -> int:
    """The kernel's tile (a key of ``TILES``) from M and G alone: 64-row
    tiles when groups average at most 32 rows (a decode step: a few rows an
    expert), else 128-row tiles, so that a group of up to 128 rows streams
    its weights once."""
    return 0 if M <= 32 * G else 1


def max_items(M: int, G: int, BM: int, ncols: int) -> int:
    """The most work items the kernel can have, which the host sizes its
    grid by: each non-empty group adds at most one partial row tile."""
    return (-(-M // BM) + min(G, M)) * ncols


def grouped_tiles(group_sizes: torch.Tensor, M: int, BM: int, ncols: int) -> torch.Tensor:
    """The kernel's work map in plain PyTorch: ``[items, 4]`` int64 rows of
    (group, first row, rows, column tile), in the order the kernel numbers
    them (row tile major). Group g has ``ceil(size_g / BM)`` row tiles of
    BM rows, the last one partial, cut at M; items with no rows are left
    out, as the kernel skips them."""
    sizes = group_sizes.long().clamp(min=0)
    nt = (sizes + BM - 1) // BM
    tstart = torch.cumsum(nt, 0) - nt
    rstart = torch.cumsum(sizes, 0) - sizes
    g = torch.repeat_interleave(torch.arange(sizes.numel(), device=sizes.device), nt)
    local = torch.arange(g.numel(), device=sizes.device) - tstart[g]
    row0 = rstart[g] + local * BM
    rows = torch.minimum(torch.minimum(sizes[g] - local * BM, torch.full_like(row0, BM)),
                         M - row0)
    keep = rows > 0
    g, row0, rows = g[keep], row0[keep], rows[keep]
    R = g.numel()
    ct = torch.arange(ncols, device=sizes.device).repeat(R)
    per = lambda t: t.repeat_interleave(ncols)  # noqa: E731
    return torch.stack([per(g), per(row0), per(rows), ct], dim=1)


def _group_ids(group_sizes: torch.Tensor, M: int, device) -> torch.Tensor:
    """Each row's group: the group whose running end first exceeds it."""
    ends = torch.cumsum(group_sizes.long(), 0)
    return torch.searchsorted(ends, torch.arange(M, device=device), right=True)


def grouped_matmul_plain(
    x: torch.Tensor,  # [M, K] rows sorted by group
    w: torch.Tensor,  # [G, K, N]
    group_sizes: torch.Tensor,  # [G] int, sums to M
) -> torch.Tensor:  # [M, N] in x's dtype
    """Plain PyTorch version: row r belongs to the group whose running end
    first exceeds r; each group's product (in f32) is kept on its rows."""
    M = x.shape[0]
    G, _, N = w.shape
    gid = _group_ids(group_sizes, M, x.device)
    xf = x.float()
    out = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for g in range(G):
        out = torch.where((gid == g)[:, None], xf @ w[g].float(), out)
    return out.to(x.dtype)


def grouped_matmul_pair_plain(
    x: torch.Tensor, w_a: torch.Tensor, w_b: torch.Tensor, group_sizes: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the pair: two ``grouped_matmul_plain``."""
    return grouped_matmul_plain(x, w_a, group_sizes), grouped_matmul_plain(x, w_b, group_sizes)


def _check(x, ws, group_sizes):
    """Raise unless the kernel takes x against each weight tensor in ``ws``
    (all of one shape)."""
    w = ws[0]
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not fit [M, K] x [G, K, N]")
    G, K, N = w.shape
    if group_sizes.shape != (G,):
        raise ValueError(f"group_sizes must be [G] = [{G}], got {tuple(group_sizes.shape)}")
    if G > _MAX_GROUPS:
        raise ValueError(f"the kernel takes at most {_MAX_GROUPS} groups, got {G}")
    if group_sizes.dtype != torch.int32:
        raise ValueError(f"group_sizes must be int32, got {group_sizes.dtype}")
    if K % 8 or N % 8:
        raise ValueError(f"the kernel takes K and N multiples of 8; got K={K}, N={N}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x {x.dtype} must be a float dtype the kernel takes")
    for name, t in (("x", x), ("group_sizes", group_sizes), *(("w", w) for w in ws)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for w in ws:
        if w.shape != ws[0].shape:
            raise ValueError(f"weights {tuple(ws[0].shape)} and {tuple(w.shape)} must share a shape")
        if w.dtype != x.dtype:
            raise ValueError(f"x {x.dtype} and w {w.dtype} must share a float dtype")
        if w.data_ptr() % 16:
            raise ValueError("x and w must be 16-byte aligned")
    if x.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")


def _launch(x, w_a, w_b, group_sizes):
    M, K = x.shape
    G, _, N = w_a.shape
    out_a = torch.empty((M, N), dtype=x.dtype, device=x.device)
    out_b = None if w_b is None else torch.empty_like(out_a)
    if M == 0:
        return out_a, out_b
    err = _kernel().grouped_gemm(
        out_a.data_ptr(), None if out_b is None else out_b.data_ptr(), x.data_ptr(),
        w_a.data_ptr(), None if w_b is None else w_b.data_ptr(), group_sizes.data_ptr(),
        M, K, N, G, _DTYPE_CODES[x.dtype], tile_choice(M, G),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"grouped_gemm launch failed: CUDA error {err}")
    return out_a, out_b


def grouped_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    group_sizes: torch.Tensor,
) -> torch.Tensor:
    """``out[r] = x[r] @ w[g(r)]`` for rows sorted by group, f32
    accumulation, output in x's dtype. ``group_sizes`` stays on the device:
    the kernel finds its tiles from it, so nothing is read back.

    CUDA tensors launch the kernel on the current stream; CPU tensors take
    the plain version."""
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, (w,), group_sizes)
    out, _ = _launch(x, w, None, group_sizes)
    if x.shape[0]:
        grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0


def grouped_matmul_pair(
    x: torch.Tensor,
    w_a: torch.Tensor,  # [G, K, N]
    w_b: torch.Tensor,  # [G, K, N]
    group_sizes: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x @ w_a[g], x @ w_b[g])`` row by row in one launch: the kernel's
    column tiles span both weight tensors, and each output is rounded once
    from f32, as two ``grouped_matmul`` calls would give.

    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return grouped_matmul_pair_plain(x, w_a, w_b, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, (w_a, w_b), group_sizes)
    out_a, out_b = _launch(x, w_a, w_b, group_sizes)
    if x.shape[0]:
        grouped_matmul_pair.launches += 1
    return out_a, out_b


grouped_matmul_pair.launches = 0


def _rescale(acc: torch.Tensor, a_scale: torch.Tensor, w_scale: torch.Tensor, dtype) -> torch.Tensor:
    """The int8 branch's epilogue: the exact sums rounded to f32, times the
    row's scale, times the column's, rounded once to ``dtype``."""
    return ((acc.float() * a_scale[:, None]) * w_scale).to(dtype)


def grouped_matmul_q8_plain(
    xq: torch.Tensor,  # int8 [M, K] rows sorted by group
    a_scale: torch.Tensor,  # f32 [M]
    w: torch.Tensor,  # int8 [G, N, K] (K-major)
    w_scale: torch.Tensor,  # f32 [G, N]
    group_sizes: torch.Tensor,  # [G] int, sums to M
    dtype: torch.dtype,
) -> torch.Tensor:  # [M, N] in dtype
    """Plain PyTorch version of the int8 branch: one masked f64 product a
    group (exact: the sums are integers below 2^31), then the epilogue."""
    M = xq.shape[0]
    G, N, _ = w.shape
    gid = _group_ids(group_sizes, M, xq.device)
    xd = xq.double()
    acc = torch.zeros((M, N), dtype=torch.float64, device=xq.device)
    for g in range(G):
        acc = torch.where((gid == g)[:, None], xd @ w[g].double().T, acc)
    return _rescale(acc, a_scale, w_scale[gid.clamp(max=G - 1)], dtype)


def grouped_matmul_q8_pair_plain(xq, a_scale, w_a, s_a, w_b, s_b, group_sizes, dtype):
    """Plain PyTorch version of the int8 pair: two ``grouped_matmul_q8_plain``."""
    return (grouped_matmul_q8_plain(xq, a_scale, w_a, s_a, group_sizes, dtype),
            grouped_matmul_q8_plain(xq, a_scale, w_b, s_b, group_sizes, dtype))


def matmul_q8_plain(xq, a_scale, w, w_scale, dtype):
    """Plain PyTorch version of the dense int8 product (w int8 [N, K],
    K-major; w_scale f32 [N])."""
    return _rescale(xq.double() @ w.double().T, a_scale, w_scale, dtype)


def _check_q8(xq, a_scale, ws, scales, group_sizes, dtype):
    """Raise unless the int8 branch takes xq against each weight tensor in
    ``ws`` (K-major ``[G, N, K]``, all of one shape) with its ``scales``
    (``[G, N]``). A ``[G, K, N]`` weight (JAX's layout) is refused only
    where K != N: a square one cannot be told apart by its shape, and
    gives ``x @ w^T``. So the port transposes int8 leaves only where they
    enter it (``params_from_jax``, the loader, the quantizers), never
    here."""
    w = ws[0]
    if xq.dim() != 2 or w.dim() != 3 or w.shape[2] != xq.shape[1]:
        raise ValueError(f"xq {tuple(xq.shape)} and w {tuple(w.shape)} do not fit [M, K] x "
                         "[G, N, K]: int8 weights are K-major")
    G, N, K = w.shape
    if group_sizes is None:
        if G != 1:
            raise ValueError(f"a product without group sizes takes one group, got {G}")
    else:
        if group_sizes.shape != (G,) or group_sizes.dtype != torch.int32:
            raise ValueError(f"group_sizes must be int32 [G] = [{G}], got {group_sizes.dtype} "
                             f"{tuple(group_sizes.shape)}")
        if G > _MAX_GROUPS:
            raise ValueError(f"the kernel takes at most {_MAX_GROUPS} groups, got {G}")
    if K % 16 or N % 16 or K > _MAX_K_S8:
        raise ValueError(f"the int8 branch takes K and N multiples of 16 and K <= {_MAX_K_S8}; "
                         f"got K={K}, N={N}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"output dtype {dtype} must be a float dtype the kernel takes")
    if xq.dtype != torch.int8 or a_scale.dtype != torch.float32 or a_scale.shape != (xq.shape[0],):
        raise ValueError("xq must be int8 [M, K] with a_scale f32 [M]")
    named = [("xq", xq), ("a_scale", a_scale), *(("w", t) for t in ws), *(("w_scale", t) for t in scales)]
    if group_sizes is not None:
        named.append(("group_sizes", group_sizes))
    for name, t in named:
        if t.device != xq.device:
            raise ValueError(f"{name} is on {t.device}, xq on {xq.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for t in (xq, *ws):  # read by TMA
        if t.data_ptr() % 16:
            raise ValueError("xq and w must be 16-byte aligned")
    for t, sc in zip(ws, scales):
        if t.dtype != torch.int8 or t.shape != w.shape:
            raise ValueError(f"weights must be int8 {tuple(w.shape)}, got {t.dtype} {tuple(t.shape)}")
        if sc.dtype != torch.float32 or sc.shape != (G, N):
            raise ValueError(f"weight scales must be f32 [{G}, {N}], got {sc.dtype} {tuple(sc.shape)}")


# int8 weight leaves are K-major ([.., N, K]); kernel_ab reads this to feed
# each checkout its own layout.
Q8_K_MAJOR = True
_S8_SLICE = 128  # K bytes a stage of the int8 branch
# Row tiles of the swap-AB form: the s8 wgmma N's up to 64.
Q8_SWAP_ROWS = (8, 16, 24, 32, 48, 64)
# q8_plan's cost model, in seconds, fitted to a sweep of every column tile
# at the models' decode and prefill shapes on an H100 SXM (700 W): swap-AB
# products streamed their weights at 2.0-2.9 TB/s however many SMs took
# part (32 to 132), one SM at up to about 100 GB/s. Prefill: the int8
# tensor-core rate, 1,979 TOP/s over the SMs.
_STREAM_BYTES_PER_S = 2.5e12
_SM_BYTES_PER_S = 100e9
_INT8_OPS_PER_S = 1979e12


class Q8Plan(NamedTuple):
    """The int8 branch's form: ``swap`` (decode: the weight tile on wgmma's
    64-row side, ``rows`` on its N side) or prefill (128-row tiles of x);
    ``cols`` output columns an item."""

    swap: bool
    rows: int
    cols: int


@functools.lru_cache(maxsize=4096)  # a pure function called once a product: keep its host cost off
def q8_plan(M: int, G: int, N: int, K: int, sms: int, pair: bool = False) -> Q8Plan:
    """The int8 branch's form and tiles from the shapes alone (the group
    sizes stay on the device). Groups average ``ceil(M / G)`` rows: up to
    64, swap-AB, its row tile the s8 wgmma N at or above the rows (a dense
    product's M; grouped, twice the average, so that most groups take one
    tile); above, the prefill form's 128-row tiles. The column tile (128
    or 64 swap-AB, 256 or 128 prefill) minimises a modelled time: items
    run in waves of ``sms`` blocks; a swap-AB product takes the longer of
    its weights at the card's rate and one SM's items at one SM's rate,
    plus a fifth of the latter (more, smaller items spread the stream); at
    prefill each SM's tensor cores do its items' operations (128-column
    tiles at 0.9 of the rate: they read more shared memory an operation),
    or streams its weights as swap-AB does, whichever takes longer. Ties
    go to the wider tile."""
    avg = -(-M // G)
    slices = -(-K // _S8_SLICE)
    swap = avg <= 64
    if swap:
        want = M if G == 1 else min(64, 2 * avg)
        rows = next(r for r in Q8_SWAP_ROWS if r >= want)
        tiles = (128, 64)
    else:
        rows, tiles = 128, (256, 128)
    row_tiles = -(-M // rows) if G == 1 else max(-(-M // rows), min(G, M))
    weights = row_tiles * (2 if pair else 1) * N * K  # bytes streamed (TMA reads no padding)
    best = None
    for cols in tiles:
        items = row_tiles * -(-N // cols) * (2 if pair else 1)
        waves = -(-items // sms)
        item = slices * _S8_SLICE * cols  # weight bytes an item streams
        per_sm = waves * item / _SM_BYTES_PER_S
        t = max(weights / _STREAM_BYTES_PER_S, per_sm) + 0.2 * per_sm
        if not swap:
            t = max(t, waves * 2 * rows * item / (_INT8_OPS_PER_S / sms * (1.0 if cols == 256 else 0.9)))
        if best is None or t < best[0]:
            best = (t, Q8Plan(swap, rows, cols))
    return best[1]


def _launch_q8(xq, a_scale, w_a, s_a, w_b, s_b, group_sizes, dtype):
    M = xq.shape[0]
    G, N, K = w_a.shape
    out_a = torch.empty((M, N), dtype=dtype, device=xq.device)
    out_b = None if w_b is None else torch.empty_like(out_a)
    if M == 0:
        return out_a, out_b
    sms = torch.cuda.get_device_properties(xq.device).multi_processor_count
    plan = q8_plan(M, G, N, K, sms, w_b is not None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _kernel_s8()(
        out_a.data_ptr(), ptr(out_b), xq.data_ptr(), a_scale.data_ptr(), w_a.data_ptr(),
        s_a.data_ptr(), ptr(w_b), ptr(s_b), ptr(group_sizes), M, K, N, G,
        _DTYPE_CODES[dtype], int(plan.swap), plan.rows, plan.cols,
        torch.cuda.current_stream(xq.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"grouped_gemm_s8 launch failed: CUDA error {err}")
    return out_a, out_b


def matmul_q8(
    xq: torch.Tensor,  # int8 [M, K]
    a_scale: torch.Tensor,  # f32 [M]
    w: torch.Tensor,  # int8 [N, K] (K-major)
    w_scale: torch.Tensor,  # f32 [N]
    dtype: torch.dtype,
) -> torch.Tensor:  # [M, N] in dtype
    """A dense int8 product: the int8 branch with one group of M rows.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if xq.device.type == "cpu":
        return matmul_q8_plain(xq, a_scale, w, w_scale, dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    if w.dim() != 2 or w_scale.dim() != 1:
        raise ValueError(f"w must be [N, K] with w_scale [N]; got {tuple(w.shape)}, {tuple(w_scale.shape)}")
    w3, s2 = w[None], w_scale[None]
    _check_q8(xq, a_scale, (w3,), (s2,), None, dtype)
    out, _ = _launch_q8(xq, a_scale, w3, s2, None, None, None, dtype)
    if xq.shape[0]:
        matmul_q8.launches += 1
    return out


matmul_q8.launches = 0


def grouped_matmul_q8(
    xq: torch.Tensor,  # int8 [M, K] rows sorted by group
    a_scale: torch.Tensor,  # f32 [M]
    w: torch.Tensor,  # int8 [G, N, K] (K-major)
    w_scale: torch.Tensor,  # f32 [G, N]
    group_sizes: torch.Tensor,  # [G] int32 on the device
    dtype: torch.dtype,
) -> torch.Tensor:  # [M, N] in dtype
    """``out[r] = (f32(xq[r] @ w[g(r)]) * a_scale[r]) * w_scale[g(r)]`` in
    ``dtype``, the group sizes read on the device. CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if xq.device.type == "cpu":
        return grouped_matmul_q8_plain(xq, a_scale, w, w_scale, group_sizes, dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    _check_q8(xq, a_scale, (w,), (w_scale,), group_sizes, dtype)
    out, _ = _launch_q8(xq, a_scale, w, w_scale, None, None, group_sizes, dtype)
    if xq.shape[0]:
        grouped_matmul_q8.launches += 1
    return out


grouped_matmul_q8.launches = 0


def grouped_matmul_q8_pair(xq, a_scale, w_a, s_a, w_b, s_b, group_sizes, dtype):
    """The int8 branch against two weight tensors of one shape (gate and
    up) in one launch; returns the two outputs. CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if xq.device.type == "cpu":
        return grouped_matmul_q8_pair_plain(xq, a_scale, w_a, s_a, w_b, s_b, group_sizes, dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    _check_q8(xq, a_scale, (w_a, w_b), (s_a, s_b), group_sizes, dtype)
    out = _launch_q8(xq, a_scale, w_a, s_a, w_b, s_b, group_sizes, dtype)
    if xq.shape[0]:
        grouped_matmul_q8_pair.launches += 1
    return out


grouped_matmul_q8_pair.launches = 0


def expert_mlp_grouped(
    x_sorted,  # [M, H] rows sorted by expert; int8 experts: a quant.QRows of them
    group_sizes: torch.Tensor,  # [E] int32
    we_gate: torch.Tensor,  # [E, H, F] float, or int8 [E, F, H] (K-major) with scales
    we_up: torch.Tensor,  # like we_gate
    we_down: torch.Tensor,  # [E, F, H] float, or int8 [E, H, F]
    scales: tuple | None = None,  # int8 experts: (s_gate [E, F], s_up [E, F], s_down [E, H])
    biases: tuple | None = None,  # gpt-oss: (b_gate [E, F], b_up [E, F], b_down [E, H])
    cfg=None,  # ModelConfig naming the GLU; None = SwiGLU
    expert_ids: torch.Tensor | None = None,  # [M] expert of each sorted row
) -> torch.Tensor:  # [M, H]
    """The routed rows' expert MLP: gate and up in one pair call, the GLU,
    down in a second call; each row's expert biases added after its
    products (``expert_ids`` says whose they are; required with
    ``biases``). With ``scales`` the experts are int8 and ``x_sorted`` is a
    ``quant.QRows``: the rows quantized once for the pair (JAX quantizes
    them once a product, to the same bits); ``quant.glu_quant`` adds the
    gate and up biases, runs the GLU and quantizes its output for down in
    one launch."""
    from llmd_tpu_torch.models.moe import expert_glu, glu_kind
    from llmd_tpu_torch.ops import quant

    if scales is None:
        gate, up = grouped_matmul_pair(x_sorted, we_gate, we_up, group_sizes)
        if biases is not None:
            gate = gate + biases[0][expert_ids]
            up = up + biases[1][expert_ids]
        act = expert_glu(gate, up, cfg).to(x_sorted.dtype).contiguous()
        out = grouped_matmul(act, we_down, group_sizes)
    else:
        xq, a_scale, dtype = x_sorted
        gate, up = grouped_matmul_q8_pair(xq, a_scale, we_gate, scales[0], we_up, scales[1],
                                          group_sizes, dtype)
        aq, act_scale, _ = quant.glu_quant(gate, up, *glu_kind(cfg),
                                           None if biases is None else biases[:2], expert_ids)
        out = grouped_matmul_q8(aq, act_scale, we_down, scales[2], group_sizes, dtype)
    if biases is not None:
        out = out + biases[2][expert_ids].to(out.dtype)
    return out


def moe_apply_grouped(
    ht: torch.Tensor,  # [T, H]
    weights: torch.Tensor,  # [T, k] f32 combine weights
    ids: torch.Tensor,  # [T, k] expert ids
    we_gate: torch.Tensor,
    we_up: torch.Tensor,
    we_down: torch.Tensor,
    scales: tuple | None = None,
    biases: tuple | None = None,
    cfg=None,
    hq=None,  # int8 experts: ht's rows quantized (a quant.QRows)
) -> torch.Tensor:  # [T, H] f32
    """Route -> stable sort by expert -> grouped MLP -> weighted combine.
    A sorted row's expert is ``flat_ids[order]`` (JAX's ``repeat(arange(E),
    group_sizes)``, without the host read ``repeat_interleave`` makes).
    int8 experts gather ``hq``'s rows and scales (per-row quantization
    commutes with a row gather bit for bit, and int8 rows are half the
    bytes)."""
    T, H = ht.shape
    k = ids.shape[1]
    E = we_gate.shape[0]
    flat_ids = ids.reshape(-1).long()  # [T*k], slot t * k + j
    # Stable: equal expert ids keep token order, so the sorted layout and
    # the combine's summation order are deterministic.
    order = torch.argsort(flat_ids, stable=True)
    tok = order // k  # source token of each sorted row
    if scales is None:
        xs = ht[tok].contiguous()
    else:
        xs = hq._replace(xq=hq.xq[tok], scale=hq.scale[tok])
    group_sizes = torch.zeros(E, dtype=torch.int32, device=ht.device).scatter_add_(
        0, flat_ids, torch.ones_like(flat_ids, dtype=torch.int32)
    )
    ys = expert_mlp_grouped(
        xs, group_sizes, we_gate, we_up, we_down, scales=scales, biases=biases, cfg=cfg,
        expert_ids=flat_ids[order] if biases is not None else None,
    )
    contrib = ys.float() * weights.reshape(-1)[order][:, None]
    # Each token's k sorted positions, ascending: JAX's scatter-add adds
    # the updates to a token in that order, starting from zero.
    sorted_pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device)
    )
    pos = torch.sort(sorted_pos.reshape(T, k), dim=1).values
    out = torch.zeros((T, H), dtype=torch.float32, device=ht.device)
    for j in range(k):
        out = out + contrib[pos[:, j]]
    return out
