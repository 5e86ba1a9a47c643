"""KV writes into the paged pool (in place): the flat step's and decode's.

``write_kv_pages_flat_full`` launches the CUDA kernel
``csrc/flat_kv_write.cu``, which replaces the TPU kernel
``llmd_tpu/ops/kv_write.py:_flat_write_kernel``. The TPU kernel lands the
step's tokens through run-addressed page read-modify-writes because Mosaic
cannot DMA one (page, slot) row; the port's kernel stores each token at
(phys page, slot) directly, so it takes the per-token addressing
(``page_table``, ``rows``, ``positions``) and no run plan. The live count
is a ``[1]`` int32 tensor on the pool's device that the kernel reads, not a
host integer, so that a step captured in a CUDA graph at one stream length
T writes exactly the live tokens of every replay. It is bound by bytes: one
read of k/v and one write of the same bytes into the pool.

``write_kv_pages_decode_full`` (and ``write_kv_pages_decode`` on a
single-layer pool) launches ``csrc/decode_kv_write.cu``, which replaces the
TPU kernel ``llmd_tpu/ops/kv_write.py:_write_kernel``: one token per row of
the decode batch, ``kv_new[b]`` stored at ``cache[layer, phys[b], :,
offset[b], :]``, rows with ``valid[b] == 0`` skipped. The TPU kernel reads,
patches and rewrites the whole page because it cannot store one row; the
port's kernel stores the row. It is bound by bytes (``B * K * 2D`` values in
and out), which at a decode batch is less than a microsecond: its time is
its launch.

Both take the int8 pool (``scales`` given: the pool's ``[L, P, K, page,
2]`` f32 scales, ``ops/quant_kv.py``): each kernel then quantizes the
float K|V rows itself and stores the int8 rows and their scale pairs in one
launch, where the JAX package quantizes, writes the data through the TPU
kernel and scatters the scales in three XLA steps. The stored bytes are
``quantize_kv_rows``'s, bit for bit.

Both kernels have a fused form (``csrc/rope_kv_write.cuh``):
``rope_write_kv_flat_full`` and ``rope_write_kv_decode_full`` take the
step's q, k and v as views of the q|k|v projection's output, add the
biases, apply the rotary embedding to q and k (``models/common.py:
apply_rope``'s arithmetic, bit for bit), return the rotated q and store the
rotated k|v as the store-only forms do, in one launch where the unfused
chain ran about 22 small kernels. Their launches count under the store-only
wrapper of the same kernel (``write_kv_pages_flat_full``,
``write_kv_pages_decode_full``) in branches of their own
(``write_branch``). The store-only forms stay: they are the TPU kernels'
own functions (``ops.write_kv_pages_full`` reaches the decode one at ``Q ==
1``).

The decode kernel has a latent form too (``csrc/latent_kv_write.cuh``):
``rope_write_latent_full`` takes an MLA layer's ``kv_a`` (wkv_a's output),
``kv_norm``'s weight, the rope tables, ``q_pe`` and the absorbed
``q_eff_nope``, and in one launch at any Q stores each live row's
``[kv_norm(c_kv), rope(k_pe), 0 ...]`` and returns q_eff ``[q_eff_nope,
rope(q_pe), 0 ...]``, where ``models/mla.py`` ran about 34 kernels a
layer. Its launches count under ``write_kv_pages_decode_full``, branch
``latent``; its plain version ``rope_write_latent_plain`` is that chain.

``write_kv_pages_flat_plain``, ``write_kv_pages_decode_plain``,
``rope_write_kv_flat_plain`` and ``rope_write_kv_decode_plain`` are the
plain PyTorch versions (for the int8 pool: ``quantize_kv_rows``, the plain
store and the plain scale scatter; the fused ones add the biases and call
``apply_rope`` first); the wrappers take them for CPU tensors only.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from llmd_tpu_torch.models.common import apply_rope, rms_norm
from llmd_tpu_torch.ops import _build
from llmd_tpu_torch.ops.paged_attention import scatter_kv_scales_flat
from llmd_tpu_torch.ops.quant_kv import quantize_kv_rows

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128, 256)

_lib = None
_decode_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("flat_kv_write")
        lib.flat_kv_write.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p
        ]
        lib.flat_kv_write.restype = ctypes.c_int
        lib.flat_kv_write_rope.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        )
        lib.flat_kv_write_rope.restype = ctypes.c_int
        _lib = lib
    return _lib


def _decode_kernel():
    global _decode_lib
    if _decode_lib is None:
        lib = _build.load("decode_kv_write")
        lib.decode_kv_write.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p
        ]
        lib.decode_kv_write.restype = ctypes.c_int
        lib.decode_kv_write_rope.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 8
            + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        )
        lib.decode_kv_write_rope.restype = ctypes.c_int
        lib.decode_kv_write_latent.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 5 + [ctypes.c_float]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        )
        lib.decode_kv_write_latent.restype = ctypes.c_int
        _decode_lib = lib
    return _decode_lib


def write_kv_pages_flat_plain(
    kv_cache: torch.Tensor,  # [L, num_pages, K, page, 2D]
    layer: int,
    k: torch.Tensor,  # [T, 1, K, D]
    v: torch.Tensor,  # [T, 1, K, D]
    page_table: torch.Tensor,  # [R, max_pages] i32
    rows: torch.Tensor,  # [T] i32 token -> row
    positions: torch.Tensor,  # [T] i32
    num_live: torch.Tensor,  # [1] i32: live tokens [0, num_live); the rest are pads
    scales: torch.Tensor | None = None,  # [L, num_pages, K, page, 2] (int8 pool)
) -> torch.Tensor:
    """Plain PyTorch version: one indexed assignment of the live tokens;
    for the int8 pool, ``quantize_kv_rows`` first and the scales' own
    scatter after. It reads the live count back to the host."""
    page = kv_cache.shape[3]
    total = int(num_live)
    pos = positions[:total].long()
    phys = page_table[rows[:total].long(), pos // page].long()
    if scales is not None:
        k, v, srow = quantize_kv_rows(k, v)
        scatter_kv_scales_flat(scales[layer], srow, page_table, rows, positions, total)
    kv = torch.cat([k[:total, 0], v[:total, 0]], dim=-1).to(kv_cache.dtype)
    kv_cache[layer][phys, :, pos % page, :] = kv
    return kv_cache


def _check_int8(kv_cache, scales, rows_in):
    """What the int8 path requires of the pool, its scales and the float
    rows ``rows_in`` it quantizes."""
    L, P, K, page, D2 = kv_cache.shape
    if kv_cache.dtype != torch.int8:
        raise ValueError(f"scales go with an int8 pool, not {kv_cache.dtype}")
    if scales.shape != (L, P, K, page, 2) or scales.dtype != torch.float32:
        raise ValueError(f"scales must be f32 [L, P, K, page, 2], got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if rows_in.dtype not in _DTYPE_CODES:
        raise ValueError(f"the int8 pool quantizes float rows, got {rows_in.dtype}")
    if D2 // 2 not in _HEAD_DIMS:
        raise ValueError(f"the int8 kernel takes head_dim in {_HEAD_DIMS}, got {D2 // 2}")
    if scales.device != kv_cache.device or not scales.is_contiguous():
        raise ValueError("scales must be contiguous and on the pool's device")
    if scales.data_ptr() % 8:
        raise ValueError("scales must be 8-byte aligned")


def write_branch(int8: bool, rope: bool = False, bias: bool = False) -> str:
    """The branch a KV-write launch counts under: ``plain`` or ``int8`` for
    the store-only form; ``rope``, ``rope+bias``, ``rope+int8`` or
    ``rope+bias+int8`` for the fused one (MLA's latent form counts as
    ``latent``)."""
    if not rope:
        return "int8" if int8 else "plain"
    return "+".join(["rope"] + ["bias"] * bias + ["int8"] * int8)


def _count(fn, scales, rope: bool = False, bias: bool = False) -> None:
    """One launch of ``fn``'s kernel, counted under its branch."""
    fn.launches += 1
    fn.branch_launches[write_branch(scales is not None, rope, bias)] += 1


def _check_flat_index(kv_cache, T, page_table, rows, positions, num_live):
    """What the flat step's addressing must be: [T] int32 rows and
    positions, a [1] int32 live count, an int32 table, all contiguous on
    the pool's device."""
    if rows.shape != (T,) or positions.shape != (T,) or num_live.shape != (1,):
        raise ValueError("rows/positions must be [T] and num_live [1]")
    for name, t in (("page_table", page_table), ("rows", rows), ("positions", positions),
                    ("num_live", num_live)):
        if t.device != kv_cache.device:
            raise ValueError(f"{name} is on {t.device}, the pool on {kv_cache.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")


def _check(kv_cache, k, v, page_table, rows, positions, num_live, scales):
    L, P, K, page, D2 = kv_cache.shape
    T = k.shape[0]
    if k.shape != (T, 1, K, D2 // 2) or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit pool {tuple(kv_cache.shape)}")
    _check_flat_index(kv_cache, T, page_table, rows, positions, num_live)
    for name, t in (("kv_cache", kv_cache), ("k", k), ("v", v)):
        if t.device != kv_cache.device:
            raise ValueError(f"{name} is on {t.device}, the pool on {kv_cache.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if scales is not None:
        _check_int8(kv_cache, scales, k)
        if v.dtype != k.dtype:
            raise ValueError(f"k {k.dtype} and v {v.dtype} must share a dtype")
    elif k.dtype != kv_cache.dtype or v.dtype != kv_cache.dtype:
        raise ValueError(f"k/v dtype {k.dtype} differs from the pool's {kv_cache.dtype}")
    elif k.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported pool dtype {k.dtype}")
    row_bytes = (D2 // 2) * kv_cache.element_size()
    if row_bytes % 16:
        raise ValueError(f"head_dim bytes {row_bytes} must be a multiple of 16")
    for t in (kv_cache, k, v):
        if t.data_ptr() % 16:
            raise ValueError("pool and k/v must be 16-byte aligned")


def write_kv_pages_flat_full(
    kv_cache: torch.Tensor,
    layer: int,
    k: torch.Tensor,
    v: torch.Tensor,
    page_table: torch.Tensor,
    rows: torch.Tensor,
    positions: torch.Tensor,
    num_live: torch.Tensor,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Write the live tokens' K|V (tokens ``[0, num_live)``, ``num_live``
    a ``[1]`` int32 tensor on the pool's device) into ``kv_cache[layer]``
    in place; with ``scales`` (an int8 pool), quantize them and store their
    scales too.

    CUDA tensors launch the kernel on the current stream; CPU tensors take
    the plain version. Returns ``kv_cache``."""
    if kv_cache.device.type == "cpu":
        return write_kv_pages_flat_plain(
            kv_cache, layer, k, v, page_table, rows, positions, num_live, scales
        )
    if kv_cache.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_cache.device}")
    _check(kv_cache, k, v, page_table, rows, positions, num_live, scales)
    L, P, K, page, D2 = kv_cache.shape
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    T = k.shape[0]
    if T == 0:
        return kv_cache
    stream = torch.cuda.current_stream(kv_cache.device).cuda_stream
    err = _kernel().flat_kv_write(
        kv_cache.data_ptr(), None if scales is None else scales.data_ptr(), k.data_ptr(),
        v.data_ptr(), page_table.data_ptr(), rows.data_ptr(), positions.data_ptr(),
        num_live.data_ptr(), T, layer, P, K, page, page_table.shape[1], D2 // 2,
        _DTYPE_CODES[k.dtype], stream,
    )
    if err:
        raise RuntimeError(f"flat_kv_write launch failed: CUDA error {err}")
    _count(write_kv_pages_flat_full, scales)
    return kv_cache


write_kv_pages_flat_full.launches = 0
write_kv_pages_flat_full.branch_launches = collections.Counter()


def write_kv_pages_decode_plain(
    kv_cache: torch.Tensor,  # [L, num_pages, K, page, 2D]
    kv_new: torch.Tensor,  # [B, K, 2D] (K then V halves on the last axis)
    layer: int,
    phys: torch.Tensor,  # [B] i32 physical page per row
    offset: torch.Tensor,  # [B] i32 slot in the page
    valid: torch.Tensor,  # [B] i32/bool; 0 skips the row
    scales: torch.Tensor | None = None,  # [L, num_pages, K, page, 2] (int8 pool)
) -> torch.Tensor:
    """Plain PyTorch version: one masked ``index_put_`` of the live rows;
    for the int8 pool, ``quantize_kv_rows`` first and a second
    ``index_put_`` of the rows' scale pairs."""
    live = valid.bool()
    heads = torch.arange(kv_cache.shape[2], device=kv_cache.device)
    idx = (phys[live].long()[:, None], heads[None, :], offset[live].long()[:, None])
    kv_new = kv_new[live]
    if scales is not None:
        D = kv_new.shape[-1] // 2
        k8, v8, srow = quantize_kv_rows(kv_new[..., :D], kv_new[..., D:])
        kv_new = torch.cat([k8, v8], dim=-1)
        scales[layer].index_put_(idx, srow)
    kv_cache[layer].index_put_(idx, kv_new.to(kv_cache.dtype))
    return kv_cache


def _check_decode_index(kv_cache, B, layer, phys, offset, valid):
    """What a decode batch's addressing must be: [B] int32 phys, offset
    and valid, contiguous on the pool's device, and a layer of the pool."""
    if not 0 <= layer < kv_cache.shape[0]:
        raise ValueError(f"layer {layer} out of range [0, {kv_cache.shape[0]})")
    for name, t in (("phys", phys), ("offset", offset), ("valid", valid)):
        if t.shape != (B,):
            raise ValueError(f"{name} must be [B] = [{B}], got {tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if t.device != kv_cache.device:
            raise ValueError(f"{name} is on {t.device}, the pool on {kv_cache.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_decode(kv_cache, kv_new, layer, phys, offset, valid, scales):
    L, P, K, page, D2 = kv_cache.shape
    B = kv_new.shape[0]
    if kv_new.shape != (B, K, D2):
        raise ValueError(f"kv_new {tuple(kv_new.shape)} does not fit pool {tuple(kv_cache.shape)}")
    _check_decode_index(kv_cache, B, layer, phys, offset, valid)
    if scales is not None:
        _check_int8(kv_cache, scales, kv_new)
    elif kv_new.dtype != kv_cache.dtype:
        raise ValueError(f"kv_new dtype {kv_new.dtype} differs from the pool's {kv_cache.dtype}")
    elif kv_new.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported pool dtype {kv_new.dtype}")
    for name, t in (("kv_cache", kv_cache), ("kv_new", kv_new)):
        if t.device != kv_cache.device:
            raise ValueError(f"{name} is on {t.device}, the pool on {kv_cache.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    row_bytes = D2 * kv_cache.element_size()
    if row_bytes % 16:
        raise ValueError(f"K|V row bytes {row_bytes} must be a multiple of 16")
    if kv_cache.data_ptr() % 16 or kv_new.data_ptr() % 16:
        raise ValueError("pool and kv_new must be 16-byte aligned")


def write_kv_pages_decode_full(
    kv_cache: torch.Tensor,
    kv_new: torch.Tensor,
    layer: int,
    phys: torch.Tensor,
    offset: torch.Tensor,
    valid: torch.Tensor,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Store each live row's ``kv_new[b]`` at ``kv_cache[layer, phys[b], :,
    offset[b], :]`` in place; returns ``kv_cache`` (the same tensor, so a
    window's iterations keep writing one pool). With ``scales`` (an int8
    pool) the float rows are quantized and their scale pairs stored.

    CUDA tensors launch the kernel on the current stream; CPU tensors take
    the plain version. A pad row's ``phys`` may hold any value."""
    if kv_cache.device.type == "cpu":
        return write_kv_pages_decode_plain(
            kv_cache, kv_new, layer, phys, offset, valid, scales
        )
    if kv_cache.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_cache.device}")
    _check_decode(kv_cache, kv_new, layer, phys, offset, valid, scales)
    _, P, K, page, D2 = kv_cache.shape
    B = kv_new.shape[0]
    if B == 0:
        return kv_cache
    stream = torch.cuda.current_stream(kv_cache.device).cuda_stream
    err = _decode_kernel().decode_kv_write(
        kv_cache.data_ptr(), None if scales is None else scales.data_ptr(),
        kv_new.data_ptr(), phys.data_ptr(), offset.data_ptr(), valid.data_ptr(), B, layer,
        P, K, page, D2 // 2, _DTYPE_CODES[kv_new.dtype], stream,
    )
    if err:
        raise RuntimeError(f"decode_kv_write launch failed: CUDA error {err}")
    _count(write_kv_pages_decode_full, scales)
    return kv_cache


write_kv_pages_decode_full.launches = 0
write_kv_pages_decode_full.branch_launches = collections.Counter()


def write_kv_pages_decode(
    kv_cache: torch.Tensor,  # [num_pages, K, page, 2D]: one layer's pool
    kv_new: torch.Tensor,
    phys: torch.Tensor,
    offset: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """The single-layer entry: the same kernel on the ``[1, ...]`` view.
    It keeps the JAX package's name for callers that hold one layer's
    pool; the model's forward calls the ``_full`` entry."""
    write_kv_pages_decode_full(kv_cache[None], kv_new, 0, phys, offset, valid)
    return kv_cache


# --------------------------------------------------------------------- #
# The fused form: q|k|v bias, rotary embedding and the store in one launch.


def add_qkv_bias(q, k, v, bias):
    """``q``, ``k``, ``v`` ([..., heads, D]) plus their biases (``bias`` =
    (bq [Nq D], bk [K D], bv [K D]), or None), each sum in the tensors'
    dtype, as the model adds them to the projection's output."""
    if bias is None:
        return q, k, v
    return tuple(x + b.view(x.shape[-2:]) for x, b in zip((q, k, v), bias))


def _rope_plain(q, k, v, cos, sin, bias):
    """The fused kernels' arithmetic in plain PyTorch: the biases, then
    ``apply_rope`` on q and k with the [N, D/2] tables."""
    q, k, v = add_qkv_bias(q, k, v, bias)
    c, s = cos[:, None], sin[:, None]
    return apply_rope(q[:, None], c, s)[:, 0], apply_rope(k[:, None], c, s)[:, 0], v


def _heads_contiguous_rows(name: str, t: torch.Tensor, shape: tuple) -> int:
    """The row stride (in elements) of ``t`` [N, heads, D], whose rows must
    each be a contiguous [heads, D] block at a 16-byte aligned address."""
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} {tuple(t.shape)} must be {shape}")
    if t.shape[0] and not t[0].is_contiguous():
        raise ValueError(f"{name}'s rows must each be a contiguous [heads, D] block")
    stride = t.stride(0) if t.shape[0] > 1 else 0
    if (stride * t.element_size()) % 16 or t.data_ptr() % 16:
        raise ValueError(f"{name}'s rows must be 16-byte aligned")
    return stride


def _check_rope(kv_cache, q, k, v, cos, sin, bias, scales) -> tuple[int, int, int]:
    """What the fused form requires of q, k, v, the tables, the biases and
    the pool; returns the row strides of q, k and v."""
    L, P, K, page, D2 = kv_cache.shape
    D = D2 // 2
    if q.dim() != 3 or q.shape[2] != D:
        raise ValueError(f"q {tuple(q.shape)} must be [N, Nq, {D}]")
    N, Nq = q.shape[:2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"the fused write takes head_dim in {_HEAD_DIMS}, got {D}")
    dt = q.dtype
    if dt not in _DTYPE_CODES or k.dtype != dt or v.dtype != dt:
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype} must be one float dtype")
    if scales is not None:
        _check_int8(kv_cache, scales, q)
    elif kv_cache.dtype != dt:
        raise ValueError(f"q/k/v dtype {dt} differs from the pool's {kv_cache.dtype}")
    strides = tuple(_heads_contiguous_rows(name, t, shape) for name, t, shape in (
        ("q", q, (N, Nq, D)), ("k", k, (N, K, D)), ("v", v, (N, K, D))))
    for name, t in (("cos", cos), ("sin", sin)):
        if t.shape != (N, D // 2) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 [N, D/2] = [{N}, {D // 2}]")
    named = [("kv_cache", kv_cache), ("q", q), ("k", k), ("v", v), ("cos", cos), ("sin", sin)]
    if bias is not None:
        for name, b, width in zip(("bq", "bk", "bv"), bias, (Nq * D, K * D, K * D)):
            if b.shape != (width,) or b.dtype != dt or not b.is_contiguous() or b.data_ptr() % 16:
                raise ValueError(f"{name} must be contiguous, 16-byte aligned {dt} [{width}]")
            named.append((name, b))
    for name, t in named:
        if t.device != kv_cache.device:
            raise ValueError(f"{name} is on {t.device}, the pool on {kv_cache.device}")
    if kv_cache.data_ptr() % 16:
        raise ValueError("the pool must be 16-byte aligned")
    return strides


def _bias_ptrs(bias) -> list:
    return [None] * 3 if bias is None else [b.data_ptr() for b in bias]


def rope_write_kv_flat_plain(
    kv_cache: torch.Tensor,  # [L, num_pages, K, page, 2D]
    layer: int,
    q: torch.Tensor,  # [T, Nq, D]
    k: torch.Tensor,  # [T, K, D]
    v: torch.Tensor,  # [T, K, D]
    cos: torch.Tensor,  # [T, D/2] f32
    sin: torch.Tensor,  # [T, D/2] f32
    page_table: torch.Tensor,
    rows: torch.Tensor,
    positions: torch.Tensor,
    num_live: torch.Tensor,
    bias: tuple | None = None,  # (bq [Nq D], bk [K D], bv [K D])
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the fused flat write: the biases,
    ``apply_rope`` on q and k, then ``write_kv_pages_flat_plain``. Returns
    the rotated q [T, Nq, D]."""
    q, k, v = _rope_plain(q, k, v, cos, sin, bias)
    write_kv_pages_flat_plain(
        kv_cache, layer, k[:, None], v[:, None], page_table, rows, positions, num_live, scales
    )
    return q


def rope_write_kv_flat_full(
    kv_cache: torch.Tensor,
    layer: int,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    page_table: torch.Tensor,
    rows: torch.Tensor,
    positions: torch.Tensor,
    num_live: torch.Tensor,
    bias: tuple | None = None,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """The flat step's bias, rotary embedding and KV write in one launch of
    K2's fused form: q [T, Nq, D], k and v [T, K, D] (any row stride; each
    row a contiguous [heads, D] block), cos/sin [T, D/2] f32. Stores the
    live tokens' (``[0, num_live)``) rotated k|v into ``kv_cache[layer]``
    in place (with ``scales``, an int8 pool: quantized, with their scales)
    and returns every token's rotated q, [T, Nq, D] contiguous.

    CUDA tensors launch the kernel on the current stream; CPU tensors take
    the plain version."""
    if kv_cache.device.type == "cpu":
        return rope_write_kv_flat_plain(
            kv_cache, layer, q, k, v, cos, sin, page_table, rows, positions, num_live,
            bias, scales,
        )
    if kv_cache.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_cache.device}")
    strides = _check_rope(kv_cache, q, k, v, cos, sin, bias, scales)
    L, P, K, page, D2 = kv_cache.shape
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    T, Nq = q.shape[:2]
    _check_flat_index(kv_cache, T, page_table, rows, positions, num_live)
    q_out = torch.empty((T, Nq, D2 // 2), dtype=q.dtype, device=q.device)
    if T == 0:
        return q_out
    stream = torch.cuda.current_stream(kv_cache.device).cuda_stream
    err = _kernel().flat_kv_write_rope(
        kv_cache.data_ptr(), None if scales is None else scales.data_ptr(), q_out.data_ptr(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, *_bias_ptrs(bias),
        cos.data_ptr(), sin.data_ptr(), page_table.data_ptr(), rows.data_ptr(),
        positions.data_ptr(), num_live.data_ptr(), T, layer, P, Nq, K, page,
        page_table.shape[1], D2 // 2, _DTYPE_CODES[q.dtype], stream,
    )
    if err:
        raise RuntimeError(f"flat_kv_write_rope launch failed: CUDA error {err}")
    _count(write_kv_pages_flat_full, scales, rope=True, bias=bias is not None)
    return q_out


def rope_write_kv_decode_plain(
    kv_cache: torch.Tensor,  # [L, num_pages, K, page, 2D]
    layer: int,
    q: torch.Tensor,  # [B, Nq, D]
    k: torch.Tensor,  # [B, K, D]
    v: torch.Tensor,  # [B, K, D]
    cos: torch.Tensor,  # [B, D/2] f32
    sin: torch.Tensor,  # [B, D/2] f32
    phys: torch.Tensor,
    offset: torch.Tensor,
    valid: torch.Tensor,
    bias: tuple | None = None,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the fused decode write: the biases,
    ``apply_rope`` on q and k, then ``write_kv_pages_decode_plain`` of k|v.
    Returns the rotated q [B, Nq, D]."""
    q, k, v = _rope_plain(q, k, v, cos, sin, bias)
    write_kv_pages_decode_plain(
        kv_cache, torch.cat([k, v], dim=-1), layer, phys, offset, valid, scales
    )
    return q


def rope_write_kv_decode_full(
    kv_cache: torch.Tensor,
    layer: int,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    phys: torch.Tensor,
    offset: torch.Tensor,
    valid: torch.Tensor,
    bias: tuple | None = None,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """A decode batch's bias, rotary embedding and KV write in one launch
    of K4's fused form: q [B, Nq, D], k and v [B, K, D] (any row stride;
    each row a contiguous [heads, D] block), cos/sin [B, D/2] f32. Stores
    each live row's (``valid[b] != 0``) rotated k|v at ``kv_cache[layer,
    phys[b], :, offset[b], :]`` in place (with ``scales``, an int8 pool:
    quantized, with their scales) and returns every row's rotated q,
    [B, Nq, D] contiguous. A pad row's ``phys`` may hold any value.

    CUDA tensors launch the kernel on the current stream; CPU tensors take
    the plain version."""
    if kv_cache.device.type == "cpu":
        return rope_write_kv_decode_plain(
            kv_cache, layer, q, k, v, cos, sin, phys, offset, valid, bias, scales
        )
    if kv_cache.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_cache.device}")
    strides = _check_rope(kv_cache, q, k, v, cos, sin, bias, scales)
    _, P, K, page, D2 = kv_cache.shape
    B, Nq = q.shape[:2]
    _check_decode_index(kv_cache, B, layer, phys, offset, valid)
    q_out = torch.empty((B, Nq, D2 // 2), dtype=q.dtype, device=q.device)
    if B == 0:
        return q_out
    stream = torch.cuda.current_stream(kv_cache.device).cuda_stream
    err = _decode_kernel().decode_kv_write_rope(
        kv_cache.data_ptr(), None if scales is None else scales.data_ptr(), q_out.data_ptr(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, *_bias_ptrs(bias),
        cos.data_ptr(), sin.data_ptr(), phys.data_ptr(), offset.data_ptr(), valid.data_ptr(),
        B, layer, P, Nq, K, page, D2 // 2, _DTYPE_CODES[q.dtype], stream,
    )
    if err:
        raise RuntimeError(f"decode_kv_write_rope launch failed: CUDA error {err}")
    _count(write_kv_pages_decode_full, scales, rope=True, bias=bias is not None)
    return q_out


# --------------------------------------------------------------------- #
# MLA's latent row: kv_norm, both ropes, the padding and the store in one
# launch (``csrc/latent_kv_write.cuh``), at decode and at prefill.


def rope_write_latent_plain(
    kv_cache: torch.Tensor,  # [L, num_pages, 1, page, Dl]
    layer: int,
    kv_a: torch.Tensor,  # [B, Q, rank + rope]: wkv_a's output
    kv_norm: torch.Tensor,  # [rank]
    eps: float,
    cos: torch.Tensor,  # [B, Q, rope/2] f32 (rope_tables)
    sin: torch.Tensor,
    q_pe: torch.Tensor,  # [B, Q, nh, rope]
    q_eff_nope: torch.Tensor,  # [B, Q, nh, rank]: the absorbed q_nope
    page_table: torch.Tensor,  # [B, max_pages]
    positions: torch.Tensor,  # [B, Q]
    valid: torch.Tensor,  # [B, Q] bool
    rstd: torch.Tensor | None = None,  # f32 [B Q]: gets each row's norm factor
) -> torch.Tensor:
    """Plain PyTorch version of ``rope_write_latent_full``: the chain
    ``models/mla.py:mla_write`` ran around the store before the fused form
    (``rms_norm`` of c_kv, ``apply_rope`` of k_pe and q_pe, the
    concatenations and pads), with the store-only form's plain version,
    which stores the live tokens and drops the pads
    (``write_kv_pages_decode_plain`` at every token's (page, slot)).
    Returns q_eff ``[B, Q, nh, Dl]``."""
    rank = q_eff_nope.shape[-1]
    rope = q_pe.shape[-1]
    Dl = kv_cache.shape[-1]
    xc = kv_a[..., :rank]
    c_kv = rms_norm(xc, kv_norm, eps)
    if rstd is not None:
        xf = xc.float()
        rstd.copy_(torch.rsqrt((xf * xf).mean(dim=-1) + eps).reshape(-1))
    k_pe = apply_rope(kv_a[..., None, rank:], cos, sin)[:, :, 0]  # one shared head
    latent = F.pad(torch.cat([c_kv, k_pe], dim=-1), (0, Dl - rank - rope))
    pos = positions.long()
    page = kv_cache.shape[3]
    phys = torch.gather(page_table.long(), 1, pos // page)
    write_kv_pages_decode_plain(kv_cache, latent.reshape(-1, 1, Dl), layer, phys.reshape(-1),
                                (pos % page).reshape(-1), valid.reshape(-1))
    q_pe = apply_rope(q_pe, cos, sin)
    return F.pad(torch.cat([q_eff_nope, q_pe], dim=-1), (0, Dl - rank - rope))


def _rows_view(name: str, t: torch.Tensor, shape: tuple, align: int) -> tuple[torch.Tensor, tuple]:
    """``t`` [B, Q, *tail] as a view of its N = B Q rows, [N, *tail], and
    the strides (elements) of the dims before its last, which must be
    contiguous; every start a multiple of ``align`` bytes."""
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} {tuple(t.shape)} must be {shape}")
    try:
        v = t.view(-1, *shape[2:])
    except RuntimeError as e:
        raise ValueError(f"{name}'s batch and query axes must merge into one row axis") from e
    if v.stride(-1) != 1:
        raise ValueError(f"{name}'s last axis must be contiguous")
    strides = tuple(v.stride(i) if v.shape[i] > 1 else 0 for i in range(v.dim() - 1))
    es = v.element_size()
    if v.data_ptr() % align or any(s * es % align for s in strides):
        raise ValueError(f"{name}'s rows (and heads) must start {align}-byte aligned")
    return v, strides


def _rope_vector(half: int, pad: int, es: int, q_pe: torch.Tensor) -> int:
    """Elements a rope and pad vector of the kernel: 8 (16 bytes of bf16 or
    f16) where they divide a rope half and the pad and align q_pe's heads,
    else 4 (the widths of tiny-mla, and f32); refuses what 4 does not
    divide."""
    for m in (8, 4):
        if m * es <= 16 and not (half % m or pad % m or q_pe.data_ptr() % (m * es)
                                 or any(s % m for s in q_pe.stride()[:-1])):
            return m
    raise ValueError(f"rope/2 {half}, the pad {pad} and q_pe's head offsets must be "
                     "multiples of 4 elements")


def _check_latent(kv_cache, layer, kv_a, kv_norm, cos, sin, q_pe, q_eff_nope, rstd):
    """What the fused latent write requires; returns (N-row views of kv_a,
    cos, sin, q_pe, q_eff_nope; their strides; the rope vector's
    elements)."""
    if kv_cache.dim() != 5 or kv_cache.shape[2] != 1:
        raise ValueError(f"the latent pool must be [L, pages, 1, page, Dl], got {tuple(kv_cache.shape)}")
    dt = kv_a.dtype
    if dt not in _DTYPE_CODES:
        raise ValueError(f"the latent write takes f32, bf16 or f16 rows, got {dt}")
    if kv_cache.dtype != dt:
        raise ValueError(f"the latent pool is {kv_cache.dtype}, its rows {dt} "
                         "(an int8 latent pool is not supported)")
    if not 0 <= layer < kv_cache.shape[0]:
        raise ValueError(f"layer {layer} out of range [0, {kv_cache.shape[0]})")
    B, Q = kv_a.shape[:2]
    nh, rank = q_eff_nope.shape[2:]
    rope = q_pe.shape[-1]
    Dl = kv_cache.shape[-1]
    es = kv_a.element_size()
    if rope % 2 or Dl < rank + rope:
        raise ValueError(f"rope {rope} must be even and rank + rope {rank + rope} <= Dl {Dl}")
    if (rank * es) % 16 or (Dl * es) % 16:
        raise ValueError(f"rank {rank} and Dl {Dl} must each be a multiple of 16 bytes")
    for name, t in (("q_pe", q_pe), ("q_eff_nope", q_eff_nope), ("kv_norm", kv_norm)):
        if t.dtype != dt:
            raise ValueError(f"{name} is {t.dtype}, kv_a {dt}")
    if kv_norm.shape != (rank,) or not kv_norm.is_contiguous() or kv_norm.data_ptr() % 16:
        raise ValueError(f"kv_norm must be a contiguous, 16-byte aligned [{rank}]")
    kv, (kv_stride,) = _rows_view("kv_a", kv_a, (B, Q, rank + rope), 16)
    qn, qn_strides = _rows_view("q_eff_nope", q_eff_nope, (B, Q, nh, rank), 16)
    qp, qp_strides = _rows_view("q_pe", q_pe, (B, Q, nh, rope), es)
    tables = []
    for name, t in (("cos", cos), ("sin", sin)):
        if t.shape != (B, Q, rope // 2) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 [B, Q, rope/2] = [{B}, {Q}, {rope // 2}]")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        tables.append(t.view(B * Q, rope // 2))
    if rstd is not None and (rstd.shape != (B * Q,) or rstd.dtype != torch.float32
                             or not rstd.is_contiguous()):
        raise ValueError(f"rstd must be contiguous f32 [B Q] = [{B * Q}]")
    for name, t in (("kv_a", kv_a), ("kv_norm", kv_norm), ("cos", cos), ("sin", sin),
                    ("q_pe", q_pe), ("q_eff_nope", q_eff_nope), ("rstd", rstd)):
        if t is not None and t.device != kv_cache.device:
            raise ValueError(f"{name} is on {t.device}, the pool on {kv_cache.device}")
    if kv_cache.data_ptr() % 16 or not kv_cache.is_contiguous():
        raise ValueError("the pool must be contiguous and 16-byte aligned")
    m = _rope_vector(rope // 2, Dl - rank - rope, es, qp)
    return (kv, *tables, qp, qn), (kv_stride, *qp_strides, *qn_strides), m


def _check_bucket_index(kv_cache, B, Q, page_table, positions, valid):
    """What a step's addressing must be: an int32 table [B,
    max_pages], int32 positions and bool valid [B, Q], contiguous on the
    pool's device."""
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be [B = {B}, max_pages], got {tuple(page_table.shape)}")
    for name, t, dtype, shape in (("page_table", page_table, torch.int32, page_table.shape),
                                  ("positions", positions, torch.int32, (B, Q)),
                                  ("valid", valid, torch.bool, (B, Q))):
        if t.shape != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != kv_cache.device:
            raise ValueError(f"{name} is on {t.device}, the pool on {kv_cache.device}")


def rope_write_latent_full(
    kv_cache: torch.Tensor,
    layer: int,
    kv_a: torch.Tensor,
    kv_norm: torch.Tensor,
    eps: float,
    cos: torch.Tensor,
    sin: torch.Tensor,
    q_pe: torch.Tensor,
    q_eff_nope: torch.Tensor,
    page_table: torch.Tensor,
    positions: torch.Tensor,
    valid: torch.Tensor,
    rstd: torch.Tensor | None = None,
) -> torch.Tensor:
    """MLA's latent write in one launch of K4''s latent form, for the
    step's ``N = B Q`` rows: stores each live row's ``[bf16(c_kv r) *
    kv_norm, rope(k_pe), 0 ...]`` (c_kv and k_pe the halves of ``kv_a``
    [B, Q, rank + rope], ``r`` the RMSNorm's factor) at its (page, slot) of
    ``kv_cache[layer]`` in place, and returns every row's q_eff [B, Q, nh,
    Dl] = ``[q_eff_nope, rope(q_pe), 0 ...]``, pad rows included. kv_a,
    q_pe and q_eff_nope may be views (each row's, or head's, last axis
    contiguous). The kernel computes each token's (page, slot) from
    ``page_table`` [B, max_pages], ``positions`` and ``valid`` [B, Q] at
    every Q; a pad row (valid False) stores nothing. ``rstd`` (f32 [B Q], checks of the arithmetic) gets the
    norm's factor of every row.

    CUDA tensors launch the kernel on the current stream (launches count
    under ``write_kv_pages_decode_full``, branch ``latent``); CPU tensors
    take the plain version."""
    if kv_cache.device.type == "cpu":
        return rope_write_latent_plain(
            kv_cache, layer, kv_a, kv_norm, eps, cos, sin, q_pe, q_eff_nope, page_table,
            positions, valid, rstd,
        )
    if kv_cache.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_cache.device}")
    views, strides, m = _check_latent(kv_cache, layer, kv_a, kv_norm, cos, sin, q_pe,
                                      q_eff_nope, rstd)
    kv, cos_n, sin_n, qp, qn = views
    L, P, _, page, Dl = kv_cache.shape
    B, Q = kv_a.shape[:2]
    nh, rank = q_eff_nope.shape[2:]
    _check_bucket_index(kv_cache, B, Q, page_table, positions, valid)
    q_eff = torch.empty((B, Q, nh, Dl), dtype=kv_a.dtype, device=kv_a.device)
    if B * Q == 0:
        return q_eff
    err = _decode_kernel().decode_kv_write_latent(
        kv_cache.data_ptr(), q_eff.data_ptr(), None if rstd is None else rstd.data_ptr(),
        kv.data_ptr(), kv_norm.data_ptr(), cos_n.data_ptr(), sin_n.data_ptr(), qp.data_ptr(),
        qn.data_ptr(), *strides, float(eps), page_table.data_ptr(), positions.data_ptr(),
        valid.data_ptr(), B * Q, Q, page_table.shape[1], layer, P, page, nh, rank,
        q_pe.shape[-1], Dl, m, _DTYPE_CODES[kv_a.dtype],
        torch.cuda.current_stream(kv_cache.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"decode_kv_write_latent launch failed: CUDA error {err}")
    write_kv_pages_decode_full.launches += 1
    write_kv_pages_decode_full.branch_launches["latent"] += 1
    return q_eff
