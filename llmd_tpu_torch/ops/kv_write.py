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

``write_kv_pages_flat_plain`` and ``write_kv_pages_decode_plain`` are the
plain PyTorch versions (for the int8 pool: ``quantize_kv_rows``, the plain
store and the plain scale scatter); the wrappers take them for CPU tensors
only.
"""

from __future__ import annotations

import collections
import ctypes

import torch

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


def _count(fn, scales) -> None:
    """One launch of ``fn``'s kernel, counted under its branch."""
    fn.launches += 1
    fn.branch_launches["plain" if scales is None else "int8"] += 1


def _check(kv_cache, k, v, page_table, rows, positions, num_live, scales):
    L, P, K, page, D2 = kv_cache.shape
    T = k.shape[0]
    if k.shape != (T, 1, K, D2 // 2) or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit pool {tuple(kv_cache.shape)}")
    if rows.shape != (T,) or positions.shape != (T,) or num_live.shape != (1,):
        raise ValueError("rows/positions must be [T] and num_live [1]")
    for name, t in (("kv_cache", kv_cache), ("k", k), ("v", v),
                    ("page_table", page_table), ("rows", rows),
                    ("positions", positions), ("num_live", num_live)):
        if t.device != kv_cache.device:
            raise ValueError(f"{name} is on {t.device}, the pool on {kv_cache.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("page_table", page_table), ("rows", rows), ("positions", positions),
                    ("num_live", num_live)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
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


def _check_decode(kv_cache, kv_new, layer, phys, offset, valid, scales):
    L, P, K, page, D2 = kv_cache.shape
    B = kv_new.shape[0]
    if kv_new.shape != (B, K, D2):
        raise ValueError(f"kv_new {tuple(kv_new.shape)} does not fit pool {tuple(kv_cache.shape)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if scales is not None:
        _check_int8(kv_cache, scales, kv_new)
    elif kv_new.dtype != kv_cache.dtype:
        raise ValueError(f"kv_new dtype {kv_new.dtype} differs from the pool's {kv_cache.dtype}")
    elif kv_new.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported pool dtype {kv_new.dtype}")
    for name, t in (("phys", phys), ("offset", offset), ("valid", valid)):
        if t.shape != (B,):
            raise ValueError(f"{name} must be [B] = [{B}], got {tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("kv_cache", kv_cache), ("kv_new", kv_new), ("phys", phys),
                    ("offset", offset), ("valid", valid)):
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
