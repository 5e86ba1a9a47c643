"""KV writes into the paged pool (in place): the flat step's and decode's.

``write_kv_pages_flat_full`` launches the CUDA kernel
``csrc/flat_kv_write.cu``, which replaces the TPU kernel
``llmd_tpu/ops/kv_write.py:_flat_write_kernel``. The TPU kernel lands the
step's tokens through run-addressed page read-modify-writes because Mosaic
cannot DMA one (page, slot) row; the port's kernel stores each token at
(phys page, slot) directly, so it takes the per-token addressing
(``page_table``, ``rows``, ``positions``) and no run plan. It is bound by
bytes: one read of k/v and one write of the same bytes into the pool.

``write_kv_pages_decode_full`` (and ``write_kv_pages_decode`` on a
single-layer pool) launches ``csrc/decode_kv_write.cu``, which replaces the
TPU kernel ``llmd_tpu/ops/kv_write.py:_write_kernel``: one token per row of
the decode batch, ``kv_new[b]`` stored at ``cache[layer, phys[b], :,
offset[b], :]``, rows with ``valid[b] == 0`` skipped. The TPU kernel reads,
patches and rewrites the whole page because it cannot store one row; the
port's kernel stores the row. It is bound by bytes (``B * K * 2D`` values in
and out), which at a decode batch is less than a microsecond: its time is
its launch.

``write_kv_pages_flat_plain`` and ``write_kv_pages_decode_plain`` are the
plain PyTorch versions; the wrappers take them for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from llmd_tpu_torch.ops import _build

_lib = None
_decode_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("flat_kv_write")
        lib.flat_kv_write.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p
        ]
        lib.flat_kv_write.restype = ctypes.c_int
        _lib = lib
    return _lib.flat_kv_write


def _decode_kernel():
    global _decode_lib
    if _decode_lib is None:
        lib = _build.load("decode_kv_write")
        lib.decode_kv_write.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        lib.decode_kv_write.restype = ctypes.c_int
        _decode_lib = lib
    return _decode_lib.decode_kv_write


def write_kv_pages_flat_plain(
    kv_cache: torch.Tensor,  # [L, num_pages, K, page, 2D]
    layer: int,
    k: torch.Tensor,  # [T, 1, K, D]
    v: torch.Tensor,  # [T, 1, K, D]
    page_table: torch.Tensor,  # [R, max_pages] i32
    rows: torch.Tensor,  # [T] i32 token -> row
    positions: torch.Tensor,  # [T] i32
    total: int,  # live tokens [0, total); the rest are pads
) -> torch.Tensor:
    """Plain PyTorch version: one indexed assignment of the live tokens."""
    page = kv_cache.shape[3]
    pos = positions[:total].long()
    phys = page_table[rows[:total].long(), pos // page].long()
    kv = torch.cat([k[:total, 0], v[:total, 0]], dim=-1).to(kv_cache.dtype)
    kv_cache[layer][phys, :, pos % page, :] = kv
    return kv_cache


def _check(kv_cache, k, v, page_table, rows, positions, total):
    L, P, K, page, D2 = kv_cache.shape
    T = k.shape[0]
    if k.shape != (T, 1, K, D2 // 2) or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit pool {tuple(kv_cache.shape)}")
    if rows.shape != (T,) or positions.shape != (T,) or not 0 <= total <= T:
        raise ValueError("rows/positions must be [T] and 0 <= total <= T")
    for name, t in (("kv_cache", kv_cache), ("k", k), ("v", v),
                    ("page_table", page_table), ("rows", rows),
                    ("positions", positions)):
        if t.device != kv_cache.device:
            raise ValueError(f"{name} is on {t.device}, the pool on {kv_cache.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("page_table", page_table), ("rows", rows), ("positions", positions)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if k.dtype != kv_cache.dtype or v.dtype != kv_cache.dtype:
        raise ValueError(f"k/v dtype {k.dtype} differs from the pool's {kv_cache.dtype}")
    row_bytes = (D2 // 2) * kv_cache.element_size()
    if row_bytes % 16:
        raise ValueError(f"head_dim bytes {row_bytes} must be a multiple of 16")
    for t in (kv_cache, k, v):
        if t.data_ptr() % 16:
            raise ValueError("pool and k/v must be 16-byte aligned")
    return row_bytes


def write_kv_pages_flat_full(
    kv_cache: torch.Tensor,
    layer: int,
    k: torch.Tensor,
    v: torch.Tensor,
    page_table: torch.Tensor,
    rows: torch.Tensor,
    positions: torch.Tensor,
    total: int,
) -> torch.Tensor:
    """Write the live tokens' K|V into ``kv_cache[layer]`` in place.

    CUDA tensors launch the kernel on the current stream; CPU tensors take
    the plain version. Returns ``kv_cache``."""
    if kv_cache.device.type == "cpu":
        return write_kv_pages_flat_plain(
            kv_cache, layer, k, v, page_table, rows, positions, total
        )
    if kv_cache.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_cache.device}")
    row_bytes = _check(kv_cache, k, v, page_table, rows, positions, total)
    L, P, K, page, _ = kv_cache.shape
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if total == 0:
        return kv_cache
    err = _kernel()(
        kv_cache.data_ptr(), k.data_ptr(), v.data_ptr(), page_table.data_ptr(),
        rows.data_ptr(), positions.data_ptr(), total, layer, P, K, page,
        page_table.shape[1], row_bytes,
        torch.cuda.current_stream(kv_cache.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flat_kv_write launch failed: CUDA error {err}")
    write_kv_pages_flat_full.launches += 1
    return kv_cache


write_kv_pages_flat_full.launches = 0


def write_kv_pages_decode_plain(
    kv_cache: torch.Tensor,  # [L, num_pages, K, page, 2D]
    kv_new: torch.Tensor,  # [B, K, 2D] (K then V halves on the last axis)
    layer: int,
    phys: torch.Tensor,  # [B] i32 physical page per row
    offset: torch.Tensor,  # [B] i32 slot in the page
    valid: torch.Tensor,  # [B] i32/bool; 0 skips the row
) -> torch.Tensor:
    """Plain PyTorch version: one masked ``index_put_`` of the live rows."""
    live = valid.bool()
    heads = torch.arange(kv_cache.shape[2], device=kv_cache.device)
    kv_cache[layer].index_put_(
        (phys[live].long()[:, None], heads[None, :], offset[live].long()[:, None]),
        kv_new[live].to(kv_cache.dtype),
    )
    return kv_cache


def _check_decode(kv_cache, kv_new, layer, phys, offset, valid):
    L, P, K, page, D2 = kv_cache.shape
    B = kv_new.shape[0]
    if kv_new.shape != (B, K, D2):
        raise ValueError(f"kv_new {tuple(kv_new.shape)} does not fit pool {tuple(kv_cache.shape)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if kv_new.dtype != kv_cache.dtype:
        raise ValueError(f"kv_new dtype {kv_new.dtype} differs from the pool's {kv_cache.dtype}")
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
    return row_bytes


def write_kv_pages_decode_full(
    kv_cache: torch.Tensor,
    kv_new: torch.Tensor,
    layer: int,
    phys: torch.Tensor,
    offset: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Store each live row's ``kv_new[b]`` at ``kv_cache[layer, phys[b], :,
    offset[b], :]`` in place; returns ``kv_cache`` (the same tensor, so a
    window's iterations keep writing one pool).

    CUDA tensors launch the kernel on the current stream; CPU tensors take
    the plain version. A pad row's ``phys`` may hold any value."""
    if kv_cache.device.type == "cpu":
        return write_kv_pages_decode_plain(kv_cache, kv_new, layer, phys, offset, valid)
    if kv_cache.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_cache.device}")
    row_bytes = _check_decode(kv_cache, kv_new, layer, phys, offset, valid)
    _, P, K, page, _ = kv_cache.shape
    B = kv_new.shape[0]
    if B == 0:
        return kv_cache
    err = _decode_kernel()(
        kv_cache.data_ptr(), kv_new.data_ptr(), phys.data_ptr(), offset.data_ptr(),
        valid.data_ptr(), B, layer, P, K, page, row_bytes,
        torch.cuda.current_stream(kv_cache.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"decode_kv_write launch failed: CUDA error {err}")
    write_kv_pages_decode_full.launches += 1
    return kv_cache


write_kv_pages_decode_full.launches = 0


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
