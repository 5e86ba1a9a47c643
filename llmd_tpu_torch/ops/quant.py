"""int8 weights (W8A8): per-output-channel int8 weights, per-token int8
activations, int8 x int8 -> int32 products rescaled in f32.

The port of ``llmd_tpu/ops/quant.py`` (its own copy: nothing is imported
from the JAX package). The scheme:

- weights: symmetric per-output-channel int8, ``w_q[..., o, i] =
  round(w[..., i, o] / s_w[..., o])`` with ``s_w = max(max |w|, 1e-30) /
  127`` reduced over the contraction axis. The int8 leaf is stored K-major
  (``[..., out, in]``, the HF layout; JAX keeps ``[..., in, out]``), the
  layout s8 ``wgmma`` reads; the scale lives beside it in the tree as
  ``<name>_scale`` (f32); ``QUANT_NAMES`` are the leaves that quantize.
- activations: symmetric per-row int8, quantized on the fly
  (``quantize_activations``), through the ``quantize_rows`` kernel on the
  card (``csrc/quantize_rows.cu``; JAX leaves it to XLA, which fuses it).
- products: ``qdot`` (a dense ``x @ W``) and ``grouped_matmul_q`` (the MoE
  experts) run the int8 branch of K6' (``ops/grouped_gemm.py``,
  ``grouped_matmul_q8``; a dense product is its one-group form), which
  accumulates in s32 and rescales ``(f32(acc) * a_scale) * w_scale`` in
  that order, rounded once to x's dtype, as JAX's ``qdot`` does.

Each kernel wrapper dispatches by its tensors' device: a CUDA tensor
launches the kernel (or the call raises), a CPU tensor runs the plain
version. There is no dequantize-then-matmul path: ``dequantize`` exists for
tests alone. The weight quantizers (``quantize_weight``,
``quantize_param_tree``, ``quantize_param_tree_host``) run once, at
initialisation and load time, in plain PyTorch or numpy; ``quantize_weight``
keeps JAX's layout, the trees and ``quantize_weight_into`` write the
K-major one.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from llmd_tpu_torch.ops import _build, grouped_gemm

_EPS = 1e-30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Parameter leaves that quantize: every [..., in, out] projection on the
# serving path. Left out on purpose, as in JAX: embed (a gather table),
# norms, router and its bias (small, and routing is sensitive to them),
# biases, sinks, and MLA's wkv_b (re-sliced into the absorbed W_uk / W_uv
# products, which per-channel scales do not survive).
QUANT_NAMES = frozenset({
    "wq", "wk", "wv", "wo",
    "w_gate", "w_up", "w_down",
    "ws_gate", "ws_up", "ws_down",
    "we_gate", "we_up", "we_down",
    "wq_a", "wq_b", "wkv_a",
    "lm_head",
})


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as an IEEE f32 divide on every device (PyTorch's CUDA
    divide by a Python scalar multiplies by its reciprocal instead)."""
    return a / torch.full_like(a, b)


def quantize_weight(w: torch.Tensor, contract_axis: int = -2) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: ``w`` is ``[..., I, O]`` with the
    contraction axis at ``contract_axis``; returns ``(q int8, same shape;
    scale f32, the shape without the contraction axis)``."""
    wf = w.float()
    scale = _div(wf.abs().amax(dim=contract_axis).clamp(min=_EPS), 127.0)
    q = torch.round(wf / scale.unsqueeze(contract_axis)).clamp(-127, 127)
    return q.to(torch.int8), scale


def quantize_weight_into(w: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                         block: int = 1 << 24) -> None:
    """``q, scale = quantize_weight(w)`` written K-major: ``w`` is
    ``[..., K, N]`` (any strides: the ``.T`` of an HF ``[out, in]`` tensor
    is read as it lies), ``q`` int8 ``[..., N, K]`` and ``scale`` f32
    ``[..., N]``, which may be views (a fused leaf's row block). The same
    bits, a block of columns at a time, so that the f32 temporaries stay
    about ``block`` elements whatever the leaf's size. Columns quantize
    apart."""
    if w.dim() > 2:
        for e in range(w.shape[0]):
            quantize_weight_into(w[e], q[e], scale[e], block)
        return
    cols = max(16, block // max(w.shape[0], 1))
    for c in range(0, w.shape[1], cols):
        qc, scale[c : c + cols] = quantize_weight(w[:, c : c + cols])
        q[c : c + cols] = qc.T


def quantize_param_tree(params: dict) -> dict:
    """Every ``QUANT_NAMES`` leaf quantized into a K-major int8 leaf,
    with its ``<name>_scale`` sibling beside it; other leaves as they
    are."""
    out: dict = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = quantize_param_tree(v)
        elif k in QUANT_NAMES:
            q, out[k + "_scale"] = quantize_weight(v)
            out[k] = q.mT.contiguous()
        else:
            out[k] = v
    return out


def quantize_param_tree_host(params: dict) -> dict:
    """``quantize_param_tree`` in numpy, for trees held on the host: the
    same bits, the same K-major leaves."""
    out: dict = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = quantize_param_tree_host(v)
        elif k in QUANT_NAMES:
            wf = np.asarray(v, dtype=np.float32)
            scale = np.maximum(np.max(np.abs(wf), axis=-2), np.float32(_EPS)) / np.float32(127.0)
            q = np.clip(np.round(wf / np.expand_dims(scale, -2)), -127, 127).astype(np.int8)
            out[k] = np.ascontiguousarray(np.swapaxes(q, -1, -2))
            out[k + "_scale"] = scale.astype(np.float32)
        else:
            out[k] = v
    return out


def dequantize(w_q: torch.Tensor, scale: torch.Tensor, contract_axis: int = -2,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The float weight back (tests only: no serving product calls it)."""
    return (w_q.float() * scale.unsqueeze(contract_axis)).to(dtype)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("quantize_rows")
        lib.quantize_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.quantize_rows.restype = ctypes.c_int
        _lib = lib
    return _lib.quantize_rows


def quantize_rows_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``quantize_rows``: x ``[M, K]`` -> (xq int8
    ``[M, K]``, a_scale f32 ``[M]``)."""
    xf = x.float()
    scale = _div(xf.abs().amax(dim=-1).clamp(min=_EPS), 127.0)
    xq = torch.round(xf / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return xq, scale


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 of x ``[M, K]`` (bf16, f16 or f32): (xq int8 ``[M, K]``,
    a_scale f32 ``[M]``), ``csrc/quantize_rows.cu`` on the card. The
    outputs come from ``torch.empty`` (in a CUDA graph's pool while one is
    captured). CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be [M, K] float32, bfloat16 or float16; got {tuple(x.shape)} {x.dtype}")
    M, K = x.shape
    if K % 16:
        raise ValueError(f"the kernel takes K a multiple of 16, got {K}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M,), dtype=torch.float32, device=x.device)
    if M == 0:
        return xq, scale
    err = _kernel()(xq.data_ptr(), scale.data_ptr(), x.data_ptr(), M, K, _DTYPE_CODES[x.dtype],
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"quantize_rows launch failed: CUDA error {err}")
    quantize_rows.launches += 1
    return xq, scale


quantize_rows.launches = 0


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) dynamic int8: (x_q int8, scale ``[..., 1]``
    f32)."""
    lead, K = x.shape[:-1], x.shape[-1]
    xq, scale = quantize_rows(x.reshape(-1, K).contiguous())
    return xq.reshape(*lead, K), scale.reshape(*lead, 1)


def qdot(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequantize(w_q, w_scale, -1).T`` without the dequantized weight: x
    ``[..., I]`` quantized per row, the int8 product (K6''s int8 branch as
    one group), ``(f32(acc) * a_scale) * w_scale`` in x's dtype. w_q is
    int8 ``[O, I]`` (K-major), w_scale f32 ``[O]``."""
    lead, K = x.shape[:-1], x.shape[-1]
    xq, a_scale = quantize_rows(x.reshape(-1, K).contiguous())
    out = grouped_gemm.matmul_q8(xq, a_scale, w_q, w_scale, x.dtype)
    return out.reshape(*lead, w_q.shape[-2])


def grouped_matmul_q(
    x: torch.Tensor,  # [M, K] rows sorted by group
    w_q: torch.Tensor,  # int8 [G, N, K] (K-major)
    w_scale: torch.Tensor,  # f32 [G, N]
    group_sizes: torch.Tensor,  # [G] int32, sums to M
) -> torch.Tensor:  # [M, N] in x's dtype
    """The quantized grouped product: x quantized per row, each group's
    int8 weight against its rows, rescaled by the row's scale and its
    group's column scales."""
    xq, a_scale = quantize_rows(x.contiguous())
    return grouped_gemm.grouped_matmul_q8(xq, a_scale, w_q, w_scale, group_sizes, x.dtype)
