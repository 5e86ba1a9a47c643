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
  Where the rows come out of a norm or a gated unit, the quantization is
  fused into the kernel that makes them (same source): ``add_rms_norm_quant``
  (the residual add, its bias, ``models.common.rms_norm`` and the
  quantization) and ``glu_quant`` (the gated unit, with the experts' biases
  by expert id, and the quantization). They return the rows as ``QRows``
  parts, which the int8 products read (``models.common.qpdot``): one
  quantization for every product that reads the same rows.
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
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

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


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("quantize_rows")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.quantize_rows.argtypes = [P] * 3 + [I] * 3 + [P]
        lib.add_rms_norm_quant.argtypes = [P] * 9 + [ctypes.c_float] + [I] * 3 + [P]
        lib.glu_quant.argtypes = ([P] * 5 + [ctypes.c_longlong] * 2 + [P] * 3 + [I, ctypes.c_float]
                                  + [I] * 3 + [P])
        for fn in (lib.quantize_rows, lib.add_rms_norm_quant, lib.glu_quant):
            fn.restype = I
        _lib = lib
    return _lib


class QRows(NamedTuple):
    """Rows already quantized for the int8 products that read them: int8
    ``[M, K]``, one f32 scale a row ``[M]``, and the float dtype those
    products write."""

    xq: torch.Tensor
    scale: torch.Tensor
    dtype: torch.dtype


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
    err = _library().quantize_rows(xq.data_ptr(), scale.data_ptr(), x.data_ptr(), M, K,
                                   _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"quantize_rows launch failed: CUDA error {err}")
    quantize_rows.launches += 1
    return xq, scale


quantize_rows.launches = 0


def _check_rows(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype) -> None:
    """A kernel input: ``shape`` and ``dtype``, on the card, 16-byte
    aligned with unit stride in its last dim (rows may be apart)."""
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name} must be {list(shape)} {dtype}; got {tuple(t.shape)} {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on the card, got {t.device}")
    if t.data_ptr() % 16 or t.stride(-1) != 1 or (t.dim() == 2 and (t.stride(0) * t.element_size()) % 16):
        raise ValueError(f"{name} must be 16-byte aligned with unit stride in its last dim")


def _check_width(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"rows must be [M, K] float32, bfloat16 or float16; got {tuple(x.shape)} {x.dtype}")
    if x.shape[1] % 16:
        raise ValueError(f"the kernel takes K a multiple of 16, got {x.shape[1]}")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def add_rms_norm_quant_plain(x, delta, bias, weight, eps: float, want_h: bool = False, rstd=None):
    """Plain PyTorch version of ``add_rms_norm_quant``: the residual add and
    its bias as the layers write them, ``models.common.rms_norm`` and
    ``quantize_rows_plain`` of its output."""
    from llmd_tpu_torch.models.common import rms_norm

    if delta is not None:
        x = x + (delta if bias is None else delta + bias)
    h = rms_norm(x, weight, eps)
    if rstd is not None:
        xf = x.float()
        rstd.copy_(torch.rsqrt((xf * xf).mean(dim=-1) + eps))
    xq, scale = quantize_rows_plain(h)
    return x, (h if want_h else None), xq, scale


def add_rms_norm_quant(
    x: torch.Tensor,  # [M, K] the residual stream
    delta: torch.Tensor | None,  # [M, K] a branch's output to add, or None: no add
    bias: torch.Tensor | None,  # [K] added to delta first (gpt-oss's bo), or None
    weight: torch.Tensor,  # [K] the norm's weight
    eps: float,
    want_h: bool = False,
    rstd: torch.Tensor | None = None,  # f32 [M]: filled with each row's rsqrt(mean(x_new^2) + eps)
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """The residual add, the RMSNorm and the per-row int8 of its output in
    one launch (``csrc/quantize_rows.cu``): ``x_new = x + (delta + bias)``
    (x itself without delta), ``h = rms_norm(x_new, weight, eps)``, and
    returns ``(x_new, h if want_h else None, xq int8 [M, K], a_scale f32
    [M])``; (xq, a_scale) are ``quantize_rows`` of h. Outputs come from
    ``torch.empty``; ``rstd``, where given (checks of the kernel's
    arithmetic), gets the norm's per-row factor. CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return add_rms_norm_quant_plain(x, delta, bias, weight, eps, want_h, rstd)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_width(x)
    M, K = x.shape
    _check_rows("x", x, (M, K), x.dtype)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if delta is not None:
        _check_rows("delta", delta, (M, K), x.dtype)
        if not delta.is_contiguous():
            raise ValueError("delta must be contiguous")
    elif bias is not None:
        raise ValueError("a bias needs a delta to add it to")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None:
            _check_rows(name, t, (K,), x.dtype)
    if rstd is not None:
        _check_rows("rstd", rstd, (M,), torch.float32)
    x_new = x if delta is None else torch.empty_like(x)
    h = torch.empty_like(x) if want_h else None
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M,), dtype=torch.float32, device=x.device)
    if M == 0:
        return x_new, h, xq, scale
    err = _library().add_rms_norm_quant(
        None if delta is None else x_new.data_ptr(), _ptr(h), xq.data_ptr(), scale.data_ptr(),
        _ptr(rstd), x.data_ptr(), _ptr(delta), _ptr(bias), weight.data_ptr(), float(eps), M, K,
        _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"add_rms_norm_quant launch failed: CUDA error {err}")
    add_rms_norm_quant.launches += 1
    return x_new, h, xq, scale


add_rms_norm_quant.launches = 0

GLU_KINDS = {"silu": 0, "swiglu_oss": 1}


# gpt-oss's 1.702 rounded to a 16-bit gate's dtype: the value JAX's weakly
# typed constant takes beside it (bf16 1.703125, f16 1.7021484375).
_OSS_ALPHA16 = {dt: float(torch.tensor(1.702, dtype=dt)) for dt in (torch.bfloat16, torch.float16)}


def glu(gate: torch.Tensor, up: torch.Tensor, kind: str = "silu", limit: float = 0.0) -> torch.Tensor:
    """The gated unit before a down projection. silu: silu(gate) * up.
    swiglu_oss (gpt-oss): gate clamped above at ``limit``, up clamped to
    [-limit, limit], glu = gate * sigmoid(1.702 * gate), out = (up + 1) *
    glu. In bf16 and f16 each step rounds to gate's dtype where JAX's
    does: the constant 1.702 first (bf16 1.703125, f16 1.7021484375), and
    the sigmoid is XLA's ``1 / (1 + exp(-z))`` with the exp, the sum and the
    quotient each rounded (``torch.sigmoid`` rounds once); f32 keeps
    ``torch.sigmoid``."""
    if kind == "swiglu_oss":
        gate = gate.clamp(max=limit)
        up = up.clamp(-limit, limit)
        alpha = _OSS_ALPHA16.get(gate.dtype)
        if alpha is None:
            sig = torch.sigmoid(1.702 * gate)
        else:  # -(gate alpha) rounds as gate alpha does, negated
            sig = torch.reciprocal(torch.exp(gate * -alpha).add_(1.0))
        glu = gate * sig
        return (up + 1.0) * glu
    return F.silu(gate) * up


def glu_quant_plain(gate, up=None, kind: str = "silu", limit: float = 0.0, biases=None,
                    expert_ids=None, want_act: bool = False):
    """Plain PyTorch version of ``glu_quant``: the biases by expert id, then
    ``glu`` and ``quantize_rows_plain`` of its output."""
    if up is None:
        half = gate.shape[-1] // 2
        gate, up = gate[..., :half], gate[..., half:]
    if biases is not None:
        gate = gate + biases[0][expert_ids]
        up = up + biases[1][expert_ids]
    act = glu(gate, up, kind, limit).contiguous()
    xq, scale = quantize_rows_plain(act)
    return xq, scale, (act if want_act else None)


def glu_quant(
    gate: torch.Tensor,  # [M, F], or [M, 2F] = gate | up when up is None
    up: torch.Tensor | None = None,  # [M, F]
    kind: str = "silu",  # or "swiglu_oss" (gpt-oss), clamped at limit
    limit: float = 0.0,
    biases: tuple | None = None,  # (b_gate [E, F], b_up [E, F]) picked by expert_ids
    expert_ids: torch.Tensor | None = None,  # int64 [M], each row's expert
    want_act: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The gated unit (``glu``, after the experts' biases where given) and
    the per-row int8 of its output in one launch (``csrc/quantize_rows.cu``):
    returns ``(xq int8 [M, F], a_scale f32 [M], act if want_act else
    None)``; (xq, a_scale) are ``quantize_rows`` of act. gate and up may be
    views with rows apart (the halves of one ``[M, 2F]`` product). Outputs
    come from ``torch.empty``. CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    if gate.device.type == "cpu":
        return glu_quant_plain(gate, up, kind, limit, biases, expert_ids, want_act)
    if gate.device.type != "cuda":
        raise ValueError(f"unsupported device {gate.device}")
    if kind not in GLU_KINDS:
        raise ValueError(f"unknown gated unit {kind!r}")
    if up is None:
        if gate.dim() != 2 or gate.shape[1] % 2:
            raise ValueError(f"gate|up must be [M, 2F]; got {tuple(gate.shape)}")
        half = gate.shape[1] // 2
        gate, up = gate[:, :half], gate[:, half:]
    _check_width(gate)
    M, Fw = gate.shape
    _check_rows("gate", gate, (M, Fw), gate.dtype)
    _check_rows("up", up, (M, Fw), gate.dtype)
    if (biases is None) != (expert_ids is None):
        raise ValueError("the experts' biases need each row's expert id, and only they do")
    if biases is not None:
        for name, b in zip(("b_gate", "b_up"), biases):
            _check_rows(name, b, (b.shape[0], Fw), gate.dtype)
            if not b.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if expert_ids.shape != (M,) or expert_ids.dtype != torch.int64 or not expert_ids.is_contiguous():
            raise ValueError(f"expert_ids must be contiguous int64 [M]; got {tuple(expert_ids.shape)} "
                             f"{expert_ids.dtype}")
    xq = torch.empty((M, Fw), dtype=torch.int8, device=gate.device)
    scale = torch.empty((M,), dtype=torch.float32, device=gate.device)
    act = torch.empty((M, Fw), dtype=gate.dtype, device=gate.device) if want_act else None
    if M == 0:
        return xq, scale, act
    b_gate, b_up = (None, None) if biases is None else biases
    err = _library().glu_quant(
        xq.data_ptr(), scale.data_ptr(), _ptr(act), gate.data_ptr(), up.data_ptr(),
        gate.stride(0), up.stride(0), _ptr(b_gate), _ptr(b_up), _ptr(expert_ids),
        GLU_KINDS[kind], float(limit), M, Fw, _DTYPE_CODES[gate.dtype],
        torch.cuda.current_stream(gate.device).cuda_stream)
    if err:
        raise RuntimeError(f"glu_quant launch failed: CUDA error {err}")
    glu_quant.launches += 1
    return xq, scale, act


glu_quant.launches = 0


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
