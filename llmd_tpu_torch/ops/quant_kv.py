"""The int8 KV pool: quantization helpers and the layout contract.

The port of ``llmd_tpu/ops/quant_kv.py``. The quantized pool is a pair:

  data:   [L, num_pages, K, page, 2D] int8 (K in [..., :D], V in [..., D:])
  scales: [L, num_pages, K, page, 2]  f32, one scale per (token, head) for
          the K half and one for the V half

the layout of the reference, co-indexed with the data pool's page axis, so
a page (data and scales) is byte-compatible with the reference's pages and
wire frames. Scales are stored f32, but their values lie on the f16 grid:
quantization divides by the f16-rounded scale, so narrowing a scale to f16
for the wire is lossless and dequantize -> requantize is a round trip.
Separate K and V scales: rotated keys run about an order of magnitude
hotter than values, and one shared amax would leave the values a few int8
levels.

``quantize_kv_rows`` is bit-for-bit the JAX package's on the CPU, edge rows
included: an all-zero row gets scale 0 (the f16 scale underflows) and
data 0 (0 * inf is NaN, which XLA converts to int8 0; the port maps NaN to
0 explicitly, since a NaN -> int8 cast is undefined in torch), and a row
whose amax / 127 overflows f16 gets scale inf and data 0 (x * 1/inf). The
int8 write kernels (``csrc/flat_kv_write.cu``, ``csrc/decode_kv_write.cu``)
store the same bytes.
"""

from __future__ import annotations

import torch

# Pool storage dtype of the scales; their values sit on the f16 grid.
KV_SCALES_DTYPE = torch.float32


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of ``x`` [..., D]: (int8 data, f32 scale
    [...]). One reciprocal a row, then a multiply, as in the reference."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp(min=1e-30) / 127.0
    # Quantize against the f16-rounded scale: the exact value an f16 wire
    # consumer dequantizes with.
    scale = scale.to(torch.float16).float()
    q = torch.round(xf * torch.reciprocal(scale)).clamp(-127, 127)
    q = torch.where(torch.isnan(q), 0.0, q)
    return q.to(torch.int8), scale[..., 0].to(KV_SCALES_DTYPE)


def quantize_kv_rows(
    k: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This step's K and V rows ``[..., D]`` (float) -> (k8 int8, v8 int8,
    scales ``[..., 2]`` f32 on the f16 grid)."""
    k8, ks = _quantize(k)
    v8, vs = _quantize(v)
    return k8, v8, torch.stack([ks, vs], dim=-1)


def quantize_pages(pages: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Float pages ``[..., K, page, 2D]`` -> (int8 data of the same shape,
    scales ``[..., K, page, 2]``) in the pool layout."""
    D = pages.shape[-1] // 2
    k8, v8, srow = quantize_kv_rows(pages[..., :D], pages[..., D:])
    return torch.cat([k8, v8], dim=-1), srow


def dequantize_pages(
    data: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """(int8 data, scales ``[..., K, page, 2]``) -> float pages ``[..., K,
    page, 2D]`` in ``dtype``."""
    D = data.shape[-1] // 2
    s = scales.float()
    k = data[..., :D].float() * s[..., 0:1]
    v = data[..., D:].float() * s[..., 1:2]
    return torch.cat([k, v], dim=-1).to(dtype)
