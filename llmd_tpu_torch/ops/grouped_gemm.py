"""Grouped GEMM for MoE expert compute: tokens sorted by expert, each expert
multiplies only its own rows.

``grouped_matmul`` launches the CUDA kernel ``csrc/grouped_gemm.cu``, which
replaces the TPU kernel ``llmd_tpu/ops/grouped_gemm.py:grouped_matmul``
(``megablox.gmm``, a library Pallas kernel). JAX takes that kernel only for
lane-tiled shapes (H and F multiples of 128) and ``lax.ragged_dot``
elsewhere; the port's kernel has no such gate and takes whatever its
``_check`` accepts. It is bound by bytes at both a decode step and a 1k-token
prefill step: every expert's weights are read once. See the kernel source
for its design. ``grouped_matmul_plain`` is the plain PyTorch version: one
masked product per group over the static group count, so it reads nothing
back to the host; the wrapper takes it for CPU tensors only.

Around the kernel, in plain PyTorch as JAX leaves them to XLA:
``expert_mlp_grouped`` (gate, up, the config's GLU, down, and gpt-oss's
per-expert biases) and ``moe_apply_grouped`` (stable sort by expert,
gather, grouped MLP, weighted combine). The group
sizes are counted with ``scatter_add_`` (``torch.bincount`` on CUDA reads
its input's maximum back to size its output) and the combine sums each
token's rows in ascending sorted position, the order of JAX's scatter-add
on the CPU, without ``index_add_``'s atomics.
"""

from __future__ import annotations

import ctypes

import torch

from llmd_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("grouped_gemm")
        lib.grouped_gemm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p
        ]
        lib.grouped_gemm.restype = ctypes.c_int
        _lib = lib
    return _lib.grouped_gemm


def grouped_matmul_plain(
    x: torch.Tensor,  # [M, K] rows sorted by group
    w: torch.Tensor,  # [G, K, N]
    group_sizes: torch.Tensor,  # [G] int, sums to M
) -> torch.Tensor:  # [M, N] in x's dtype
    """Plain PyTorch version: row r belongs to the group whose running end
    first exceeds r; each group's product (in f32) is kept on its rows."""
    M = x.shape[0]
    G, _, N = w.shape
    ends = torch.cumsum(group_sizes.long(), 0)
    gid = torch.searchsorted(ends, torch.arange(M, device=x.device), right=True)
    xf = x.float()
    out = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for g in range(G):
        out = torch.where((gid == g)[:, None], xf @ w[g].float(), out)
    return out.to(x.dtype)


def _check(x, w, group_sizes):
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not fit [M, K] x [G, K, N]")
    G, K, N = w.shape
    if group_sizes.shape != (G,):
        raise ValueError(f"group_sizes must be [G] = [{G}], got {tuple(group_sizes.shape)}")
    if group_sizes.dtype != torch.int32:
        raise ValueError(f"group_sizes must be int32, got {group_sizes.dtype}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x {x.dtype} and w {w.dtype} must share a float dtype")
    if K % 8 or N % 8:
        raise ValueError(f"the kernel takes K and N multiples of 8; got K={K}, N={N}")
    for name, t in (("x", x), ("w", w), ("group_sizes", group_sizes)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")


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
    _check(x, w, group_sizes)
    M, K = x.shape
    G, _, N = w.shape
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    err = _kernel()(
        out.data_ptr(), x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
        M, K, N, G, _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"grouped_gemm launch failed: CUDA error {err}")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0


def expert_mlp_grouped(
    x_sorted: torch.Tensor,  # [M, H] rows sorted by expert
    group_sizes: torch.Tensor,  # [E] int32
    we_gate: torch.Tensor,  # [E, H, F]
    we_up: torch.Tensor,  # [E, H, F]
    we_down: torch.Tensor,  # [E, F, H]
    biases: tuple | None = None,  # gpt-oss: (b_gate [E, F], b_up [E, F], b_down [E, H])
    cfg=None,  # ModelConfig naming the GLU; None = SwiGLU
    expert_ids: torch.Tensor | None = None,  # [M] expert of each sorted row
) -> torch.Tensor:  # [M, H]
    """The routed rows' expert MLP: three grouped products around the GLU,
    each row's expert biases added after its products (``expert_ids``
    says whose they are; required with ``biases``)."""
    from llmd_tpu_torch.models.moe import expert_glu

    gate = grouped_matmul(x_sorted, we_gate, group_sizes)
    up = grouped_matmul(x_sorted, we_up, group_sizes)
    if biases is not None:
        gate = gate + biases[0][expert_ids]
        up = up + biases[1][expert_ids]
    act = expert_glu(gate, up, cfg).to(x_sorted.dtype)
    out = grouped_matmul(act.contiguous(), we_down, group_sizes)
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
    biases: tuple | None = None,
    cfg=None,
) -> torch.Tensor:  # [T, H] f32
    """Route -> stable sort by expert -> grouped MLP -> weighted combine.
    A sorted row's expert is ``flat_ids[order]`` (JAX's ``repeat(arange(E),
    group_sizes)``, without the host read ``repeat_interleave`` makes)."""
    T, H = ht.shape
    k = ids.shape[1]
    E = we_gate.shape[0]
    flat_ids = ids.reshape(-1).long()  # [T*k], slot t * k + j
    # Stable: equal expert ids keep token order, so the sorted layout and
    # the combine's summation order are deterministic.
    order = torch.argsort(flat_ids, stable=True)
    tok = order // k  # source token of each sorted row
    xs = ht[tok].contiguous()
    group_sizes = torch.zeros(E, dtype=torch.int32, device=ht.device).scatter_add_(
        0, flat_ids, torch.ones_like(flat_ids, dtype=torch.int32)
    )
    ys = expert_mlp_grouped(
        xs, group_sizes, we_gate, we_up, we_down, biases=biases, cfg=cfg,
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
