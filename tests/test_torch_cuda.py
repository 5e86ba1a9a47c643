"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one. On a machine with the card (JAX need not be installed,
so the repository's conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Inputs are made from a seed with numpy. The KV write is held to exact
equality (both are copies). Attention is held to atol 1e-5 in f32 (the
sums run in another order) and to atol 2e-2 + rtol 1e-2 in bf16/f16 (both
reduce in f32 and round once, so an output may land one ulp apart).
"""

import numpy as np
import pytest
import torch

from llmd_tpu_torch import ops
from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig, tiny_model_config
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.models import llama

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-2, 1e-2), torch.float16: (2e-2, 1e-2)}
# (pos0, qlen) per row: prefill chunks with and without a prefix, one that
# straddles pages, one-token decode rows.
ROWS = ((0, 37), (45, 20), (130, 1), (7, 1), (250, 3), (0, 1))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def flat_step(rng, page, pad=5):
    """Per-token rows/positions/kv_lens of ROWS packed with ``pad`` pads,
    a page table giving each row distinct pages, and the pool's size in
    pages (a few more than the rows use)."""
    need = [-(-(p0 + w) // page) for p0, w in ROWS]
    max_pages = max(need) + 1
    num_pages = sum(need) + 8
    perm = rng.permutation(num_pages)
    pt = np.zeros((len(ROWS), max_pages), np.int32)
    rows, positions, off = [], [], 0
    for r, ((p0, w), n) in enumerate(zip(ROWS, need)):
        pt[r, :n] = perm[off : off + n]
        off += n
        rows += [r] * w
        positions += range(p0, p0 + w)
    total = len(rows)
    rows += [len(ROWS) - 1] * pad
    positions += [0] * pad
    positions = np.asarray(positions, np.int32)
    live = np.arange(total + pad) < total
    kv_lens = np.where(live, positions + 1, 0).astype(np.int32)
    return pt, np.asarray(rows, np.int32), positions, kv_lens, total, num_pages


def on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("page,D,K", [(16, 128, 8), (8, 64, 2), (32, 256, 1)])
def test_flat_kv_write_kernel_is_exact(dev, dtype, page, D, K):
    rng = np.random.default_rng(0)
    L = 3
    pt, rows, positions, _, total, P = flat_step(rng, page)
    T = len(rows)
    pool = torch.from_numpy(rng.normal(size=(L, P, K, page, 2 * D))).to(dev, dtype)
    k = torch.from_numpy(rng.normal(size=(T, 1, K, D))).to(dev, dtype)
    v = torch.from_numpy(rng.normal(size=(T, 1, K, D))).to(dev, dtype)
    pt, rows, positions = on(dev, pt, rows, positions)
    ref = pool.clone()
    ops.reset_launch_counts()
    out = ops.write_kv_pages_flat_full(pool, 1, k, v, pt, rows, positions, total)
    ops.write_kv_pages_flat_plain(ref, 1, k, v, pt, rows, positions, total)
    torch.cuda.synchronize()
    assert out is pool
    assert torch.equal(pool, ref)
    assert ops.launch_counts()["write_kv_pages_flat_full"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("page,D,K,G", [(16, 128, 8, 4), (8, 64, 2, 1), (16, 256, 1, 8), (32, 128, 4, 2)])
def test_flat_attention_kernel_matches_plain(dev, dtype, page, D, K, G):
    if page * 2 * D * torch.tensor([], dtype=dtype).element_size() > 48 * 1024:
        pytest.skip("one page of K|V exceeds the kernel's shared-memory tile")
    rng = np.random.default_rng(1)
    L = 2
    pt, rows, positions, kv_lens, total, P = flat_step(rng, page)
    T = len(rows)
    pool = torch.from_numpy(rng.normal(size=(L, P, K, page, 2 * D))).to(dev, dtype)
    q = torch.from_numpy(rng.normal(size=(T, 1, K * G, D))).to(dev, dtype)
    pt, rows, kv_lens = on(dev, pt, rows, kv_lens)
    ops.reset_launch_counts()
    got = ops.flat_paged_attention_full(q, pool, 1, rows, pt, kv_lens)
    want = ops.flat_paged_attention_plain(q, pool, 1, rows, pt, kv_lens)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got[:total].float(), want[:total].float(), atol=atol, rtol=rtol)
    assert not got[total:].any()  # pads (kv_len 0) come out as zeros
    assert ops.launch_counts()["flat_paged_attention_full"] == 1


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(2)
    pt, rows, positions, kv_lens, total, P = flat_step(rng, 16)
    T = len(rows)
    pool = torch.zeros((2, P, 2, 16, 256), device=dev, dtype=torch.bfloat16)
    q = torch.zeros((T, 1, 4, 128), device=dev, dtype=torch.bfloat16)
    k = torch.zeros((T, 1, 2, 128), device=dev, dtype=torch.bfloat16)
    pt, rows, positions, kv_lens = on(dev, pt, rows, positions, kv_lens)
    with pytest.raises(ValueError, match="dtype"):
        ops.flat_paged_attention_full(q.float(), pool, 0, rows, pt, kv_lens)
    with pytest.raises(ValueError, match="int32"):
        ops.flat_paged_attention_full(q, pool, 0, rows.long(), pt, kv_lens)
    with pytest.raises(ValueError, match="contiguous"):
        ops.write_kv_pages_flat_full(pool, 0, k, k, pt.t().contiguous().t(), rows, positions, total)
    with pytest.raises(ValueError, match="is on cpu"):
        ops.write_kv_pages_flat_full(pool, 0, k, k, pt.cpu(), rows, positions, total)
    with pytest.raises(ValueError, match="layer"):
        ops.flat_paged_attention_full(q, pool, 2, rows, pt, kv_lens)


def test_engine_on_the_card_matches_the_cpu_engine(dev):
    """Tiny f32 engine: the same weights on the card (kernels) and on the
    CPU (plain versions) give the same greedy streams, and every step
    launches each kernel once per layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = EngineConfig(
        model=tiny_model_config(head_dim=64, num_layers=3),
        cache=CacheConfig(page_size=8, num_blocks=64, dtype="float32"),
        scheduler=SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=32),
    )
    params = llama.init_params(cfg.model, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (5, 40, 17, 70)]
    sp = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)
    cpu = LLMEngine(cfg, params=params, device="cpu").generate(prompts, sp)
    gpu_engine = LLMEngine(cfg, params=params, device="cuda")
    ops.reset_launch_counts()
    gpu = gpu_engine.generate(prompts, sp)
    steps = gpu_engine.stats.engine_steps_total
    assert list(gpu.values()) == list(cpu.values())
    assert set(ops.launch_counts().values()) == {cfg.model.num_layers * steps}
