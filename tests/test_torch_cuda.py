"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one. On a machine with the card (JAX need not be installed,
so the repository's conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Inputs are made from a seed with numpy. The KV writes are held to exact
equality (both are copies). Attention is held to atol 1e-5 in f32 (the
sums run in another order). In bf16/f16 both sides reduce in f32 and round
once, so an output may land one ulp apart and no further: atol 2e-5 (the
f32 disagreement, which decides the rounding near zero) plus rtol of one
ulp, at most 2^-7 of a bf16 value and 2^-10 of an f16 value.
"""

import numpy as np
import pytest
import torch

from llmd_tpu_torch import ops
from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig, tiny_model_config
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.models import llama

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-5, 2.0**-7), torch.float16: (2e-5, 2.0**-10)}
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


def decode_step(rng, page, kv_lens):
    """A decode batch: kv_len per row (0 = pad row). Live rows get distinct
    pages and write position kv_len - 1; pad rows carry a garbage page."""
    kv_lens = np.asarray(kv_lens, np.int32)
    B = len(kv_lens)
    need = -(-kv_lens // page)
    max_pages = int(need.max()) + 1
    num_pages = int(need.sum()) + 8
    perm = rng.permutation(num_pages)
    pt = np.zeros((B, max_pages), np.int32)
    off = 0
    for b, n in enumerate(need):
        pt[b, :n] = perm[off : off + n]
        off += n
    valid = (kv_lens > 0).astype(np.int32)
    pos = np.maximum(kv_lens - 1, 0)
    phys = pt[np.arange(B), pos // page].astype(np.int32)
    phys[valid == 0] = 2**30  # never dereferenced
    return pt, kv_lens, phys, (pos % page).astype(np.int32), valid, num_pages


# kv_len 1, a page boundary, max_model_len (8,192) and pad rows.
DECODE_LENS = (1, 0, 8192, 16, 17, 0, 1000, 333)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("page,D,K", [(16, 128, 8), (8, 64, 2), (32, 256, 1)])
def test_decode_kv_write_kernel_is_exact(dev, dtype, page, D, K):
    rng = np.random.default_rng(4)
    L = 3
    pt, kv_lens, phys, offset, valid, P = decode_step(rng, page, DECODE_LENS)
    B = len(kv_lens)
    pool = torch.from_numpy(rng.normal(size=(L, P, K, page, 2 * D)).astype(np.float32)).to(dev, dtype)
    kv_new = torch.from_numpy(rng.normal(size=(B, K, 2 * D))).to(dev, dtype)
    phys, offset, valid = on(dev, phys, offset, valid)
    ref = pool.clone()
    ops.reset_launch_counts()
    out = ops.write_kv_pages_decode_full(pool, kv_new, 1, phys, offset, valid)
    ops.write_kv_pages_decode_plain(ref, kv_new, 1, phys, offset, valid)
    torch.cuda.synchronize()
    assert out is pool and torch.equal(pool, ref)
    assert ops.launch_counts()["write_kv_pages_decode_full"] == 1
    # The single-layer entry is the same kernel on one layer's view.
    ops.write_kv_pages_decode(pool[2], kv_new, phys, offset, valid)
    ops.write_kv_pages_decode_plain(ref, kv_new, 2, phys, offset, valid)
    torch.cuda.synchronize()
    assert torch.equal(pool, ref)
    assert ops.launch_counts()["write_kv_pages_decode_full"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize(
    "page,D,K,G", [(16, 128, 8, 4), (8, 64, 2, 1), (16, 256, 1, 8), (32, 128, 4, 8), (32, 64, 2, 4)]
)
def test_decode_attention_kernel_matches_plain(dev, dtype, page, D, K, G):
    if page * 2 * D * torch.tensor([], dtype=dtype).element_size() > 48 * 1024:
        pytest.skip("one page of K|V exceeds the kernel's shared-memory tile")
    rng = np.random.default_rng(5)
    L = 2
    pt, kv_lens, _, _, _, P = decode_step(rng, page, DECODE_LENS)
    B = len(kv_lens)
    pool = torch.from_numpy(rng.normal(size=(L, P, K, page, 2 * D)).astype(np.float32)).to(dev, dtype)
    q = torch.from_numpy(rng.normal(size=(B, 1, K * G, D))).to(dev, dtype)
    pt, kv_lens = on(dev, pt, kv_lens)
    ops.reset_launch_counts()
    got = ops.decode_paged_attention_full(q, pool, 1, pt, kv_lens)
    want = ops.decode_paged_attention_plain(q, pool, 1, pt, kv_lens)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    pads = kv_lens == 0
    assert not got[pads].any()  # pad rows come out as zeros
    assert ops.launch_counts()["decode_paged_attention_full"] == 1
    one = ops.decode_paged_attention(q, pool[1], pt, kv_lens)
    torch.cuda.synchronize()
    assert torch.equal(one, got)


def test_decode_attention_never_reads_past_kv_len(dev):
    """The pool past each row's kv_len is NaN: a dead position that
    entered a sum would poison the row."""
    rng = np.random.default_rng(6)
    page, D, K, G = 16, 128, 8, 4
    pt, kv_lens, _, _, _, P = decode_step(rng, page, (5, 16, 31, 0, 100))
    pool = torch.from_numpy(rng.normal(size=(1, P, K, page, 2 * D)).astype(np.float32)).to(dev)
    clean = pool.clone()
    for b, n in enumerate(kv_lens):
        for i in range(n, pt.shape[1] * page):
            pool[:, pt[b, i // page], :, i % page] = float("nan")
    q = torch.from_numpy(rng.normal(size=(len(kv_lens), 1, K * G, D)).astype(np.float32)).to(dev)
    pt, kv_lens = on(dev, pt, kv_lens)
    got = ops.decode_paged_attention_full(q, pool, 0, pt, kv_lens)
    want = ops.decode_paged_attention_plain(q, clean, 0, pt, kv_lens)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


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
    B = pt.shape[0]
    qd = torch.zeros((B, 1, 4, 128), device=dev, dtype=torch.bfloat16)
    kv_new = torch.zeros((B, 2, 256), device=dev, dtype=torch.bfloat16)
    idx = torch.zeros((B,), device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        ops.decode_paged_attention_full(qd.float(), pool, 0, pt, idx)
    with pytest.raises(ValueError, match="int32"):
        ops.decode_paged_attention_full(qd, pool, 0, pt, idx.long())
    with pytest.raises(ValueError, match=r"\[B, max_pages\]"):
        ops.decode_paged_attention_full(qd, pool, 0, pt[:-1], idx)
    with pytest.raises(ValueError, match="layer"):
        ops.decode_paged_attention_full(qd, pool, -1, pt, idx)
    with pytest.raises(ValueError, match="int32"):
        ops.write_kv_pages_decode_full(pool, kv_new, 0, idx, idx, idx.bool())
    with pytest.raises(ValueError, match="dtype"):
        ops.write_kv_pages_decode_full(pool, kv_new.float(), 0, idx, idx, idx)
    with pytest.raises(ValueError, match="does not fit"):
        ops.write_kv_pages_decode_full(pool, kv_new[:, :1], 0, idx, idx, idx)
    with pytest.raises(ValueError, match="is on cpu"):
        ops.write_kv_pages_decode_full(pool, kv_new, 0, idx.cpu(), idx, idx)
    with pytest.raises(ValueError, match="layer"):
        ops.write_kv_pages_decode_full(pool, kv_new, 2, idx, idx, idx)


LAYOUTS = {
    "flat": {},
    "split": dict(unified_step=False),
    "window": dict(unified_step=False, decode_window=4),
    "flat_window": dict(decode_window=4),
    "bucketed": dict(ragged_qlens=False),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_engine_on_the_card_matches_the_cpu_engine(dev, layout):
    """Tiny f32 engine: the same weights on the card (kernels) and on the
    CPU (plain versions) give the same greedy and seeded streams in every
    step layout, and each layout launches the kernels it names."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = EngineConfig(
        model=tiny_model_config(head_dim=64, num_layers=3),
        cache=CacheConfig(page_size=8, num_blocks=64, dtype="float32"),
        scheduler=SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=32,
                                  **LAYOUTS[layout]),
    )
    params = llama.init_params(cfg.model, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (5, 40, 17, 70)]
    sps = [
        SamplingParams(temperature=t, max_tokens=12, ignore_eos=True, seed=9)
        for t in (0.0, 0.8, 0.0, 0.8)
    ]
    cpu = LLMEngine(cfg, params=params, device="cpu").generate(prompts, sps)
    gpu_engine = LLMEngine(cfg, params=params, device="cuda")
    ks = []
    dispatch = gpu_engine.runner.dispatch_staged_decode
    gpu_engine.runner.dispatch_staged_decode = lambda st: (ks.append(st.k), dispatch(st))[1]
    ops.reset_launch_counts()
    gpu = gpu_engine.generate(prompts, sps)
    assert list(gpu.values()) == list(cpu.values())
    # The flat pair runs once a layer in every flat step, the decode pair
    # once a layer in every iteration of every decode window; prefill
    # groups and the bucketed unified step run no kernel.
    L = cfg.model.num_layers
    flat_steps = gpu_engine.stats.unified_steps_total if gpu_engine.runner.flat else 0
    assert ops.launch_counts() == {
        "write_kv_pages_flat_full": L * flat_steps,
        "flat_paged_attention_full": L * flat_steps,
        "write_kv_pages_decode_full": L * sum(ks),
        "decode_paged_attention_full": L * sum(ks),
    }
    assert (flat_steps > 0) == (layout in ("flat", "flat_window"))
    assert (sum(ks) > 0) == (layout != "flat")
    assert (max(ks, default=1) == 4) == (layout in ("window", "flat_window"))
