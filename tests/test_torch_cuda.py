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
from llmd_tpu_torch.ops import grouped_gemm

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


def live(total, dev):
    """The flat KV write's live count: one int32 on the device."""
    return torch.tensor([total], dtype=torch.int32, device=dev)


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
    out = ops.write_kv_pages_flat_full(pool, 1, k, v, pt, rows, positions, live(total, dev))
    ops.write_kv_pages_flat_plain(ref, 1, k, v, pt, rows, positions, live(total, dev))
    torch.cuda.synchronize()
    assert out is pool
    assert torch.equal(pool, ref)
    assert ops.launch_counts()["write_kv_pages_flat_full"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("page,D,K,G", [(16, 128, 8, 4), (8, 64, 2, 1), (16, 256, 1, 8), (32, 128, 4, 2)])
def test_flat_attention_kernel_matches_plain(dev, dtype, page, D, K, G):
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


def packed_rows(rng, rows_spec, page, pad=3):
    """A flat step of (pos0, qlen) rows (each row's tokens contiguous) and
    ``pad`` pads, distinct pages per row: (page table, rows, kv_lens,
    live tokens, pool pages)."""
    need = [-(-(p0 + w) // page) for p0, w in rows_spec]
    num_pages = sum(need) + 4
    perm = rng.permutation(num_pages)
    pt = np.zeros((len(rows_spec), max(need) + 1), np.int32)
    rows, kv, off = [], [], 0
    for r, ((p0, w), n) in enumerate(zip(rows_spec, need)):
        pt[r, :n] = perm[off : off + n]
        off += n
        rows += [r] * w
        kv += range(p0 + 1, p0 + w + 1)
    total = len(rows)
    rows += [len(rows_spec) - 1] * pad
    kv += [0] * pad
    return pt, np.asarray(rows, np.int32), np.asarray(kv, np.int32), total, num_pages


# Runs longer than a tile and not a multiple of it (Tq = 16 at G = 4, 8 at
# G = 8), tiles whose tokens have different horizons (every prefill tile;
# with a window, different window starts too), rows of 8,192 positions cut
# into several spans, and decode rows beside them.
FLAT_CASES = {
    "long_runs": ((0, 100), (37, 50), (500, 17), (3, 1)),
    "long_rows": ((8000, 100), (8191, 1), (4095, 1), (0, 9)),
}


@pytest.mark.parametrize("spans", ["auto", 1, 3])
@pytest.mark.parametrize("case", sorted(FLAT_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("G,window", [(4, 0), (8, 0), (4, 300)])
def test_flat_attention_tiles_and_spans(dev, dtype, case, spans, G, window, monkeypatch):
    """K1' on tiles longer than Tq and rows longer than a span, with the
    wrapper's span count and with 1 and 3 spans forced; pads zero."""
    from llmd_tpu_torch.ops import ragged_paged_attention as rpa

    if spans != "auto":
        monkeypatch.setattr(rpa, "spans_for", lambda *args: spans)
    rng = np.random.default_rng(41)
    page, D, K = 16, 128, 2
    pt, rows, kv_lens, total, P = packed_rows(rng, FLAT_CASES[case], page)
    pool = torch.from_numpy(rng.normal(size=(1, P, K, page, 2 * D)).astype(np.float32)).to(dev, dtype)
    q = torch.from_numpy(rng.normal(size=(len(rows), 1, K * G, D)).astype(np.float32)).to(dev, dtype)
    pt, rows, kv_lens = on(dev, pt, rows, kv_lens)
    args = (q, pool, 0, rows, pt, kv_lens, None, window)
    got = ops.flat_paged_attention_full(*args)
    want = ops.flat_paged_attention_plain(*args)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got[:total].float(), want[:total].float(), atol=atol, rtol=rtol)
    assert not got[total:].any()
    items = ops.flat_work_items(rows, kv_lens, G)
    torch.testing.assert_close(ops.flat_paged_attention_full(*args, items=items), got, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("G", [3, 5, 24, 32])
def test_attention_tiles_of_odd_groups(dev, dtype, G):
    """Groups whose tiles are not whole m16 fragments (Tq * G of 63, 60,
    48 and 64 rows): K1' on the ROWS mix and K3' on DECODE_LENS."""
    rng = np.random.default_rng(45)
    page, D, K = 16, 64, 2
    pt, rows, _, kv_lens, total, P = flat_step(rng, page)
    pool = torch.from_numpy(rng.normal(size=(1, P, K, page, 2 * D)).astype(np.float32)).to(dev, dtype)
    q = torch.from_numpy(rng.normal(size=(len(rows), 1, K * G, D)).astype(np.float32)).to(dev, dtype)
    pt, rows, kv_lens = on(dev, pt, rows, kv_lens)
    got = ops.flat_paged_attention_full(q, pool, 0, rows, pt, kv_lens)
    want = ops.flat_paged_attention_plain(q, pool, 0, rows, pt, kv_lens)
    dpt, dlens, _, _, _, dP = decode_step(rng, page, DECODE_LENS)
    dpool = torch.from_numpy(rng.normal(size=(1, dP, K, page, 2 * D)).astype(np.float32)).to(dev, dtype)
    dq = torch.from_numpy(rng.normal(size=(len(dlens), 1, K * G, D)).astype(np.float32)).to(dev, dtype)
    dpt, dlens = on(dev, dpt, dlens)
    dgot = ops.decode_paged_attention_full(dq, dpool, 0, dpt, dlens)
    dwant = ops.decode_paged_attention_plain(dq, dpool, 0, dpt, dlens)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got[:total].float(), want[:total].float(), atol=atol, rtol=rtol)
    assert not got[total:].any()
    torch.testing.assert_close(dgot.float(), dwant.float(), atol=atol, rtol=rtol)
    assert not dgot[dlens == 0].any()


@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("G", [4, 8])
def test_decode_attention_batches_of_1_and_64(dev, dtype, B, G):
    """K3' on one row (many spans) and on 64 rows up to 8,192 positions."""
    rng = np.random.default_rng(42)
    page, D, K = 16, 128, 2
    lens = [8192] if B == 1 else rng.integers(0, 8193, B).tolist()
    pt, kv_lens, _, _, _, P = decode_step(rng, page, lens)
    pool = torch.from_numpy(rng.normal(size=(1, P, K, page, 2 * D)).astype(np.float32)).to(dev, dtype)
    q = torch.from_numpy(rng.normal(size=(B, 1, K * G, D)).astype(np.float32)).to(dev, dtype)
    pt, kv_lens = on(dev, pt, kv_lens)
    got = ops.decode_paged_attention_full(q, pool, 0, pt, kv_lens)
    want = ops.decode_paged_attention_plain(q, pool, 0, pt, kv_lens)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert not got[kv_lens == 0].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flat_attention_never_reads_dead_positions(dev, dtype):
    """The flat kernel's counterpart of the decode kernels' test: pool rows
    past each row's last kv_len and before its first window start hold NaN
    (a float pool) or an f16-overflow inf scale (an int8 pool); the result
    is finite and equals the plain version on a clean pool."""
    rng = np.random.default_rng(43)
    page, D, K, G, window = 16, 64, 8, 8, 40
    pt, rows, kv_lens, total, P = packed_rows(rng, ((0, 70), (100, 33), (7, 1), (300, 1)), page)
    rows_spec_hi = {}
    for r, n in zip(rows[:total], kv_lens[:total]):
        lo = max(int(n) - window, 0)
        a, b = rows_spec_hi.get(r, (lo, int(n)))
        rows_spec_hi[r] = (min(a, lo), max(b, int(n)))
    sinks = torch.from_numpy(rng.normal(size=(K * G,)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.normal(size=(len(rows), 1, K * G, D)).astype(np.float32)).to(dev, dtype)
    tpt, trows, tkv = on(dev, pt, rows, kv_lens)
    for int8 in (False, True):
        pool, scales = branch_pool(rng, dev, dtype, 1, P, K, page, D, int8)
        dirty_pool, dirty_scales = pool.clone(), None if scales is None else scales.clone()
        for r, (lo, hi) in rows_spec_hi.items():
            # Before the window, and the dead tail of the last live page
            # (table columns past it point at other rows' pages).
            for i in [*range(lo), *range(hi, -(-hi // page) * page)]:
                if int8:
                    dirty_scales[:, pt[r, i // page], :, i % page] = float("inf")
                else:
                    dirty_pool[:, pt[r, i // page], :, i % page] = float("nan")
        got = ops.flat_paged_attention_full(q, dirty_pool, 0, trows, tpt, tkv, None, window, sinks,
                                            dirty_scales)
        want = ops.flat_paged_attention_plain(q, pool, 0, trows, tpt, tkv, None, window, sinks,
                                              scales)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        atol, rtol = TOL[dtype]
        torch.testing.assert_close(got[:total].float(), want[:total].float(), atol=atol, rtol=rtol)
        assert not got[total:].any()


def test_int8_decode_never_reads_inf_scales_past_kv_len(dev):
    """bf16 queries on an int8 pool whose scales past kv_len are inf."""
    rng = np.random.default_rng(44)
    page, D, K, G = 16, 128, 8, 4
    pt, kv_lens, _, _, _, P = decode_step(rng, page, DECODE_LENS)
    data, scales = branch_pool(rng, dev, torch.bfloat16, 1, P, K, page, D, True)
    dirty = scales.clone()
    for b, n in enumerate(kv_lens):
        for i in range(n, -(-n // page) * page):  # the last live page's dead tail
            dirty[:, pt[b, i // page], :, i % page] = float("inf")
    q = torch.from_numpy(rng.normal(size=(len(kv_lens), 1, K * G, D)).astype(np.float32)).to(dev, torch.bfloat16)
    tpt, tkv = on(dev, pt, kv_lens)
    got = ops.decode_paged_attention_full(q, data, 0, tpt, tkv, scales=dirty)
    want = ops.decode_paged_attention_plain(q, data, 0, tpt, tkv, scales=scales)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


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
        ops.write_kv_pages_flat_full(pool, 0, k, k, pt.t().contiguous().t(), rows, positions, live(total, dev))
    with pytest.raises(ValueError, match="is on cpu"):
        ops.write_kv_pages_flat_full(pool, 0, k, k, pt.cpu(), rows, positions, live(total, dev))
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
        "mla_decode_paged_attention_full": 0,
        "grouped_matmul": 0,
        "grouped_matmul_pair": 0,
        "quantize_rows": 0,
        "matmul_q8": 0,
        "grouped_matmul_q8": 0,
        "grouped_matmul_q8_pair": 0,
        "add_rms_norm_quant": 0,
        "glu_quant": 0,
    }
    assert (flat_steps > 0) == (layout in ("flat", "flat_window"))
    assert (sum(ks) > 0) == (layout != "flat")
    assert (max(ks, default=1) == 4) == (layout in ("window", "flat_window"))


# Group layouts of the grouped GEMM: (rows per group), K, N. Empty groups,
# one group holding every row, fewer rows than a tile, row counts that are
# not tile multiples, K and N that are not multiples of 128 (or of a tile);
# groups of exactly a tile's 128 (or 64) rows and one more, one row a group,
# a last group ending at M in a partial tile, gpt-oss's K = N = 2,880 and a
# decode-sized layout (128 rows over 32 groups). The bf16/f16 kernel takes
# 64-row tiles where groups average at most 32 rows and 128-row tiles
# elsewhere (grouped_gemm.tile_choice): both occur below.
GROUPS = {
    "spread": ((5, 0, 70, 1, 0, 33, 64, 2), 256, 192),
    "one_group": ((0, 0, 300, 0), 128, 128),
    "below_a_tile": ((3, 0, 2, 1), 64, 64),
    "ragged_k_n": ((17, 0, 40, 9), 200, 72),
    "many_groups": (tuple(int(x) for x in np.random.default_rng(0).integers(0, 12, 64)), 128, 88),
    "tile_and_tile_plus_one": ((64, 65, 128, 129, 0, 1), 128, 136),
    "tile64_and_tile64_plus_one": ((64, 65, 0, 0, 1, 0, 2, 0), 128, 136),
    "one_row_a_group": ((1,) * 24, 64, 128),
    "last_group_ends_at_m": ((0, 130, 0, 0, 67), 96, 256),
    "oss_2880": (tuple(int(x) for x in np.random.default_rng(1).integers(0, 40, 32)), 2880, 2880),
    "decode_128_over_32": (tuple(int(x) for x in np.random.default_rng(2).multinomial(128, [1 / 32] * 32)),
                           256, 384),
}


def grouped_cases(layouts):
    """(dtype, layout) pairs: every layout in bf16 and f16, and in f32 the
    ones with K <= 256, where the f32 tolerance below holds (the f32 kernel
    and the plain version's cuBLAS product sum K terms in other orders; at
    gpt-oss's K = 2,880 they differ by about 1.2e-5)."""
    return [(dtype, name) for name in layouts
            for dtype in (torch.float32, torch.bfloat16, torch.float16)
            if dtype != torch.float32 or GROUPS[name][1] <= 256]


@pytest.mark.parametrize("dtype,layout", grouped_cases(sorted(GROUPS)))
def test_grouped_gemm_kernel_matches_plain(dev, dtype, layout):
    """K6': each row's product with its own group's weights. Both sides sum
    in f32 and round once: in bf16/f16 an output may land one ulp apart;
    in f32 the sums run in another order (atol 1e-5 at |x| ~ 1, K <= 256
    terms scaled by K ** -0.5)."""
    sizes, K, N = GROUPS[layout]
    rng = np.random.default_rng(7)
    M, G = sum(sizes), len(sizes)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.normal(size=(G, K, N)) * K**-0.5).astype(np.float32)).to(dev, dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    got = ops.grouped_matmul(x, w, gs)
    want = ops.grouped_matmul_plain(x, w, gs)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, N)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert ops.launch_counts()["grouped_matmul"] == 1


@pytest.mark.parametrize("dtype,layout", grouped_cases(
    ["spread", "tile_and_tile_plus_one", "tile64_and_tile64_plus_one", "oss_2880",
     "decode_128_over_32"]))
def test_grouped_gemm_pair_matches_two_plain_calls(dev, dtype, layout):
    """The pair call of K6' (gate and up in one launch) against two plain calls:
    each output within one ulp (f32: 1e-5), as two kernel calls would be;
    one launch, counted on the pair's counter."""
    sizes, K, N = GROUPS[layout]
    rng = np.random.default_rng(9)
    M, G = sum(sizes), len(sizes)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev, dtype)
    wa, wb = (torch.from_numpy((rng.normal(size=(G, K, N)) * K**-0.5).astype(np.float32)).to(dev, dtype)
              for _ in range(2))
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    got = ops.grouped_matmul_pair(x, wa, wb, gs)
    want = ops.grouped_matmul_pair_plain(x, wa, wb, gs)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (M, N)
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol)
    assert ops.launch_counts()["grouped_matmul_pair"] == 1
    assert ops.launch_counts()["grouped_matmul"] == 0


# int8 branch of K6' (W8A8): the layouts above whose K and N are multiples
# of 16 (what the branch takes), and N and K that are not multiples of its
# column tiles and 128-byte K slices (gpt-oss's 2,880), llama-3-8b's
# down projection's K = 14,336 at a decode step, deepseek's 1,408-wide
# experts; 1, 8, 32, 64 and 65 rows (the swap-AB form's row tiles and the
# prefill form past them) and groups of 0, 1 and 3 rows.
Q8_GROUPS = {
    **{name: g for name, g in GROUPS.items() if g[1] % 16 == 0 and g[2] % 16 == 0},
    "k2880_n1408": (tuple(int(x) for x in np.random.default_rng(3).integers(0, 9, 64)), 2880, 1408),
    "down_14336_decode": ((32,), 14336, 256),
    "rows_1": ((1,), 400, 2880),
    "rows_8": ((8,), 2880, 400),
    "rows_32": ((32,), 4096, 1024),
    "rows_64": ((64,), 1040, 2880),
    "rows_65": ((65,), 2880, 528),
    "groups_0_1_3": ((0, 1, 3, 0, 3, 1, 0), 208, 2880),
}


def q8_inputs(rng, dev, sizes, K, N, dtype, weights=1):
    """Rows quantized by the plain version, K-major int8 weights ([G, N,
    K]) and their scales."""
    from llmd_tpu_torch.ops import quant

    M, G = sum(sizes), len(sizes)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev, dtype)
    xq, a_scale = quant.quantize_rows_plain(x)
    ws = []
    for _ in range(weights):
        w = torch.from_numpy(rng.normal(size=(G, K, N)).astype(np.float32)).to(dev)
        q, scale = quant.quantize_weight(w)
        ws += [q.mT.contiguous(), scale]
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    return xq, a_scale, ws, gs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout", sorted(Q8_GROUPS))
def test_int8_gemm_kernel_is_bit_equal_to_plain(dev, dtype, layout):
    """K6''s int8 branch: s32 sums (exact in any order) and the epilogue
    (f32(acc) * a_scale) * w_scale rounded once, so bit-equal to the plain
    version in every output type, grouped and as the dense one-group form."""
    sizes, K, N = Q8_GROUPS[layout]
    xq, a_scale, (w, ws), gs = q8_inputs(np.random.default_rng(21), dev, sizes, K, N, dtype)
    ops.reset_launch_counts()
    got = ops.grouped_matmul_q8(xq, a_scale, w, ws, gs, dtype)
    want = ops.grouped_matmul_q8_plain(xq, a_scale, w, ws, gs, dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (sum(sizes), N)
    assert torch.equal(got, want)
    assert ops.launch_counts()["grouped_matmul_q8"] == 1
    dense = ops.matmul_q8(xq, a_scale, w[0], ws[0], dtype)
    torch.cuda.synchronize()
    assert torch.equal(dense, ops.matmul_q8_plain(xq, a_scale, w[0], ws[0], dtype))
    assert ops.launch_counts()["matmul_q8"] == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["spread", "k2880_n1408", "decode_128_over_32"])
def test_int8_gemm_pair_is_bit_equal_to_plain(dev, dtype, layout):
    sizes, K, N = Q8_GROUPS[layout]
    xq, a_scale, (wa, sa, wb, sb), gs = q8_inputs(np.random.default_rng(22), dev, sizes, K, N, dtype, 2)
    ops.reset_launch_counts()
    got = ops.grouped_matmul_q8_pair(xq, a_scale, wa, sa, wb, sb, gs, dtype)
    want = ops.grouped_matmul_q8_pair_plain(xq, a_scale, wa, sa, wb, sb, gs, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ops.launch_counts()["grouped_matmul_q8_pair"] == 1
    assert ops.launch_counts()["grouped_matmul_q8"] == 0


# Every kernel form the launcher takes: swap-AB at each row tile and both
# column tiles, the prefill form at both column tiles.
Q8_FORMS = ([(True, r, c) for r in grouped_gemm.Q8_SWAP_ROWS for c in (64, 128)]
            + [(False, 128, 128), (False, 128, 256)])


@pytest.mark.parametrize("form", Q8_FORMS, ids=[f"{'swap' if s else 'prefill'}_{r}x{c}" for s, r, c in Q8_FORMS])
def test_int8_gemm_every_form_is_bit_equal_to_plain(dev, form, monkeypatch):
    """Each form of K6''s int8 branch, forced through ``q8_plan``, on a
    grouped step (groups of 0 to 70 rows, N and K off the tiles) and a
    dense 65-row product, bf16 out, and the pair in f16: bit-equal to the
    plain version."""
    plan = grouped_gemm.Q8Plan(*form)
    monkeypatch.setattr(grouped_gemm, "q8_plan", lambda *a, **k: plan)
    rng = np.random.default_rng(24)
    for sizes, K, N in (((5, 0, 70, 1, 0, 33, 3, 2), 400, 2880), ((65,), 2880, 528)):
        xq, a_scale, (wa, sa, wb, sb), gs = q8_inputs(rng, dev, sizes, K, N, torch.bfloat16, 2)
        got = ops.grouped_matmul_q8(xq, a_scale, wa, sa, gs, torch.bfloat16)
        assert torch.equal(got, ops.grouped_matmul_q8_plain(xq, a_scale, wa, sa, gs, torch.bfloat16))
        pair = ops.grouped_matmul_q8_pair(xq, a_scale, wa, sa, wb, sb, gs, torch.float16)
        want = ops.grouped_matmul_q8_pair_plain(xq, a_scale, wa, sa, wb, sb, gs, torch.float16)
        assert torch.equal(pair[0], want[0]) and torch.equal(pair[1], want[1])
        if len(sizes) == 1:
            dense = ops.matmul_q8(xq, a_scale, wa[0], sa[0], torch.float32)
            assert torch.equal(dense, ops.matmul_q8_plain(xq, a_scale, wa[0], sa[0], torch.float32))
        torch.cuda.synchronize()


def test_int8_decode_product_replays_at_other_group_sizes(dev, monkeypatch):
    """A decode step's int8 products captured in a CUDA graph (the
    grouped pair and a dense swap-AB product at 128 columns an item)
    replay with other group sizes and other rows written into the
    captured inputs, bit-equal to the plain version on those."""
    chosen = grouped_gemm.q8_plan
    monkeypatch.setattr(grouped_gemm, "q8_plan", lambda M, G, *a, **k: (
        grouped_gemm.Q8Plan(True, 32, 128) if G == 1 else chosen(M, G, *a, **k)))
    rng = np.random.default_rng(25)
    first = tuple(int(x) for x in rng.multinomial(128, [1 / 32] * 32))
    second = tuple(int(x) for x in rng.multinomial(128, [1 / 32] * 32))
    xq, a_scale, (wa, sa, wb, sb), gs = q8_inputs(rng, dev, first, 2880, 2880, torch.bfloat16, 2)
    dq, d_scale, (dw, dws), _ = q8_inputs(rng, dev, (32,), 4096, 4096, torch.bfloat16)

    def step():
        return (*ops.grouped_matmul_q8_pair(xq, a_scale, wa, sa, wb, sb, gs, torch.bfloat16),
                ops.matmul_q8(dq, d_scale, dw[0], dws[0], torch.bfloat16))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    xn, an, _, gn = q8_inputs(rng, dev, second, 2880, 2880, torch.bfloat16)
    xq.copy_(xn)
    a_scale.copy_(an)
    gs.copy_(gn)
    dn, dsn, _, _ = q8_inputs(rng, dev, (32,), 4096, 16, torch.bfloat16)
    dq.copy_(dn)
    d_scale.copy_(dsn)
    graph.replay()
    torch.cuda.synchronize()
    want = ops.grouped_matmul_q8_pair_plain(xq, a_scale, wa, sa, wb, sb, gs, torch.bfloat16)
    assert torch.equal(outs[0], want[0]) and torch.equal(outs[1], want[1])
    assert torch.equal(outs[2], ops.matmul_q8_plain(dq, d_scale, dw[0], dws[0], torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M,K", [(1, 16), (5, 4096), (300, 2880), (33, 14336)])
def test_quantize_rows_kernel_is_bit_equal_to_plain(dev, dtype, M, K):
    """``quantize_rows``: the amax, the IEEE divides and round-half-even
    equal the plain version's; rows of zeros, ties and the clamp included."""
    rng = np.random.default_rng(23)
    x = rng.normal(size=(M, K)).astype(np.float32) * rng.uniform(1e-3, 1e2, size=(M, 1))
    x[0, :3] = [0.5, -0.5, 2.5]
    if M > 1:
        x[1] = 0.0
    x = torch.from_numpy(x.astype(np.float32)).to(dev, dtype)
    ops.reset_launch_counts()
    xq, s = ops.quantize_rows(x)
    wq, ws = ops.quantize_rows_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(xq, wq) and torch.equal(s, ws)
    assert ops.launch_counts()["quantize_rows"] == 1


# Every width a registry model gives the fused forms of quantize_rows: its
# hidden sizes (norms) and intermediate sizes (gated units).
FUSED_WIDTHS = (768, 1408, 1536, 2048, 2816, 2880, 3072, 4096, 5120, 6144, 7168, 8192, 10944,
                14336, 16384, 18432, 25600)
# The norm's rsqrt factor: the kernel's within a few f32 ulps of the plain
# chain's, whose sum of squares runs in another order.
RSTD_REL = 2.0**-21


def check_norm_quant(dev, dtype, x, d, b, w):
    """``add_rms_norm_quant`` against the plain chain: x_new bit-equal; the
    rsqrt factor within RSTD_REL; h bit-equal to the chain's arithmetic
    after its reduction, run with the kernel's factor (one f32 ulp of the
    factor can move bf16(x r) by one ulp, which the weight product can
    make two, so h is not held to one ulp of the plain h); (xq, a_scale)
    bit-equal to ``quantize_rows_plain`` of the kernel's h, and the same
    without h written."""
    M = x.shape[0]
    rk, rp = torch.empty(M, device=dev), torch.empty(M, device=dev)
    xk, hk, qk, sk = ops.add_rms_norm_quant(x, d, b, w, 1e-5, True, rk)
    xp, _, _, _ = ops.add_rms_norm_quant_plain(x, d, b, w, 1e-5, True, rp)
    _, none, q2, s2 = ops.add_rms_norm_quant(x, d, b, w, 1e-5)
    wq, ws = ops.quantize_rows_plain(hk)
    torch.cuda.synchronize()
    assert torch.equal(xk, xp) and (d is not None or xk is x)
    assert ((rk - rp).abs() / rp).max().item() <= RSTD_REL
    assert torch.equal(hk, (xk.float() * rk[:, None]).to(dtype) * w)
    assert torch.equal(qk, wq) and torch.equal(sk, ws)
    assert none is None and torch.equal(q2, qk) and torch.equal(s2, sk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M", [1, 32, 64, 1024])
def test_add_rms_norm_quant_kernel_meets_its_contract(dev, dtype, M):
    """At every registry width: the norm alone (a first layer), after the
    residual add, and after the add with a bias (gpt-oss's bo); a zero row
    among them."""
    rng = np.random.default_rng(26)
    for K in FUSED_WIDTHS:
        x, d = (torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev, dtype) for _ in range(2))
        d[0] = -x[0]
        b, w = (torch.from_numpy(rng.normal(size=(K,)).astype(np.float32)).to(dev, dtype) for _ in range(2))
        ops.reset_launch_counts()
        for delta, bias in ((None, None), (d, None), (d, b)):
            check_norm_quant(dev, dtype, x, delta, bias, w)
        assert ops.launch_counts()["add_rms_norm_quant"] == 6


def check_glu_quant(dtype, args, kind, limit, biases, ids):
    """``glu_quant`` against the plain chain: act within one ulp (TOL),
    (xq, a_scale) bit-equal to ``quantize_rows_plain`` of the kernel's act,
    and the same without act written."""
    qk, sk, ak = ops.glu_quant(*args, kind, limit, biases, ids, want_act=True)
    _, _, ap = ops.glu_quant_plain(*args, kind, limit, biases, ids, want_act=True)
    q2, s2, none = ops.glu_quant(*args, kind, limit, biases, ids)
    wq, ws = ops.quantize_rows_plain(ak)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(ak, ap, atol=atol, rtol=rtol)
    assert torch.equal(qk, wq) and torch.equal(sk, ws)
    assert none is None and torch.equal(q2, qk) and torch.equal(s2, sk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("M", [1, 32, 64, 1024])
def test_glu_quant_kernel_meets_its_contract(dev, dtype, M):
    """At every registry width: silu on the halves of one [M, 2F] product
    (views, rows 2F apart) and on two [M, F] tensors; silu and gpt-oss's
    clamped SwiGLU after the experts' biases picked by unsorted expert
    ids."""
    rng = np.random.default_rng(27)
    E = 32
    for Fw in FUSED_WIDTHS:
        gu = torch.from_numpy(rng.normal(size=(M, 2 * Fw)).astype(np.float32) * 4).to(dev, dtype)
        gate, up = (torch.from_numpy(rng.normal(size=(M, Fw)).astype(np.float32) * 4).to(dev, dtype)
                    for _ in range(2))
        biases = tuple(torch.from_numpy(rng.normal(size=(E, Fw)).astype(np.float32)).to(dev, dtype)
                       for _ in range(2))
        ids = torch.from_numpy(rng.integers(0, E, size=M)).to(dev)
        assert M < 32 or not torch.equal(ids, ids.sort().values)
        ops.reset_launch_counts()
        check_glu_quant(dtype, (gu, None), "silu", 0.0, None, None)
        check_glu_quant(dtype, (gate, up), "silu", 0.0, None, None)
        check_glu_quant(dtype, (gate, up), "silu", 0.0, biases, ids)
        check_glu_quant(dtype, (gate, up), "swiglu_oss", 7.0, biases, ids)
        assert ops.launch_counts()["glu_quant"] == 8


def test_fused_quant_forms_replay_in_a_graph_at_other_row_counts(dev):
    """Both forms captured in CUDA graphs at 32 and at 64 rows (a decode
    program's batch), gpt-oss's biased SwiGLU included, replay with other
    rows and other expert ids written into the captured inputs, each
    output held to its contract on those."""
    rng = np.random.default_rng(28)
    K, Fw, E, dt = 2880, 2880, 32, torch.bfloat16

    def rand(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(dev, dt)

    for M in (32, 64):
        x, d, b, w = rand(M, K), rand(M, K), rand(K), rand(K)
        gate, up = rand(M, Fw, scale=4.0), rand(M, Fw, scale=4.0)
        biases = (rand(E, Fw), rand(E, Fw))
        ids = torch.from_numpy(rng.integers(0, E, size=M)).to(dev)
        rstd = torch.empty(M, device=dev)

        def step():
            return (*ops.add_rms_norm_quant(x, d, b, w, 1e-5, True, rstd),
                    *ops.glu_quant(gate, up, "swiglu_oss", 7.0, biases, ids, want_act=True))

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        ops.reset_launch_counts()
        with torch.cuda.graph(graph):
            xk, hk, qk, sk, gq, gs, act = step()
        for t, new in ((x, rand(M, K)), (d, rand(M, K)), (gate, rand(M, Fw, scale=4.0)),
                       (up, rand(M, Fw, scale=4.0))):
            t.copy_(new)
        ids.copy_(torch.from_numpy(rng.integers(0, E, size=M)))
        graph.replay()
        torch.cuda.synchronize()
        rp = torch.empty(M, device=dev)
        xp, _, _, _ = ops.add_rms_norm_quant_plain(x, d, b, w, 1e-5, True, rp)
        assert torch.equal(xk, xp) and ((rstd - rp).abs() / rp).max().item() <= RSTD_REL
        assert torch.equal(hk, (xk.float() * rstd[:, None]).to(dt) * w)
        assert torch.equal(qk, ops.quantize_rows_plain(hk)[0]) and torch.equal(sk, ops.quantize_rows_plain(hk)[1])
        _, _, ap = ops.glu_quant_plain(gate, up, "swiglu_oss", 7.0, biases, ids, want_act=True)
        torch.testing.assert_close(act, ap, atol=TOL[dt][0], rtol=TOL[dt][1])
        assert torch.equal(gq, ops.quantize_rows_plain(act)[0]) and torch.equal(gs, ops.quantize_rows_plain(act)[1])
        del graph


def test_fused_quant_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=dev)
    w = torch.ones(64, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.add_rms_norm_quant(x[:, :24].contiguous(), None, None, w[:24], 1e-5)
    with pytest.raises(ValueError, match="a bias needs a delta"):
        ops.add_rms_norm_quant(x, None, w, w, 1e-5)
    with pytest.raises(ValueError, match="weight must be"):
        ops.add_rms_norm_quant(x, x, None, w.float(), 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        ops.add_rms_norm_quant(torch.zeros((4, 128), dtype=torch.bfloat16, device=dev)[:, :64], None, None, w,
                               1e-5)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.glu_quant(torch.zeros((4, 72), dtype=torch.bfloat16, device=dev)[:, 4:68],
                      torch.zeros((4, 64), dtype=torch.bfloat16, device=dev))
    with pytest.raises(ValueError, match="expert id"):
        ops.glu_quant(x, x, "silu", 0.0, (x, x), None)
    with pytest.raises(ValueError, match="int64"):
        ops.glu_quant(x, x, "silu", 0.0, (x, x), torch.zeros(4, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="unknown gated unit"):
        ops.glu_quant(x, x, "gelu")
    with pytest.raises(ValueError, match="2F"):
        ops.glu_quant(torch.zeros((4, 63), dtype=torch.bfloat16, device=dev))


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from llmd_tpu_torch.ops import quant

    xq = torch.zeros((4, 24), dtype=torch.int8, device=dev)
    s = torch.ones(4, device=dev)
    w, ws = torch.zeros((1, 32, 24), dtype=torch.int8, device=dev), torch.ones((1, 32), device=dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        ops.grouped_matmul_q8(xq, s, w, ws, torch.tensor([4], dtype=torch.int32, device=dev),
                              torch.bfloat16)
    xq = torch.zeros((4, 32), dtype=torch.int8, device=dev)
    w = torch.zeros((2, 32, 32), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="one group"):
        grouped_gemm._check_q8(xq, s, (w,), (torch.ones((2, 32), device=dev),), None, torch.bfloat16)
    with pytest.raises(ValueError, match="int8"):
        ops.matmul_q8(xq, s, w[0].float(), ws[0], torch.bfloat16)
    # A [.., K, N] int8 weight (JAX's layout) is refused: the branch reads
    # K-major weights only.
    xq = torch.zeros((4, 256), dtype=torch.int8, device=dev)
    kn = torch.zeros((256, 128), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="K-major"):
        ops.matmul_q8(xq, s, kn, torch.ones(128, device=dev), torch.bfloat16)
    with pytest.raises(ValueError, match="K-major"):
        ops.grouped_matmul_q8(xq, s, kn[None], torch.ones((1, 128), device=dev),
                              torch.tensor([4], dtype=torch.int32, device=dev), torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):  # a K-major view of it
        ops.matmul_q8(xq, s, kn.mT, torch.ones(256, device=dev), torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        quant.quantize_rows(torch.zeros((2, 24), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        quant.quantize_rows(torch.zeros((2, 64), device=dev)[:, :32])


def latent_step(rng, page, kv_lens, L, Dl):
    """A decode batch over a latent pool [L, P, 1, page, Dl]: distinct pages
    per row, NaN at every position past a row's kv_len (a position that
    entered a sum would poison the row)."""
    kv_lens = np.asarray(kv_lens, np.int32)
    need = -(-kv_lens // page)
    max_pages = int(need.max()) + 1
    P = int(need.sum()) + 4
    perm = rng.permutation(P)
    pt = np.zeros((len(kv_lens), max_pages), np.int32)
    off = 0
    for b, n in enumerate(need):
        pt[b, :n] = perm[off : off + n]
        off += n
    pool = rng.normal(size=(L, P, 1, page, Dl)).astype(np.float32)
    clean = pool.copy()
    for b, n in enumerate(kv_lens):
        for i in range(n, max_pages * page):
            if i // page < need[b]:  # the live pages' dead tail
                pool[:, pt[b, i // page], 0, i % page] = np.nan
    return pt, kv_lens, pool, clean


# kv_len 1, page boundaries, partial last pages and pad rows.
LATENT_LENS = (1, 0, 16, 17, 300, 0, 1000, 33)


@pytest.mark.parametrize("spans", ["auto", 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize(
    "page,H,rank,Dl", [(16, 16, 512, 640), (8, 4, 32, 128), (32, 32, 128, 256), (16, 5, 64, 64)]
)
def test_mla_decode_kernel_matches_plain(dev, dtype, page, H, rank, Dl, spans, monkeypatch):
    """K5': within the f32 tolerance or one ulp of the plain version, pad
    rows exactly zero, NaN past kv_len never read; with each row in one
    block (no merge), in three spans, and in the wrapper's own choice."""
    from llmd_tpu_torch.ops import mla_decode

    if spans != "auto":
        monkeypatch.setattr(mla_decode, "spans_for", lambda *args: spans)
    rng = np.random.default_rng(8)
    L = 2
    pt, kv_lens, pool, clean = latent_step(rng, page, LATENT_LENS, L, Dl)
    B = len(kv_lens)
    q = torch.from_numpy(rng.normal(size=(B, 1, H, Dl)).astype(np.float32)).to(dev, dtype)
    pool = torch.from_numpy(pool).to(dev, dtype)
    clean = torch.from_numpy(clean).to(dev, dtype)
    pt, kv_lens = on(dev, pt, kv_lens)
    scale = (Dl // 2) ** -0.5
    ops.reset_launch_counts()
    got = ops.mla_decode_paged_attention_full(q, pool, 1, pt, kv_lens, rank, scale)
    want = ops.mla_decode_paged_attention_plain(q, clean, 1, pt, kv_lens, rank, scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, 1, H, rank)
    assert torch.isfinite(got).all()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert not got[kv_lens == 0].any()  # pad rows come out as zeros
    assert ops.launch_counts()["mla_decode_paged_attention_full"] == 1


@pytest.mark.parametrize("spans", ["auto", 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("page,H,rank,Dl", [(8, 20, 128, 256), (16, 64, 512, 640), (32, 128, 512, 640)])
def test_mla_decode_kernel_takes_any_head_count(dev, dtype, page, H, rank, Dl, spans, monkeypatch):
    """K5' at 20 heads (one padded group of 32), 64 (two groups) and
    deepseek-r1's 128 (four), pages of 8, 16 and 32, one span a row, at
    most three and the wrapper's choice, NaN past kv_len."""
    from llmd_tpu_torch.ops import mla_decode

    if spans != "auto":
        monkeypatch.setattr(mla_decode, "spans_for", lambda *args: spans)
    rng = np.random.default_rng(10)
    pt, kv_lens, pool, clean = latent_step(rng, page, LATENT_LENS, 2, Dl)
    B = len(kv_lens)
    q = torch.from_numpy(rng.normal(size=(B, 1, H, Dl)).astype(np.float32)).to(dev, dtype)
    pool = torch.from_numpy(pool).to(dev, dtype)
    clean = torch.from_numpy(clean).to(dev, dtype)
    pt, kv_lens = on(dev, pt, kv_lens)
    scale = (Dl // 2) ** -0.5
    got = ops.mla_decode_paged_attention_full(q, pool, 1, pt, kv_lens, rank, scale)
    want = ops.mla_decode_paged_attention_plain(q, clean, 1, pt, kv_lens, rank, scale)
    torch.cuda.synchronize()
    assert got.shape == (B, 1, H, rank) and torch.isfinite(got).all()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert not got[kv_lens == 0].any()


# K4''s latent form: (rank, rope, Dl, heads) of deepseek-v2-lite (16 heads),
# deepseek-r1 (128) and tiny-mla (rope halves of 4, a pad of 88).
LATENT_WRITES = ((512, 64, 640, 16), (512, 64, 640, 128), (32, 8, 128, 4))
MANTISSA = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}
# (start, width) rows of a bucketed Q > 1 step: pad tokens in live rows, a
# pad row (width 0, a garbage page table), a row across a page boundary.
LATENT_ROWS = ((0, 5), (37, 3), (100, 0), (14, 5), (60, 1))


def latent_write_inputs(rng, dev, dtype, rank, rope, Dl, nh, Q, page=16):
    """A step's addressing (Q == 1: a decode batch with pad rows; Q > 1:
    LATENT_ROWS), the pool, and the write's operands as the model
    passes them: kv_a a row-strided view, q_pe the rope heads of a q
    projection, q_eff_nope the absorption einsum's output."""
    from llmd_tpu_torch.models.common import rope_tables

    if Q == 1:
        pt, kv_lens, _, _, _, P = decode_step(rng, page, DECODE_LENS)
        positions = np.maximum(kv_lens - 1, 0)[:, None].astype(np.int32)
        live = (kv_lens > 0)[:, None]
        pt[kv_lens == 0] = 2**30  # pad rows: garbage targets
    else:
        B = len(LATENT_ROWS)
        need = [-(-(p0 + w) // page) for p0, w in LATENT_ROWS]
        max_pages, P = max(need) + 1, sum(need) + 8
        perm = rng.permutation(P)
        pt = np.zeros((B, max_pages), np.int32)
        positions = np.zeros((B, Q), np.int32)
        live = np.zeros((B, Q), bool)
        off = 0
        for b, ((p0, w), n) in enumerate(zip(LATENT_ROWS, need)):
            pt[b, :n] = perm[off : off + n] if w else 2**30
            off += n
            positions[b, :w] = np.arange(p0, p0 + w)
            positions[b, w:] = p0 + w - 1  # pad slots repeat the last
            live[b, :w] = True
    B = pt.shape[0]
    nope = 128

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev, dtype)

    pool = t(3, P, 1, page, Dl)
    kv_a = t(B, Q, rank + rope + 64, scale=3.0)[..., : rank + rope]
    q = t(B, Q, nh, nope + rope)
    q_eff_nope = torch.einsum("bqhn,hrn->bqhr", q[..., :nope], t(nh, rank, nope, scale=0.1))
    pt_d, pos_d, live_d = on(dev, pt, positions, live)
    cos, sin = rope_tables(pos_d, rope, 10000.0)
    return dict(pool=pool, kv_a=kv_a, w=1 + t(rank, scale=0.1), cos=cos, sin=sin,
                q_pe=q[..., nope:], q_eff_nope=q_eff_nope, addr=(pt_d, pos_d, live_d), live=live_d,
                page=page)


@pytest.mark.parametrize("Q", [1, 5])
@pytest.mark.parametrize("rank,rope,Dl,nh", LATENT_WRITES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_latent_write_kernel_meets_its_contract(dev, dtype, rank, rope, Dl, nh, Q):
    """``rope_write_latent_full`` against ``rope_write_latent_plain`` on the
    same inputs: q_eff (every row, pads too) and the stored rows' rope and
    pad parts bit-equal; c_kv bit-equal to the plain arithmetic run with
    the kernel's norm factor (``rstd``), that factor within RSTD_REL of the
    plain chain's and c_kv within two ulps of the plain chain's c_kv (f32:
    plus the factor's RSTD_REL, which is several f32 ulps); pad
    rows and pad tokens store nothing (the pool equals the plain version's
    everywhere else). One launch, counted in the ``latent`` branch."""
    rng = np.random.default_rng(27)
    x = latent_write_inputs(rng, dev, dtype, rank, rope, Dl, nh, Q)
    B = x["kv_a"].shape[0]
    args = (x["kv_a"], x["w"], 1e-6, x["cos"], x["sin"], x["q_pe"], x["q_eff_nope"], *x["addr"])
    pk, pp = x["pool"].clone(), x["pool"].clone()
    rk, rp = torch.empty(B * Q, device=dev), torch.empty(B * Q, device=dev)
    ops.reset_launch_counts()
    qk = ops.rope_write_latent_full(pk, 1, *args, rstd=rk)
    counts, branches = ops.launch_counts(), ops.branch_launch_counts()
    qp = ops.rope_write_latent_plain(pp, 1, *args, rstd=rp)
    torch.cuda.synchronize()
    assert counts["write_kv_pages_decode_full"] == 1
    assert branches == {"write_kv_pages_decode_full[latent]": 1}
    assert qk.shape == (B, Q, nh, Dl) and torch.equal(qk, qp)
    assert ((rk - rp).abs() / rp).max().item() <= RSTD_REL
    # The live tokens' targets, and c_kv from the kernel's factor.
    pt, pos, live = x["addr"]
    pos = pos.long()
    phys = torch.gather(pt.long().clamp(0, pk.shape[1] - 1), 1, pos // x["page"])[live]
    slot = (pos % x["page"])[live]
    xc = x["kv_a"][..., :rank].float()
    exact = (xc * rk.view(B, Q, 1)).to(dtype) * x["w"]
    want = pp.clone()
    want[1, phys, 0, slot, :rank] = exact[live]
    assert torch.equal(pk, want)
    got, chain = pk[1, phys, 0, slot, :rank].double(), pp[1, phys, 0, slot, :rank].double()
    ulp = torch.exp2(torch.floor(torch.log2(chain.abs().clamp(min=2.0**-100))) - MANTISSA[dtype])
    # Two ulps of the type, and in f32 the factor's own distance on top.
    assert ((got - chain).abs() <= 2 * ulp + RSTD_REL * chain.abs()).all()


def test_latent_write_refuses_what_the_kernel_does_not_take(dev):
    rng = np.random.default_rng(28)
    x = latent_write_inputs(rng, dev, torch.bfloat16, 512, 64, 640, 16, 5)
    args = [x["kv_a"], x["w"], 1e-6, x["cos"], x["sin"], x["q_pe"], x["q_eff_nope"], *x["addr"]]
    with pytest.raises(ValueError, match="int8"):
        ops.rope_write_latent_full(x["pool"].to(torch.int8), 1, *args)
    with pytest.raises(ValueError, match="positions"):
        ops.rope_write_latent_full(x["pool"], 1, *args[:8], args[8].long(), args[9])
    with pytest.raises(ValueError, match="valid"):
        ops.rope_write_latent_full(x["pool"], 1, *args[:9], args[9].int())
    shifted = torch.zeros((5, 5, 578), dtype=torch.bfloat16, device=dev)[..., 1:577]
    with pytest.raises(ValueError, match="aligned"):  # rows 2 bytes off 16
        ops.rope_write_latent_full(x["pool"], 1, shifted, *args[1:])


def test_moe_and_mla_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((10, 64), device=dev, dtype=torch.bfloat16)
    w = torch.zeros((2, 64, 64), device=dev, dtype=torch.bfloat16)
    gs = torch.tensor([4, 6], device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ops.grouped_matmul(x, w, gs.long())
    with pytest.raises(ValueError, match="dtype"):
        ops.grouped_matmul(x.float(), w, gs)
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.grouped_matmul(x[:, :60].contiguous(), w[:, :60].contiguous(), gs)
    with pytest.raises(ValueError, match="is on cpu"):
        ops.grouped_matmul(x, w, gs.cpu())
    pool = torch.zeros((2, 8, 1, 16, 640), device=dev, dtype=torch.bfloat16)
    q = torch.zeros((3, 1, 16, 640), device=dev, dtype=torch.bfloat16)
    pt = torch.zeros((3, 4), device=dev, dtype=torch.int32)
    lens = torch.ones((3,), device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ops.mla_decode_paged_attention_full(q, pool, 0, pt, lens.long(), 512, 0.1)
    with pytest.raises(ValueError, match="multiples of 32"):
        ops.mla_decode_paged_attention_full(q, pool, 0, pt, lens, 500, 0.1)
    with pytest.raises(ValueError, match="layer"):
        ops.mla_decode_paged_attention_full(q, pool, 2, pt, lens, 512, 0.1)
    with pytest.raises(ValueError, match="does not fit"):
        ops.mla_decode_paged_attention_full(q[..., :512], pool, 0, pt, lens, 512, 0.1)


def log_forwards(monkeypatch, runner) -> list[int]:
    """Log the Q of every forward that Python runs, except while a program
    is prepared (its runs on zero inputs are set-up, and its capture runs
    nothing); a program's replays are counted by ``program_forwards``."""
    from llmd_tpu_torch.engine import runner as runner_mod

    forwards, preparing = [], []
    forward = runner_mod.llama.forward_hidden
    prepare = runner.programs.prepare

    def logged(p, cache, inp, c, *swa):
        if not preparing:
            forwards.append(inp.token_ids.shape[1])
        return forward(p, cache, inp, c, *swa)

    def quiet_prepare(key):
        preparing.append(key)
        try:
            return prepare(key)
        finally:
            preparing.pop()

    monkeypatch.setattr(runner_mod.llama, "forward_hidden", logged)
    monkeypatch.setattr(runner.programs, "prepare", quiet_prepare)
    return forwards


def program_forwards(runner) -> list[int]:
    """The Q of the forwards the programs ran: K one-token forwards a
    decode window, one flat forward ([T, 1]) a flat step."""
    return [1] * sum(n * (key[2] if key[0] == "window" else 1)
                     for key, n in runner.programs.runs.items())


# DeepSeek's yarn: cos/sin scaled by mscale / mscale_all_dim, and the
# softmax scale that K5' takes multiplied by mscale_all_dim's mscale².
MLA_YARN = {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 64,
            "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}


@pytest.mark.parametrize("model,layout", [
    ("tiny-moe", "flat"), ("tiny-moe", "window"), ("tiny-mla", "flat"), ("tiny-mla", "window"),
    ("tiny-mla-yarn", "window"),
])
def test_moe_mla_engine_on_the_card_matches_the_cpu_engine(dev, model, layout, monkeypatch):
    """tiny-moe and tiny-mla (f32; tiny-mla-yarn: tiny-mla with DeepSeek's
    yarn, ``mscale_all_dim`` in K5''s ``sm_scale``): the card's streams
    equal the CPU's. Every forward is logged with its Q: K6' launches twice
    a MoE layer a forward (the gate|up pair and the down call), K5' once a
    layer a Q = 1 forward of the MLA model (which takes the bucketed
    unified step where the layout asks for the flat one) and K4''s latent
    form once a layer a forward at any Q. Decode-only steps
    are graph replays: their forwards are counted from the programs'
    runs."""
    from llmd_tpu_torch.models.registry import get_model_config

    torch.backends.cuda.matmul.allow_tf32 = False
    # The GQA kernels take head_dim 64, 128 or 256 (tiny-moe's is 16).
    if model == "tiny-mla-yarn":
        mcfg = get_model_config("tiny-mla", rope_scaling=MLA_YARN)
    else:
        mcfg = get_model_config(model, **({} if model == "tiny-mla" else {"head_dim": 64}))
    cfg = EngineConfig(
        model=mcfg,
        cache=CacheConfig(page_size=8, num_blocks=64, dtype="float32"),
        scheduler=SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=32, **LAYOUTS[layout]),
    )
    params = llama.init_params(mcfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (5, 40, 17, 70)]
    sps = [SamplingParams(temperature=t, max_tokens=12, ignore_eos=True, seed=9)
           for t in (0.0, 0.8, 0.0, 0.8)]
    cpu = LLMEngine(cfg, params=params, device="cpu").generate(prompts, sps)
    gpu_engine = LLMEngine(cfg, params=params, device="cuda")
    forwards = log_forwards(monkeypatch, gpu_engine.runner)
    ops.reset_launch_counts()
    gpu = gpu_engine.generate(prompts, sps)
    forwards += program_forwards(gpu_engine.runner)
    assert list(gpu.values()) == list(cpu.values())
    counts = ops.launch_counts()
    L, n_moe = mcfg.num_layers, mcfg.num_layers - mcfg.first_dense_layers
    assert counts["grouped_matmul_pair"] == counts["grouped_matmul"] == n_moe * len(forwards) > 0
    if mcfg.is_mla:
        assert not gpu_engine.runner.flat
        assert counts["mla_decode_paged_attention_full"] == L * forwards.count(1) > 0
        # K4''s latent form writes every forward's latent rows, at any Q.
        assert counts["write_kv_pages_decode_full"] == L * len(forwards)
        assert ops.branch_launch_counts() == {"write_kv_pages_decode_full[latent]": L * len(forwards)}
        assert counts["flat_paged_attention_full"] == counts["decode_paged_attention_full"] == 0


def clone_pool(pool):
    return tuple(t.clone() for t in pool) if isinstance(pool, tuple) else pool.clone()


def pool_parts(pool):
    return pool if isinstance(pool, tuple) else (pool,)


# name -> (registry model, overrides, KV pool dtype)
GRAPH_MODELS = {
    "tiny": ("tiny", dict(head_dim=64, num_layers=3, dtype="bfloat16"), "bfloat16"),
    "tiny-int8": ("tiny", dict(head_dim=64, num_layers=3, dtype="bfloat16"), "int8"),
    "tiny-moe": ("tiny-moe", dict(head_dim=64, dtype="bfloat16"), "bfloat16"),
    "tiny-mla": ("tiny-mla", dict(dtype="bfloat16"), "bfloat16"),
}


@pytest.mark.parametrize("model,layout", [
    ("tiny", "flat"), ("tiny", "window"), ("tiny-int8", "flat_window"),
    ("tiny-moe", "flat_window"), ("tiny-mla", "window"),
])
def test_a_replay_equals_the_eager_body(dev, model, layout):
    """bf16 on the card: every decode-only step is a graph replay. At each
    key's first replay, its body first runs eagerly on the same static
    inputs from the pool as it was, then the pool is put back and the graph
    replays: tokens, logprobs and pool bytes equal. A replay adds its
    capture's launches: each kernel once a layer a forward (K4' and K3', or
    K5', K iterations of a window; K2' and K1' once a flat step; K6' twice
    a MoE layer a forward). ``warmup`` captured the default keys and left
    the pool as it was."""
    from llmd_tpu_torch.models.registry import get_model_config

    name, over, kv_dtype = GRAPH_MODELS[model]
    mcfg = get_model_config(name, **over)
    cfg = EngineConfig(
        model=mcfg,
        cache=CacheConfig(page_size=8, num_blocks=64, dtype=kv_dtype),
        scheduler=SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=32, **LAYOUTS[layout]),
    )
    eng = LLMEngine(cfg, device="cuda")
    for t in pool_parts(eng.runner.kv_cache):
        t.copy_(torch.randint(-100, 100, t.shape, device=dev).to(t.dtype))
    before = clone_pool(eng.runner.kv_cache)
    assert eng.warmup() == len(eng.runner.warm_keys()) > 0
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(pool_parts(eng.runner.kv_cache), pool_parts(before)))
    progs, pool = eng.runner.programs, eng.runner.kv_cache
    replay, checked = progs.replay, {}

    def checked_replay(key, arrays):
        if key in checked:
            return replay(key, arrays)
        saved, state = clone_pool(pool), ops.launch_state()
        want = progs.eager(key, arrays).clone()
        want_pool = clone_pool(pool)
        ops.set_launch_state(state)
        for t, s in zip(pool_parts(pool), pool_parts(saved)):
            t.copy_(s)
        got = replay(key, arrays)
        delta = ops.launch_delta(ops.launch_state(), state)
        torch.cuda.synchronize()
        checked[key] = (torch.equal(got, want),
                        all(torch.equal(a, b) for a, b in zip(pool_parts(pool), pool_parts(want_pool))),
                        {fn.__name__: n for fn, (n, _) in delta.items() if n})
        return got

    progs.replay = checked_replay
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (5, 40, 17)]
    for sp in (SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True),
               SamplingParams(temperature=0.8, max_tokens=12, ignore_eos=True, seed=9)):
        eng.generate(prompts, sp)
    assert {g for _, *_, g in checked} == {True, False}
    L = mcfg.num_layers
    n_moe = L - mcfg.first_dense_layers if mcfg.is_moe else 0
    for key, (tokens_equal, pool_equal, launches) in checked.items():
        assert tokens_equal and pool_equal, key
        n = key[2] if key[0] == "window" else 1
        if key[0] == "flat":
            want = {"write_kv_pages_flat_full": L, "flat_paged_attention_full": L}
        elif mcfg.is_mla:
            want = {"write_kv_pages_decode_full": L * n, "mla_decode_paged_attention_full": L * n}
        else:
            want = {"write_kv_pages_decode_full": L * n, "decode_paged_attention_full": L * n}
        if n_moe:
            want.update(grouped_matmul_pair=n_moe * n, grouped_matmul=n_moe * n)
        assert launches == want, key


# --------------------------------------------------------------------- #
# The window, sink and int8 branches of K1'-K4'

# name -> (sliding window, sinks, int8 pool)
BRANCHES = {
    "window": (40, False, False),
    "sinks": (0, True, False),
    "int8": (0, False, True),
    "int8+window+sinks": (40, True, True),
}


def branch_pool(rng, dev, dtype, L, P, K, page, D, int8):
    """A float pool in ``dtype``, or (int8 data, f32 scales on the f16
    grid); with them the sinks' inputs."""
    if not int8:
        pool = torch.from_numpy(rng.normal(size=(L, P, K, page, 2 * D)).astype(np.float32))
        return pool.to(dev, dtype), None
    data = torch.from_numpy(rng.integers(-127, 128, size=(L, P, K, page, 2 * D)).astype(np.int8))
    scales = rng.uniform(0.004, 0.016, size=(L, P, K, page, 2)).astype(np.float16)
    return data.to(dev), torch.from_numpy(scales.astype(np.float32)).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("page,D,K,G", [(16, 64, 8, 8), (16, 128, 8, 4), (8, 64, 2, 1), (32, 128, 4, 2)])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_flat_attention_branches_match_plain(dev, branch, page, D, K, G, dtype):
    rng = np.random.default_rng(21)
    window, with_sinks, int8 = BRANCHES[branch]
    pt, rows, _, kv_lens, total, P = flat_step(rng, page)
    T = len(rows)
    pool, scales = branch_pool(rng, dev, dtype, 2, P, K, page, D, int8)
    q = torch.from_numpy(rng.normal(size=(T, 1, K * G, D))).to(dev, dtype)
    sinks = torch.from_numpy(rng.normal(size=(K * G,)).astype(np.float32)).to(dev) if with_sinks else None
    pt, rows, kv_lens = on(dev, pt, rows, kv_lens)
    ops.reset_launch_counts()
    args = (q, pool, 1, rows, pt, kv_lens, None, window, sinks, scales)
    got = ops.flat_paged_attention_full(*args)
    want = ops.flat_paged_attention_plain(*args)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got[:total].float(), want[:total].float(), atol=atol, rtol=rtol)
    assert not got[total:].any()
    key = ops.ragged_paged_attention.branch_key(window, sinks, scales)
    assert key == branch
    assert ops.branch_launch_counts() == {f"flat_paged_attention_full[{key}]": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("page,D,K,G", [(16, 64, 8, 8), (16, 128, 8, 4), (8, 64, 2, 1), (32, 128, 4, 2)])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_decode_attention_branches_match_plain(dev, branch, page, D, K, G, dtype):
    """Rows shorter and longer than the window, and pad rows, which come
    out as zeros with sinks too."""
    rng = np.random.default_rng(22)
    window, with_sinks, int8 = BRANCHES[branch]
    pt, kv_lens, _, _, _, P = decode_step(rng, page, DECODE_LENS)
    B = len(kv_lens)
    pool, scales = branch_pool(rng, dev, dtype, 2, P, K, page, D, int8)
    q = torch.from_numpy(rng.normal(size=(B, 1, K * G, D))).to(dev, dtype)
    sinks = torch.from_numpy(rng.normal(size=(K * G,)).astype(np.float32)).to(dev) if with_sinks else None
    pt, kv_lens = on(dev, pt, kv_lens)
    ops.reset_launch_counts()
    kw = dict(window=window, sinks=sinks, scales=scales)
    got = ops.decode_paged_attention_full(q, pool, 1, pt, kv_lens, **kw)
    want = ops.decode_paged_attention_plain(q, pool, 1, pt, kv_lens, **kw)
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert not got[kv_lens == 0].any()
    key = ops.ragged_paged_attention.branch_key(window, sinks, scales)
    assert ops.branch_launch_counts() == {f"decode_paged_attention_full[{key}]": 1}


def test_branches_never_read_dead_positions(dev):
    """Positions before the window and past kv_len hold NaN data and an
    f16-overflow inf scale: the kernels read neither (pages wholly before
    the window are not fetched), so the result is finite and equals the
    plain version on a clean pool."""
    rng = np.random.default_rng(23)
    page, D, K, G, window = 16, 64, 8, 8, 40
    pt, kv_lens, _, _, _, P = decode_step(rng, page, DECODE_LENS)
    B = len(kv_lens)
    sinks = torch.from_numpy(rng.normal(size=(K * G,)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.normal(size=(B, 1, K * G, D)).astype(np.float32)).to(dev)
    for int8 in (False, True):
        pool, scales = branch_pool(rng, dev, torch.float32, 1, P, K, page, D, int8)
        dirty_pool, dirty_scales = pool.clone(), None if scales is None else scales.clone()
        for b, n in enumerate(kv_lens):
            for i in [*range(max(int(n) - window, 0)), *range(n, pt.shape[1] * page)]:
                if int8:
                    dirty_scales[:, pt[b, i // page], :, i % page] = float("inf")
                else:
                    dirty_pool[:, pt[b, i // page], :, i % page] = float("nan")
        tpt, tkv = on(dev, pt, kv_lens)
        got = ops.decode_paged_attention_full(q, dirty_pool, 0, tpt, tkv, None, window, sinks, dirty_scales)
        want = ops.decode_paged_attention_plain(q, pool, 0, tpt, tkv, None, None, window, sinks, scales)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def edge_rows(x):
    """Row 0 all zeros; row 1 so large that amax / 127 overflows f16."""
    x = x.clone()
    x[0] = 0.0
    x[1] = torch.where(x[1] >= 0, 1e7, -1e7)
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("page,D,K", [(16, 128, 8), (16, 64, 8), (8, 256, 1)])
def test_int8_writes_are_bit_exact(dev, dtype, page, D, K):
    """K2' and K4' on an int8 pool store ``quantize_kv_rows``'s bytes and
    scales exactly, the all-zero and the f16-overflow rows included; pad
    rows write nothing."""
    rng = np.random.default_rng(24)
    L = 3
    pt, rows, positions, _, total, P = flat_step(rng, page)
    T = len(rows)
    data = torch.from_numpy(rng.integers(-127, 128, size=(L, P, K, page, 2 * D)).astype(np.int8)).to(dev)
    scales = torch.ones((L, P, K, page, 2), device=dev)
    # (In f16 the overflow row's 1e7 is inf: scale inf, data 0 as well.)
    k = edge_rows(torch.from_numpy(rng.normal(size=(T, 1, K, D)).astype(np.float32))).to(dev, dtype)
    v = edge_rows(torch.from_numpy(rng.normal(size=(T, 1, K, D)).astype(np.float32) * 4)).to(dev, dtype)
    pt, rows, positions = on(dev, pt, rows, positions)
    ref = (data.clone(), scales.clone())
    ops.reset_launch_counts()
    ops.write_kv_pages_flat_full(data, 1, k, v, pt, rows, positions, live(total, dev), scales)
    ops.write_kv_pages_flat_plain(ref[0], 1, k, v, pt, rows, positions, live(total, dev), ref[1])
    torch.cuda.synchronize()
    assert torch.equal(data, ref[0]) and torch.equal(scales, ref[1])
    assert ops.branch_launch_counts() == {"write_kv_pages_flat_full[int8]": 1}
    # The decode write, with pad rows whose targets are garbage.
    pt2, kv_lens, phys, offset, valid, P2 = decode_step(rng, page, DECODE_LENS)
    B = len(kv_lens)
    data2 = torch.zeros((L, P2, K, page, 2 * D), dtype=torch.int8, device=dev)
    scales2 = torch.ones((L, P2, K, page, 2), device=dev)
    kv_new = edge_rows(torch.from_numpy(rng.normal(size=(B, K, 2 * D)).astype(np.float32))).to(dev, dtype)
    phys, offset, valid = on(dev, phys, offset, valid)
    ref2 = (data2.clone(), scales2.clone())
    ops.write_kv_pages_decode_full(data2, kv_new, 2, phys, offset, valid, scales2)
    ops.write_kv_pages_decode_plain(ref2[0], kv_new, 2, phys, offset, valid, ref2[1])
    torch.cuda.synchronize()
    assert torch.equal(data2, ref2[0]) and torch.equal(scales2, ref2[1])
    assert ops.branch_launch_counts() == {"write_kv_pages_flat_full[int8]": 1,
                                          "write_kv_pages_decode_full[int8]": 1}


def test_int8_and_sink_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(25)
    pt, rows, positions, kv_lens, total, P = flat_step(rng, 16)
    T = len(rows)
    data = torch.zeros((2, P, 2, 16, 128), device=dev, dtype=torch.int8)
    scales = torch.ones((2, P, 2, 16, 2), device=dev)
    q = torch.zeros((T, 1, 4, 64), device=dev, dtype=torch.bfloat16)
    k = torch.zeros((T, 1, 2, 64), device=dev, dtype=torch.bfloat16)
    pt, rows, positions, kv_lens = on(dev, pt, rows, positions, kv_lens)
    with pytest.raises(ValueError, match="scales"):
        ops.flat_paged_attention_full(q, data, 0, rows, pt, kv_lens)
    with pytest.raises(ValueError, match="scales"):
        ops.flat_paged_attention_full(q, data, 0, rows, pt, kv_lens, scales=scales.half())
    with pytest.raises(ValueError, match="sinks"):
        ops.flat_paged_attention_full(q, data, 0, rows, pt, kv_lens, scales=scales,
                                      sinks=torch.zeros(4, device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="sinks"):
        ops.flat_paged_attention_full(q, data, 0, rows, pt, kv_lens, scales=scales,
                                      sinks=torch.zeros(3, device=dev))
    with pytest.raises(ValueError, match="int8"):
        ops.write_kv_pages_flat_full(data.float(), 0, k, k, pt, rows, positions, live(total, dev), scales)
    with pytest.raises(ValueError, match="float rows"):
        ops.write_kv_pages_flat_full(data, 0, k.to(torch.int8), k.to(torch.int8), pt, rows,
                                     positions, live(total, dev), scales)


OSS_TINY = dict(
    name="tiny-oss", head_dim=64, num_layers=2, sliding_window=24,
    layer_types=("sliding_attention", "full_attention"),
    attention_bias=True, attention_out_bias=True, attention_sinks=True,
    rope_scaling={"rope_type": "yarn", "factor": 4.0, "beta_fast": 32.0,
                  "beta_slow": 1.0, "original_max_position_embeddings": 32},
    num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64,
    moe_activation="swiglu_oss", router_logit_bias=True,
)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("layout", ["flat", "window", "bucketed"])
def test_oss_engine_on_the_card_matches_the_cpu_engine(dev, layout, kv_dtype):
    """A tiny gpt-oss model (windows, sinks, biases, yarn, biased experts;
    f32, seeded random biases) on a float and an int8 pool: the card's
    greedy and seeded streams equal the CPU's, every launch of the
    attention kernels took the sink branch, half of them the window one,
    and every KV write the fused form with the biases."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mcfg = tiny_model_config(**OSS_TINY)
    cfg = EngineConfig(
        model=mcfg,
        cache=CacheConfig(page_size=8, num_blocks=64, dtype=kv_dtype),
        scheduler=SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=32, **LAYOUTS[layout]),
    )
    params = llama.init_params(mcfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    for name in ("bq", "bk", "bv", "bo", "router_bias", "we_gate_b", "we_up_b", "we_down_b"):
        w = params["layers"][name]
        params["layers"][name] = 0.1 * torch.randn(w.shape, generator=gen, dtype=w.dtype)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (5, 40, 17, 70)]
    sps = [SamplingParams(temperature=t, max_tokens=12, ignore_eos=True, seed=9)
           for t in (0.0, 0.8, 0.0, 0.8)]
    cpu = LLMEngine(cfg, params=params, device="cpu").generate(prompts, sps)
    gpu_engine = LLMEngine(cfg, params=params, device="cuda")
    ops.reset_launch_counts()
    gpu = gpu_engine.generate(prompts, sps)
    assert list(gpu.values()) == list(cpu.values())
    counts, branches = ops.launch_counts(), ops.branch_launch_counts()
    q8 = "int8+" if kv_dtype == "int8" else ""
    for fn in ("flat_paged_attention_full", "decode_paged_attention_full"):
        # The sliding layer takes window + sinks, the full one sinks.
        n = counts[fn] // 2
        assert branches.get(f"{fn}[{q8}window+sinks]", 0) == branches.get(f"{fn}[{q8}sinks]", 0) == n
    # Every write took the fused form, with the model's q|k|v biases.
    key = ops.write_branch(kv_dtype == "int8", rope=True, bias=True)
    for fn in ("write_kv_pages_flat_full", "write_kv_pages_decode_full"):
        assert branches.get(f"{fn}[{key}]", 0) == counts[fn]
    assert counts["grouped_matmul"] == counts["grouped_matmul_pair"] > 0
    assert counts["flat_paged_attention_full"] + counts["decode_paged_attention_full"] > 0


# --------------------------------------------------------------------- #
# The fused form of K2' and K4': q|k|v bias, rope and the store in one launch

# name -> (rope_scaling, theta)
ROPES = {
    "default": (None, 10000.0),
    "llama3": ({"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}, 500000.0),
    "yarn": ({"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0, "beta_slow": 1.0,
              "original_max_position_embeddings": 4096}, 150000.0),
}


def qkv_rows(rng, dev, dtype, N, Nq, K, D, strided):
    """q [N, Nq, D] and k, v [N, K, D]: views of one [N, (Nq + 2K) D]
    projection output (``strided``), or contiguous tensors (a QK-normed
    model's)."""
    x = torch.from_numpy(rng.normal(size=(N, (Nq + 2 * K) * D)).astype(np.float32)).to(dev, dtype)
    q = x[:, : Nq * D].view(N, Nq, D)
    k = x[:, Nq * D : (Nq + K) * D].view(N, K, D)
    v = x[:, (Nq + K) * D :].view(N, K, D)
    return (q, k, v) if strided else tuple(t.contiguous() for t in (q, k, v))


def qkv_bias(rng, dev, dtype, Nq, K, D):
    return tuple(torch.from_numpy(0.3 * rng.normal(size=(n * D,)).astype(np.float32)).to(dev, dtype)
                 for n in (Nq, K, K))


def rope_rows(positions, D, rope):
    from llmd_tpu_torch.models.common import rope_tables

    scaling, theta = ROPES[rope]
    return rope_tables(positions, D, theta, scaling)


def fused_pool(rng, dev, dtype, L, P, K, page, D, int8):
    """A random float pool in ``dtype``, or (int8 data, f32 scales on the
    f16 grid)."""
    if not int8:
        return torch.from_numpy(rng.normal(size=(L, P, K, page, 2 * D)).astype(np.float32)).to(dev, dtype), None
    data = torch.from_numpy(rng.integers(-127, 128, size=(L, P, K, page, 2 * D)).astype(np.int8)).to(dev)
    scales = rng.uniform(0.004, 0.016, size=(L, P, K, page, 2)).astype(np.float16)
    return data, torch.from_numpy(scales.astype(np.float32)).to(dev)


def same_pool(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)


# (dtype, D, K, G, page, rope): every dtype and head_dim, GQA groups of 1-8,
# one head, and each rope table.
FUSED_CASES = [
    (torch.bfloat16, 128, 8, 4, 16, "llama3"),
    (torch.bfloat16, 64, 8, 8, 16, "yarn"),
    (torch.float16, 128, 2, 2, 8, "default"),
    (torch.float32, 64, 2, 1, 16, "yarn"),
    (torch.float32, 256, 1, 8, 32, "default"),
    (torch.bfloat16, 256, 2, 4, 8, "llama3"),
]


@pytest.mark.parametrize("strided", [True, False], ids=["views", "contiguous"])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("int8", [False, True], ids=["float_pool", "int8_pool"])
@pytest.mark.parametrize("dtype,D,K,G,page,rope", FUSED_CASES)
def test_fused_flat_write_equals_plain(dev, dtype, D, K, G, page, rope, int8, bias, strided):
    """K2's fused form against its plain version (bias, ``apply_rope``,
    the plain store), bit for bit: the rotated q of every token (pads
    too), the pool's bytes and the int8 pool's scales (pads store
    nothing). Its launch counts under K2' in its own branch."""
    rng = np.random.default_rng(31)
    L, Nq = 3, K * G
    pt, rows, positions, _, total, P = flat_step(rng, page)
    T = len(rows)
    pool = fused_pool(rng, dev, dtype, L, P, K, page, D, int8)
    ref = tuple(None if t is None else t.clone() for t in pool)
    q, k, v = qkv_rows(rng, dev, dtype, T, Nq, K, D, strided)
    b = qkv_bias(rng, dev, dtype, Nq, K, D) if bias else None
    pt, rows, positions = on(dev, pt, rows, positions)
    cos, sin = rope_rows(positions, D, rope)
    ops.reset_launch_counts()
    got = ops.rope_write_kv_flat_full(pool[0], 1, q, k, v, cos, sin, pt, rows, positions,
                                      live(total, dev), b, pool[1])
    want = ops.rope_write_kv_flat_plain(ref[0], 1, q, k, v, cos, sin, pt, rows, positions,
                                        live(total, dev), b, ref[1])
    torch.cuda.synchronize()
    assert got.shape == (T, Nq, D) and got.is_contiguous() and got.dtype == dtype
    assert torch.equal(got, want)
    assert same_pool(pool, ref)
    key = ops.write_branch(int8, rope=True, bias=bias)
    assert ops.branch_launch_counts() == {f"write_kv_pages_flat_full[{key}]": 1}


@pytest.mark.parametrize("strided", [True, False], ids=["views", "contiguous"])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("int8", [False, True], ids=["float_pool", "int8_pool"])
@pytest.mark.parametrize("dtype,D,K,G,page,rope", FUSED_CASES)
def test_fused_decode_write_equals_plain(dev, dtype, D, K, G, page, rope, int8, bias, strided):
    """K4's fused form against its plain version, bit for bit: every row's
    rotated q, the pool's bytes and scales; pad rows (valid == 0, a garbage
    page) store nothing."""
    rng = np.random.default_rng(32)
    L, Nq = 3, K * G
    pt, kv_lens, phys, offset, valid, P = decode_step(rng, page, DECODE_LENS)
    B = len(kv_lens)
    pool = fused_pool(rng, dev, dtype, L, P, K, page, D, int8)
    ref = tuple(None if t is None else t.clone() for t in pool)
    q, k, v = qkv_rows(rng, dev, dtype, B, Nq, K, D, strided)
    b = qkv_bias(rng, dev, dtype, Nq, K, D) if bias else None
    phys, offset, valid, positions = on(dev, phys, offset, valid, np.maximum(kv_lens - 1, 0))
    cos, sin = rope_rows(positions, D, rope)
    ops.reset_launch_counts()
    got = ops.rope_write_kv_decode_full(pool[0], 2, q, k, v, cos, sin, phys, offset, valid, b, pool[1])
    want = ops.rope_write_kv_decode_plain(ref[0], 2, q, k, v, cos, sin, phys, offset, valid, b, ref[1])
    torch.cuda.synchronize()
    assert got.shape == (B, Nq, D) and torch.equal(got, want)
    assert same_pool(pool, ref)
    key = ops.write_branch(int8, rope=True, bias=bias)
    assert ops.branch_launch_counts() == {f"write_kv_pages_decode_full[{key}]": 1}


@pytest.mark.parametrize("int8", [False, True], ids=["float_pool", "int8_pool"])
@pytest.mark.parametrize("kind", ["flat", "decode"])
def test_fused_write_in_a_graph_replays_at_another_live_count(dev, kind, int8):
    """The fused write captured in a CUDA graph at one live count (flat: the
    device-side num_live; decode: the rows' valid flags) and replayed, with
    new inputs copied into the captured tensors, at two others: each replay
    equals the plain version run at that count, bit for bit."""
    rng = np.random.default_rng(33)
    dtype, L, K, G, D, page = torch.bfloat16, 2, 2, 4, 128, 16
    Nq = K * G
    if kind == "flat":
        pt, rows, positions, _, total, P = flat_step(rng, page)
        N = len(rows)
        pt, rows, positions = on(dev, pt, rows, positions)
        count = live(total, dev)
        addr = (pt, rows, positions, count)
        kernel, plain = ops.rope_write_kv_flat_full, ops.rope_write_kv_flat_plain
        counts = (total, 3, total - 5)
    else:
        pt, kv_lens, phys, offset, valid, P = decode_step(rng, page, DECODE_LENS)
        N = len(kv_lens)
        positions, phys, offset, count = on(dev, np.maximum(kv_lens - 1, 0), phys, offset, valid)
        addr = (phys, offset, count)
        kernel, plain = ops.rope_write_kv_decode_full, ops.rope_write_kv_decode_plain
        counts = tuple(on(dev, valid * m)[0] for m in (1, np.arange(N) % 2, np.zeros(N, np.int32)))
    pool = fused_pool(rng, dev, dtype, L, P, K, page, D, int8)
    q, k, v = qkv_rows(rng, dev, dtype, N, Nq, K, D, True)
    b = qkv_bias(rng, dev, dtype, Nq, K, D)
    cos, sin = rope_rows(positions, D, "llama3")
    args = (q, k, v, cos, sin, *addr, b, pool[1])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel(pool[0], 1, *args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernel(pool[0], 1, *args)
    for n in counts[1:]:
        for t in (q, k, v):
            t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)).to(dev, dtype))
        if kind == "flat":
            count.fill_(n)
        else:
            count.copy_(n)
        ref = tuple(None if t is None else t.clone() for t in pool)
        graph.replay()
        want = plain(ref[0], 1, *args[:-1], ref[1])
        torch.cuda.synchronize()
        assert torch.equal(out, want) and same_pool(pool, ref)


def test_fused_write_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(34)
    pt, rows, positions, _, total, P = flat_step(rng, 16)
    T = len(rows)
    pool = torch.zeros((2, P, 2, 16, 256), device=dev, dtype=torch.bfloat16)
    q, k, v = qkv_rows(rng, dev, torch.bfloat16, T, 4, 2, 128, True)
    pt, rows, positions = on(dev, pt, rows, positions)
    cos, sin = rope_rows(positions, 128, "default")
    n = live(total, dev)
    flat = lambda *a, **kw: ops.rope_write_kv_flat_full(pool, 0, *a, pt, rows, positions, n, **kw)  # noqa: E731
    with pytest.raises(ValueError, match="dtype"):
        flat(q.float(), k, v, cos, sin)
    with pytest.raises(ValueError, match="contiguous"):
        flat(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, cos, sin)
    with pytest.raises(ValueError, match="f32"):
        flat(q, k, v, cos.half(), sin)
    with pytest.raises(ValueError, match=r"\[N, D/2\]"):
        flat(q, k, v, cos[:, :32], sin)
    with pytest.raises(ValueError, match="bq"):
        flat(q, k, v, cos, sin, bias=(torch.zeros(4 * 128, device=dev), k[0].flatten(), k[0].flatten()))
    with pytest.raises(ValueError, match="must be"):
        flat(q, k[:, :1], v, cos, sin)
    with pytest.raises(ValueError, match="head_dim"):
        ops.rope_write_kv_flat_full(pool[..., :96], 0, q[..., :48], k[..., :48], v[..., :48],
                                    cos[:, :24].contiguous(), sin[:, :24].contiguous(), pt, rows,
                                    positions, n)
    with pytest.raises(ValueError, match="layer"):
        ops.rope_write_kv_flat_full(pool, 2, q, k, v, cos, sin, pt, rows, positions, n)
    idx = torch.zeros((T,), device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ops.rope_write_kv_decode_full(pool, 0, q, k, v, cos, sin, idx, idx, idx.bool())
    with pytest.raises(ValueError, match="is on cpu"):
        ops.rope_write_kv_decode_full(pool, 0, q, k, v, cos, sin, idx.cpu(), idx, idx)
    data = torch.zeros((2, P, 2, 16, 256), device=dev, dtype=torch.int8)
    with pytest.raises(ValueError, match="scales"):
        ops.rope_write_kv_decode_full(data, 0, q, k, v, cos, sin, idx, idx, idx,
                                      scales=torch.ones((2, P, 2, 16, 2), device=dev).half())


# --------------------------------------------------------------------- #
# the sliding-window ring


def ring_copy(pool, scales, pt, lens, R, page):
    """The ring pool and ring-view table a ring engine would hold for rows
    of ``lens`` tokens written through ``pt``: row r's ring is R pages of
    its own, and logical page l of it lands at ``ring[l % R]``, later pages
    over earlier ones, as the engine writes them."""
    B = pt.shape[0]
    ring_pt = torch.zeros_like(pt)
    rpool = torch.zeros((pool.shape[0], B * R, *pool.shape[2:]), dtype=pool.dtype, device=pool.device)
    rscales = None if scales is None else torch.ones(
        (scales.shape[0], B * R, *scales.shape[2:]), dtype=scales.dtype, device=scales.device)
    for r in range(B):
        ring = torch.arange(r * R, (r + 1) * R, device=pt.device, dtype=pt.dtype)
        ring_pt[r] = ring[torch.arange(pt.shape[1], device=pt.device) % R]
        for lp in range(-(-int(lens[r]) // page)):
            rpool[:, ring[lp % R]] = pool[:, pt[r, lp]]
            if scales is not None:
                rscales[:, ring[lp % R]] = scales[:, pt[r, lp]]
    return rpool, rscales, ring_pt


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("int8", [False, True])
def test_attention_through_the_ring_table_is_bit_equal(dev, dtype, int8):
    """K1' on a flat step and K3' on a decode step, window 40 with sinks:
    through a ring pool holding each row's latest R pages and its
    ring-view table, the same bits as through the full table."""
    rng = np.random.default_rng(31)
    page, D, K, G, window = 16, 64, 8, 8, 40
    sinks = torch.from_numpy(rng.normal(size=(K * G,)).astype(np.float32)).to(dev)
    # The flat step: a row's live span is its window plus its chunk.
    pt, rows, _, kv_lens, total, P = flat_step(rng, page)
    pool, scales = branch_pool(rng, dev, dtype, 2, P, K, page, D, int8)
    q = torch.from_numpy(rng.normal(size=(len(rows), 1, K * G, D))).to(dev, dtype)
    lens = [p0 + w for p0, w in ROWS]
    R = -(-(window + max(w for _, w in ROWS)) // page) + 1
    pt, rows, kv_lens = on(dev, pt, rows, kv_lens)
    rpool, rscales, rpt = ring_copy(pool, scales, pt, lens, R, page)
    full = ops.flat_paged_attention_full(q, pool, 1, rows, pt, kv_lens, None, window, sinks, scales)
    ring = ops.flat_paged_attention_full(q, rpool, 1, rows, rpt, kv_lens, None, window, sinks, rscales)
    torch.cuda.synchronize()
    assert torch.equal(full, ring)
    # The decode step: one query a row, contexts up to 8,192.
    pt, kv_lens, _, _, _, P = decode_step(rng, page, DECODE_LENS)
    pool, scales = branch_pool(rng, dev, dtype, 2, P, K, page, D, int8)
    q = torch.from_numpy(rng.normal(size=(len(kv_lens), 1, K * G, D))).to(dev, dtype)
    R = -(-(window + 1) // page) + 1
    pt, kv_lens = on(dev, pt, kv_lens)
    rpool, rscales, rpt = ring_copy(pool, scales, pt, DECODE_LENS, R, page)
    full = ops.decode_paged_attention_full(q, pool, 1, pt, kv_lens, None, window, sinks, scales)
    ring = ops.decode_paged_attention_full(q, rpool, 1, rpt, kv_lens, None, window, sinks, rscales)
    torch.cuda.synchronize()
    assert torch.equal(full, ring)


@pytest.mark.parametrize("layout", ["flat", "window", "bucketed"])
def test_ring_engine_on_the_card_matches_the_cpu_engine(dev, layout):
    """A tiny f32 model with sliding (window 16, sinks) and full layers
    under ``swa_ring``: the card's ring engine (kernels through the ring
    table) gives the CPU ring engine's greedy and seeded streams, prompts
    and generation wrapping the ring, a repeated prompt a hybrid hit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = EngineConfig(
        model=tiny_model_config(head_dim=64, num_layers=4, sliding_window=16,
                                layer_types=("sliding_attention", "full_attention") * 2,
                                attention_sinks=True, max_model_len=256),
        cache=CacheConfig(page_size=8, num_blocks=96, dtype="float32", swa_ring=True),
        scheduler=SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=16, **LAYOUTS[layout]),
    )
    params = llama.init_params(cfg.model, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (5, 90, 17, 60)]
    sps = [SamplingParams(temperature=t, max_tokens=40, ignore_eos=True, seed=9)
           for t in (0.0, 0.8, 0.0, 0.8)]
    engines = [LLMEngine(cfg, params=params, device=d) for d in ("cpu", "cuda")]
    outs = [[list(e.generate(prompts, sps).values()), list(e.generate(prompts[1:2], sps[1]).values())]
            for e in engines]
    assert outs[0] == outs[1]
    for e in engines:
        assert e.runner.kv_swa is not None and e._swa_sections.hits == 1


@pytest.mark.parametrize("overrides", [dict(dtype="bfloat16"), dict(qk_norm=True, tie_word_embeddings=True)],
                         ids=["llama-bf16", "qwen3-f32"])
def test_loader_round_trip_on_the_card(dev, tmp_path, overrides):
    """A random tiny tree written as an HF checkpoint (``chip_smoke``'s
    writer) and loaded with ``device="cuda"``: every leaf bit-equal to the
    tree in the runner's form (``fuse_projections``)."""
    import chip_smoke as smoke
    from llmd_tpu_torch.models.loader import config_from_hf, load_params

    cfg = tiny_model_config(head_dim=64, vocab_size=512, **overrides)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    smoke.write_hf_checkpoint(cfg, params, str(tmp_path / "ckpt"))
    hf_cfg = config_from_hf(str(tmp_path / "ckpt"))
    assert hf_cfg.dtype == cfg.dtype and hf_cfg.qk_norm == cfg.qk_norm
    got = load_params(hf_cfg, str(tmp_path / "ckpt"), device="cuda")
    assert smoke.trees_equal(smoke._tree_map(got, lambda t: t.cpu()), llama.fuse_projections(params))
    assert all(t.is_cuda for t in got["layers"].values())


# --------------------------------------------------------------------- #
# speculative decoding: the device forms the fused verify window runs


def test_accept_counts_and_spec_seed_on_the_card_equal_the_host_forms(dev):
    """``accept_counts`` on CUDA tensors (what the fused verify window
    applies inside its graph) equals the host rule (``accept_draft_tokens``)
    row for row, ragged draft lengths included; the tensor ``spec_seed``
    on the card is bit-equal to the Python-int form at the uint32 edges."""
    from llmd_tpu_torch.engine.sampler import accept_counts, accept_draft_tokens, spec_seed

    rng = np.random.default_rng(3)
    B, k = 256, 5
    draft = rng.integers(0, 3, size=(B, k))
    target = np.where(rng.random((B, k + 1)) < 0.8, np.pad(draft, ((0, 0), (0, 1))),
                      rng.integers(0, 3, size=(B, k + 1)))
    dlen = rng.integers(0, k + 1, size=B)
    n_emit, n_acc = accept_counts(*(torch.from_numpy(a).to(dev) for a in (draft, target, dlen)))
    assert n_emit.device.type == "cuda"
    for i in range(B):
        window, acc = accept_draft_tokens(draft[i, : dlen[i]].tolist(), target[i].tolist())
        assert (n_acc[i].item(), n_emit[i].item()) == (acc, len(window))
    seeds = [0, 1, 77, 2**31, 2**32 - 1]
    idx = [0, 63, 2**20, 2**32 - 1]
    S = torch.tensor([[s] * len(idx) for s in seeds], device=dev)
    I = torch.tensor([idx] * len(seeds), device=dev)
    got = spec_seed(S, I).cpu().tolist()
    assert got == [[spec_seed(s, i) for i in idx] for s in seeds]


SPEC_CASES = [("tiny", "flat", 1), ("tiny", "flat", 4), ("tiny", "split", 1),
              ("tiny-mla", "default", 1), ("tiny-mla", "default", 4), ("tiny-mla", "split", 1)]


@pytest.mark.parametrize("model,layout,window", SPEC_CASES,
                         ids=[f"{m}-{lay}-w{w}" for m, lay, w in SPEC_CASES])
@pytest.mark.parametrize("async_scheduling", [False, True], ids=["sync", "async"])
def test_spec_engine_on_the_card_matches_the_cpu_engine(dev, model, layout, window,
                                                        async_scheduling):
    """Speculative engines (f32; tiny at head_dim 64 for the GQA kernels)
    on the card against the same engine on the CPU: the streams and the
    speculative counters equal, drafts accepted, the pool empty. The
    split layouts run steps that replay the verify program and the plain
    one-token program back to back, so the first program's output must
    survive the second's replay."""
    from llmd_tpu_torch.models.registry import get_model_config

    torch.backends.cuda.matmul.allow_tf32 = False
    mcfg = get_model_config(model, **({} if model == "tiny-mla" else {"head_dim": 64}))
    sched = {"flat": {}, "default": {}, "split": {"unified_step": False}}[layout]
    cfg = EngineConfig(
        model=mcfg,
        cache=CacheConfig(page_size=8, num_blocks=96, dtype="float32"),
        scheduler=SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=64, decode_window=window,
                                  speculative_ngram=True, async_scheduling=async_scheduling,
                                  **sched),
    )
    params = llama.init_params(mcfg, torch.Generator().manual_seed(0), "cpu")
    prompts = [[1, 5, 9, 13] * 3, [3, 3, 7, 1, 3, 3, 7, 1], [7, 8, 9] * 6, [2, 4] * 9]
    sp = SamplingParams(temperature=0.0, max_tokens=40, ignore_eos=True)

    def counters(eng):
        s = eng.scheduler
        return (s.spec_proposed_tokens, s.spec_accepted_tokens, list(s.spec_accept_len_hist),
                s.spec_window_iters)

    cpu = LLMEngine(cfg, params=params, device="cpu")
    want = cpu.generate(prompts, sp)
    gpu = LLMEngine(cfg, params=params, device="cuda")
    got = gpu.generate(prompts, sp)
    assert list(got.values()) == list(want.values())
    assert counters(gpu) == counters(cpu) and gpu.scheduler.spec_accepted_tokens > 0
    assert gpu.allocator.usage() == 0.0
    if window > 1:
        assert any(k[0] == "vwindow" for k in gpu.runner.programs.runs)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_graph_replays_after_a_restore_read_the_restored_pages(dev, kv_dtype, tmp_path):
    """Tiered offload on the card: the decode steps' CUDA graphs are
    captured before any restore; a prompt pushed out of a small device
    pool and restored from the host tier (``scatter_pages`` writes the
    pool in place) then decodes through graph replays of those graphs,
    which read the restored pages: its stream equals its device-hit run's
    and the CPU engine's, the pool tensors never moved, and no graph was
    captured again. The restored pages hold ``scatter_pages``' plain
    arithmetic of the host pages, run on the CPU."""
    from llmd_tpu_torch.config import OffloadConfig
    from llmd_tpu_torch.engine.kv_cache import page_hashes_for_tokens
    from llmd_tpu_torch.ops.quant_kv import quantize_pages

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = EngineConfig(
        model=tiny_model_config(head_dim=64, num_layers=3),
        cache=CacheConfig(page_size=8, num_blocks=24, dtype=kv_dtype),
        scheduler=SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=64),
        offload=OffloadConfig(cpu_chunks=64, fs_dir=str(tmp_path)),
    )
    params = llama.init_params(cfg.model, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 256, size=41).tolist()
    junk = [rng.integers(0, 256, size=60).tolist() for _ in range(4)]
    sp = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)
    eng = LLMEngine(cfg, params=params, device="cuda")
    eng.warmup()
    pool = eng.runner.kv_cache
    ptrs = [t.data_ptr() for t in (pool if isinstance(pool, tuple) else (pool,))]

    def run(p):
        return next(iter(eng.generate([p], sp).values()))

    run(prompt)
    hit = run(prompt)
    captured = set(eng.runner.programs.programs)  # one row's keys are captured by now
    for p in junk:
        run(p)
    hashes = page_hashes_for_tokens(prompt, 8)
    assert not any(eng.allocator.has_cached(h) for h in hashes)
    restores0, replays0 = eng.stats.offload_restores, sum(eng.runner.programs.runs.values())
    assert run(prompt) == hit
    assert eng.stats.offload_restores - restores0 == len(hashes)
    assert sum(eng.runner.programs.runs.values()) - replays0 >= sp.max_tokens - 1
    pool = eng.runner.kv_cache
    assert ptrs == [t.data_ptr() for t in (pool if isinstance(pool, tuple) else (pool,))]
    assert set(eng.runner.programs.programs) == captured  # nothing captured again
    # The restored pages: the plain arithmetic of scatter_pages on the CPU.
    ids = torch.tensor([eng.allocator._cached[h] for h in hashes], device="cuda")
    host = eng._host_cache
    bundle = torch.stack([host._pages[h] for h in hashes], dim=1)  # pinned host pages
    if isinstance(pool, tuple):
        data, scales = quantize_pages(bundle)
        assert torch.equal(pool[0][:, ids].cpu(), data) and torch.equal(pool[1][:, ids].cpu(), scales)
    else:
        assert torch.equal(pool[:, ids].cpu(), bundle)
    cpu = LLMEngine(cfg.__class__(model=cfg.model, cache=cfg.cache, scheduler=cfg.scheduler),
                    params=params, device="cpu")
    assert next(iter(cpu.generate([prompt], sp).values())) == hit


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_pd_page_functions_equal_the_cpu_arithmetic(dev, kv_dtype):
    """The P/D page functions on the card against the same calls on the
    CPU, on equal pools: snapshots (whole and a layer slice; the q8 form
    quantized on the card) downloaded through the copy stream, and
    scatters of a float bundle, of a q8 pair and of a device snapshot into
    a layer slice, all bit for bit; the pool tensors do not move."""
    cfg = EngineConfig(model=tiny_model_config(num_layers=4, head_dim=64),
                       cache=CacheConfig(page_size=8, num_blocks=24, dtype=kv_dtype))
    params = llama.init_params(cfg.model, torch.Generator().manual_seed(0), "cpu")
    gpu, cpu = (LLMEngine(cfg, params=params, device=d).runner for d in ("cuda", "cpu"))
    rng = np.random.default_rng(3)
    parts = gpu.kv_cache if gpu.kv_quantized else (gpu.kv_cache,)
    for g, c in zip(parts, cpu.kv_cache if cpu.kv_quantized else (cpu.kv_cache,)):
        if g.dtype == torch.int8:
            v = torch.from_numpy(rng.integers(-127, 128, size=g.shape).astype(np.int8))
        elif g.dtype == torch.float32 and kv_dtype == "int8":  # scales on the f16 grid
            v = torch.from_numpy(rng.uniform(0.004, 0.02, size=g.shape).astype(np.float16)).float()
        else:
            v = torch.from_numpy(rng.standard_normal(g.shape).astype(np.float32)).to(g.dtype)
        g.copy_(v)
        c.copy_(v)
    ptrs = [t.data_ptr() for t in parts]
    for layers in (None, (1, 3)):
        for fn in ("snapshot_pages_device", "snapshot_pages_device_q8"):
            got = getattr(gpu, fn)([9, 2, 17], 4, layers=layers)
            want = getattr(cpu, fn)([9, 2, 17], 4, layers=layers)
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                np.testing.assert_array_equal(gpu.download_pages(a), cpu.download_pages(b))
    bundle = rng.standard_normal((4, 2, *gpu.page_shape[1:])).astype(np.float32)
    q8 = cpu.snapshot_pages_device_q8([5, 6], 2)
    q8 = tuple(t.numpy() for t in q8)
    for r in (gpu, cpu):
        r.scatter_pages([1, 20], bundle)
        r.scatter_pages([3, 4], bundle[1:], layers=(1, 3))
        r.scatter_pages_q8([7, 11], *q8)
        r.scatter_pages_from_device([12, 13], r.snapshot_pages_device_q8([7, 11], 2, layers=(0, 2)),
                                    layers=(2, 2))
        r.scatter_pages_from_device([14, 15], r.snapshot_pages_device([1, 20], 2))
    for g, c in zip(parts, cpu.kv_cache if cpu.kv_quantized else (cpu.kv_cache,)):
        assert torch.equal(g.cpu(), c)
    assert ptrs == [t.data_ptr() for t in (gpu.kv_cache if gpu.kv_quantized else (gpu.kv_cache,))]


@pytest.mark.parametrize("fast", [False, True], ids=["tcp", "claim"])
def test_graph_replays_after_a_fetch_thread_scatter_read_the_pages(dev, fast):
    """P/D on the card: the consumer's decode graphs are captured first;
    the import then lands from a fetch thread (over TCP: pulled cells
    uploaded and scattered in place there; or the producer's device
    snapshots claimed and scattered there), the request parked until the
    stream resolves; its decode runs as replays of those graphs and reads
    the imported pages: the stream equals the aggregated engine's on the
    card and the consumer's on the CPU, the pool never moved and no graph
    was captured again."""
    import threading

    torch.backends.cuda.matmul.allow_tf32 = False
    base = dict(model=tiny_model_config(head_dim=64, num_layers=4),
                cache=CacheConfig(page_size=8, num_blocks=64, dtype="float32"),
                scheduler=SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=64),
                kv_transfer_port=0, kv_local_fastpath=fast)
    params = llama.init_params(base["model"], torch.Generator().manual_seed(0), "cpu")
    prompt = np.random.default_rng(6).integers(0, 256, size=75).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)
    agg = LLMEngine(EngineConfig(**base), params=params, device="cuda")
    want = next(iter(agg.generate([prompt], sp).values()))
    producer = LLMEngine(EngineConfig(**base, kv_role="kv_producer"), params=params, device="cuda")
    consumer = LLMEngine(EngineConfig(**base, kv_role="kv_consumer"), params=params, device="cuda")
    consumer.warmup()
    captured = set(consumer.runner.programs.programs)
    ptr = consumer.runner.kv_cache.data_ptr()
    try:
        params_out = None
        producer.add_request(list(prompt), SamplingParams(temperature=0.0, max_tokens=1),
                                   kv_transfer_params={"do_remote_decode": True})
        while producer.has_work():
            for o in producer.step():
                if o.finished:
                    params_out = o.kv_transfer_params
        conn = consumer.kv_connector
        handle = conn.make_stream_handle(params_out)
        fetcher = threading.Thread(target=conn.fetch_remote_policy,
                                   args=(list(prompt), params_out, handle))
        fetcher.start()
        assert handle.wait_admittable(60)
        crid = consumer.add_request(list(prompt), sp,
                                    kv_transfer_params={**params_out, "__stream__": handle})
        runs0 = sum(consumer.runner.programs.runs.values())
        got, cached = [], None
        while consumer.has_work():
            for o in consumer.step():
                if o.request_id == crid:
                    got += o.new_token_ids
                    cached = o.num_cached_tokens
        fetcher.join(60)
        assert got == want and cached == 72
        assert conn.local_imports == int(fast) and conn.import_failures == 0
        assert sum(consumer.runner.programs.runs.values()) - runs0 >= sp.max_tokens - 2
        assert set(consumer.runner.programs.programs) == captured
        assert consumer.runner.kv_cache.data_ptr() == ptr
        cpu = LLMEngine(EngineConfig(**{**base, "kv_local_fastpath": False}), params=params,
                        device="cpu")
        assert next(iter(cpu.generate([prompt], sp).values())) == want
    finally:
        producer.close()
        consumer.close()


def pager_config(blocks: int, paging: bool, kv_dtype: str = "float32"):
    from llmd_tpu_torch.config import OffloadConfig

    return EngineConfig(
        model=tiny_model_config(head_dim=64, num_layers=3, sliding_window=32, max_model_len=512),
        cache=CacheConfig(page_size=8, num_blocks=blocks, dtype=kv_dtype),
        scheduler=SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=64, decode_window=4),
        offload=OffloadConfig(cpu_chunks=256, decode_paging=paging, pager_horizon_tokens=8),
    )


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_pager_spills_and_restores_on_the_card_as_the_pager_off(dev, kv_dtype):
    """The decode pager on the card: a large pool where pages only spill,
    and a small one where victims park and their windows are restored (the
    copies to pinned slots on the copy stream, the restore's upload and
    scatter in layer groups), both give the pager-off engine's streams and
    the CPU pager engine's counters; the decode graphs were captured before
    any restore and nothing is captured again."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg0 = pager_config(512, False, kv_dtype)
    params = llama.init_params(cfg0.model, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    long = [rng.integers(0, 256, size=120).tolist() for _ in range(2)]
    short = [rng.integers(0, 256, size=20).tolist() for _ in range(4)]
    sp = SamplingParams(temperature=0.0, max_tokens=40, ignore_eos=True)
    want = {}
    for name, prompts in (("long", long), ("short", short)):
        want[name] = list(LLMEngine(cfg0, params=params, device="cuda").generate(prompts, sp).values())
    for name, prompts, blocks in (("long", long, 512), ("short", short, 14)):
        cfg = pager_config(blocks, True, kv_dtype)
        eng = LLMEngine(cfg, params=params, device="cuda")
        eng.warmup()
        captured = set(eng.runner.programs.programs)
        got = list(eng.generate(prompts, sp).values())
        cpu = LLMEngine(cfg, params=params, device="cpu")
        assert got == want[name] == list(cpu.generate(prompts, sp).values())
        counters = ("pages_spilled_total", "pages_restored_total", "parks_total", "refunds_total")
        assert [getattr(eng.pager, k) for k in counters] == [getattr(cpu.pager, k) for k in counters]
        assert eng.pager.pages_spilled_total > 0 or eng.pager.parks_total > 0
        if name == "short":
            assert eng.pager.parks_total > 0 and eng.pager.pages_restored_total > 0
        assert set(eng.runner.programs.programs) == captured
        assert sum(eng.runner.programs.runs.values()) > 0
        eng.close()


def test_lora_delta_in_a_captured_decode_graph_equals_its_eager_body(dev):
    """Adapter rows through decode graphs captured before the adapters were
    installed: the card engine's streams equal the CPU engine's (eager)
    with mixed slots; an install after capture writes the slots in place,
    and the next replays serve it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = EngineConfig(
        model=tiny_model_config(head_dim=64, num_layers=3, num_lora_adapters=3, lora_rank=4),
        cache=CacheConfig(page_size=8, num_blocks=64, dtype="float32"),
        scheduler=SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=64, decode_window=4),
    )
    params = llama.init_params(cfg.model, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (9, 17, 30, 12)]
    layers = params["layers"]

    def adapter(seed):
        g = np.random.default_rng(seed)
        return {k: g.normal(0, 0.5, (layers[k].shape[0], *layers[k].shape[2:])).astype(np.float32)
                for k in ("la_q", "lb_q", "la_v", "lb_v")}

    eng = LLMEngine(cfg, params=params, device="cuda")
    eng.warmup()
    captured = set(eng.runner.programs.programs)
    cpu = LLMEngine(cfg, params=params, device="cpu")
    sp = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)

    def run(e):
        rids = [e.add_request(p, sp, lora_id=i) for i, p in enumerate(prompts)]
        out = {r: [] for r in rids}
        while e.has_work():
            for o in e.step():
                out[o.request_id] += o.new_token_ids
        return [out[r] for r in rids]

    for seed in (1, 2):
        for e in (eng, cpu):
            for slot in (1, 2, 3):
                e.set_lora_weights(slot, adapter(10 * seed + slot))
        runs0 = sum(eng.runner.programs.runs.values())
        got = run(eng)
        assert got == run(cpu)
        assert sum(eng.runner.programs.runs.values()) > runs0
        assert set(eng.runner.programs.programs) == captured
    assert len({tuple(s) for s in got}) == len(prompts)
