"""``ops.grouped_gemm.q8_plan``: the form and tiles of K6''s int8
branch, chosen on the host from ``(M, G, N, K, SMs)`` alone, on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``
holds every form it takes bit-equal to the plain version); what decides
its launch is plain Python, checked here: the shapes of PERF.md's int8
rows (llama-3-8b's and qwen3-32b's dense products, deepseek-v2-lite's and
gpt-oss-20b's experts, decode and prefill) on an H100's 132 SMs, the edge
cases (1, 8, 32, 64 and 65 rows; groups of 0, 1 and 3 rows; N = 2,880; K
off the 128-byte slices) and, over drawn shapes, the plan's invariants:
a form the launcher takes, the row tile the least s8 wgmma N that holds
the rows.
"""

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from llmd_tpu_torch.ops import grouped_gemm
from llmd_tpu_torch.ops.grouped_gemm import Q8_SWAP_ROWS, Q8Plan, q8_plan

SMS = 132  # H100 SXM

# PERF.md's int8 rows: (M, G, N, K, pair) -> the plan.
PERF_ROWS = {
    "llama decode 32, wqkv": ((32, 1, 6144, 4096, False), Q8Plan(True, 32, 64)),
    "llama decode 32, wo": ((32, 1, 4096, 4096, False), Q8Plan(True, 32, 64)),
    "llama decode 32, w_gu": ((32, 1, 28672, 4096, False), Q8Plan(True, 32, 128)),
    "llama decode 32, w_down": ((32, 1, 4096, 14336, False), Q8Plan(True, 32, 64)),
    "llama decode 32, lm_head": ((32, 1, 128256, 4096, False), Q8Plan(True, 32, 128)),
    "llama decode 64, w_gu": ((64, 1, 28672, 4096, False), Q8Plan(True, 64, 128)),
    "llama prefill 1024, wqkv": ((1024, 1, 6144, 4096, False), Q8Plan(False, 128, 128)),
    "llama prefill 1024, w_gu": ((1024, 1, 28672, 4096, False), Q8Plan(False, 128, 256)),
    "llama prefill 1024, w_down": ((1024, 1, 4096, 14336, False), Q8Plan(False, 128, 256)),
    "qwen3-32b decode 32, wqkv": ((32, 1, 10240, 5120, False), Q8Plan(True, 32, 128)),
    "qwen3-32b decode 32, wo": ((32, 1, 5120, 8192, False), Q8Plan(True, 32, 64)),
    "qwen3-32b decode 32, w_down": ((32, 1, 5120, 25600, False), Q8Plan(True, 32, 64)),
    "deepseek decode 48, pair": ((288, 64, 1408, 2048, True), Q8Plan(True, 16, 128)),
    "deepseek decode 48, down": ((288, 64, 2048, 1408, False), Q8Plan(True, 16, 128)),
    "deepseek prefill 1024, pair": ((6144, 64, 1408, 2048, True), Q8Plan(False, 128, 128)),
    "gpt-oss decode 32, pair": ((128, 32, 2880, 2880, True), Q8Plan(True, 8, 64)),
    "gpt-oss decode 32, down": ((128, 32, 2880, 2880, False), Q8Plan(True, 8, 64)),
    "gpt-oss prefill 1024, pair": ((4096, 32, 2880, 2880, True), Q8Plan(False, 128, 256)),
}


@pytest.mark.parametrize("name", sorted(PERF_ROWS))
def test_plans_of_the_models_int8_products(name):
    (M, G, N, K, pair), want = PERF_ROWS[name]
    assert q8_plan(M, G, N, K, SMS, pair) == want


@pytest.mark.parametrize("M,rows", [(1, 8), (8, 8), (9, 16), (17, 24), (25, 32), (32, 32),
                                    (33, 48), (49, 64), (64, 64)])
def test_dense_decode_rows_take_the_next_s8_wgmma_n(M, rows):
    """A dense product of up to 64 rows is swap-AB, its rows on wgmma's N
    side rounded up to the next N s8 wgmma takes: 32 rows cost 32
    columns of work, not a 64-row tile."""
    for N, K in ((4096, 4096), (2880, 2880), (576, 2048)):
        plan = q8_plan(M, 1, N, K, SMS)
        assert plan.swap and plan.rows == rows, (N, K)


def test_65_rows_take_the_prefill_form():
    for N, K in ((4096, 4096), (2880, 400)):
        plan = q8_plan(65, 1, N, K, SMS)
        assert not plan.swap and plan.rows == 128 and plan.cols in (128, 256)


@pytest.mark.parametrize("sizes", [(0, 1, 3, 0, 3, 1, 0), (1,) * 24, (3, 0, 2, 1)])
def test_groups_of_a_few_rows_are_swap_ab(sizes):
    """Grouped decode steps (groups of 0, 1 and 3 rows): swap-AB with the
    smallest row tile, whatever N and K."""
    M, G = sum(sizes), len(sizes)
    for N, K in ((2880, 2880), (1408, 2048), (144, 208)):
        plan = q8_plan(M, G, N, K, SMS, pair=True)
        assert plan == Q8Plan(True, 8, plan.cols) and plan.cols in (64, 128)


def test_grouped_row_tile_covers_twice_the_average_group():
    # 288 rows over 64 experts: 4.5 a group -> 16; 128 over 32 -> 8;
    # 40 a group -> 64; 65 a group -> the prefill form.
    assert q8_plan(288, 64, 1408, 2048, SMS).rows == 16
    assert q8_plan(128, 32, 2880, 2880, SMS).rows == 8
    assert q8_plan(40 * 8, 8, 512, 512, SMS).rows == 64
    assert not q8_plan(65 * 8, 8, 512, 512, SMS).swap


def test_k_off_the_slices_and_long_k_with_few_items():
    """K that is not a multiple of 128 bytes counts its last partial slice;
    a long contraction over a few items (deepseek-v2-lite's dense down at
    a 128-token step) takes the narrower prefill tile, twice the items."""
    assert q8_plan(128, 1, 2048, 10944, SMS) == Q8Plan(False, 128, 128)
    assert q8_plan(128, 1, 2048, 2048, SMS) == Q8Plan(False, 128, 128)
    assert q8_plan(32, 1, 576, 2048, SMS) == Q8Plan(True, 32, 64)
    for K in (16, 144, 400, 2880):
        assert q8_plan(8, 1, 64, K, SMS) == Q8Plan(True, 8, 64)
    # A slice cut short costs a whole slice: K = 2,064 plans as 2,176.
    assert q8_plan(32, 1, 4096, 2064, SMS) == q8_plan(32, 1, 4096, 2176, SMS)


def test_more_sms_take_no_wider_tiles():
    """At the dense products' shapes a card with more SMs to fill takes
    column tiles no wider (more items), one with few SMs the widest. Not
    a law of the model: grouped shapes round their waves (deepseek's
    decode gate, 288 rows x 1,408 columns, takes 128, 128, 64, 128 at
    16, 66, 132, 264 SMs)."""
    for M, G, N, K in ((128, 1, 2048, 10944), (32, 1, 4096, 14336), (8, 1, 256, 8192),
                       (32, 1, 4096, 4096), (1024, 1, 28672, 4096)):
        cols = [q8_plan(M, G, N, K, sms).cols for sms in (16, 66, SMS, 264)]
        assert cols == sorted(cols, reverse=True), (M, G, N, K, cols)
    assert q8_plan(32, 1, 4096, 4096, 16).cols == 128
    assert q8_plan(32, 1, 4096, 4096, SMS).cols == 64


@settings(max_examples=300, deadline=None)
@given(M=st.integers(1, 9000), G=st.integers(1, 1024), N=st.integers(1, 8192).map(lambda n: 16 * n),
       K=st.integers(1, 1024).map(lambda k: 16 * k), sms=st.integers(1, 264), pair=st.booleans())
def test_every_plan_is_a_form_the_launcher_takes(M, G, N, K, sms, pair):
    plan = q8_plan(M, G, N, K, sms, pair)
    avg = -(-M // G)
    assert plan.swap == (avg <= 64)
    if plan.swap:
        assert plan.rows in Q8_SWAP_ROWS and plan.cols in (64, 128)
        want = M if G == 1 else min(64, 2 * avg)
        assert plan.rows >= want and (plan.rows == 8 or Q8_SWAP_ROWS[Q8_SWAP_ROWS.index(plan.rows) - 1] < want)
    else:
        assert plan.rows == 128 and plan.cols in (128, 256)
    # The pair changes the column space, not the form or the row tile.
    other = q8_plan(M, G, N, K, sms, not pair)
    assert (other.swap, other.rows) == (plan.swap, plan.rows)


def test_the_wrappers_take_k_major_weights_on_the_cpu():
    """On the CPU the wrappers run the plain versions, which read the
    K-major layout: ``matmul_q8`` of w [N, K] is ``x @ w.T``, exact."""
    g = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, (5, 48), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (32, 48), generator=g, dtype=torch.int8)
    a, s = torch.rand(5, generator=g), torch.rand(32, generator=g)
    got = grouped_gemm.matmul_q8(xq, a, w, s, torch.float32)
    want = ((xq.double() @ w.double().T).float() * a[:, None]) * s
    assert torch.equal(got, want)
    sizes = torch.tensor([2, 0, 3], dtype=torch.int32)
    w3 = torch.randint(-127, 128, (3, 32, 48), generator=g, dtype=torch.int8)
    s3 = torch.rand((3, 32), generator=g)
    got = grouped_gemm.grouped_matmul_q8(xq, a, w3, s3, sizes, torch.float32)
    gid = [0, 0, 2, 2, 2]
    for r, e in enumerate(gid):
        assert torch.equal(got[r], ((xq[r].double() @ w3[e].double().T).float() * a[r]) * s3[e])
