"""The decode steps' programs (``engine/graphs.py``) on the CPU.

On the card every decode-only step is a CUDA graph replay of one body per
key; on the CPU the same bodies run eagerly from the same static inputs.
Here they are held to the JAX engine's greedy and seeded streams on tiny,
tiny-moe, tiny-mla, the tiny gpt-oss configuration and the int8 pool, with
decode-only flat steps at a stream length T wider than the live rows and
decode windows at a batch bucket wider than the live rows; each model runs
the program family its layout dispatches (the flat step's, or the decode
window's, which on MLA's default engine carries its one-token decode
steps). The static inputs' shapes depend on the key alone (hypothesis);
pad tokens of a flat decode-only step write nothing to the pool (page 0
included), on a float and an int8 pool; ``warmup`` prepares the reference's
default keys and leaves the pool as it was. The card's side (replay equals
the eager body, launches per replay) is in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import llmd_tpu_torch.config as tcfg
from llmd_tpu.engine import SamplingParams as JaxSP
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.engine.request import Request
from llmd_tpu_torch.engine.runner import ModelRunner, pad_to_bucket
from llmd_tpu_torch.engine.scheduler import ScheduledSeq
from llmd_tpu_torch.models.registry import get_model_config

from test_torch_engine import LAYOUTS, PROMPTS, engines, streams
from test_torch_model import TINY_OSS

# name -> (engines() arguments, the program family its layout runs). With
# max_num_seqs 8 and three prompts, the window's batch bucket is 8 and the
# decode-only flat step's T is 16.
MODELS = {
    "tiny": (dict(model="tiny", **LAYOUTS["window"]), "window"),
    "tiny-int8": (dict(model="tiny", kv_dtype="int8", **LAYOUTS["window"]), "window"),
    "tiny-mla": (dict(model="tiny-mla"), "window"),
    "tiny-moe": (dict(model="tiny-moe"), "flat"),
    "tiny-oss": (dict(model=TINY_OSS, num_blocks=96), "flat"),
}
SAMPLINGS = (
    dict(temperature=0.0, max_tokens=9, ignore_eos=True),
    dict(temperature=0.8, max_tokens=9, seed=7, ignore_eos=True),
)


@pytest.fixture(scope="module")
def engine_pairs():
    """(JAX engine, port engine) per model of MODELS, built once."""
    cache = {}

    def get(model):
        if model not in cache:
            cache[model] = engines(**MODELS[model][0])
        return cache[model]

    return get


@pytest.mark.parametrize("model", sorted(MODELS))
def test_programs_give_the_jax_streams(model, engine_pairs):
    j, p = engine_pairs(model)
    for sp in SAMPLINGS:
        assert streams(p, PROMPTS, SamplingParams, **sp) == streams(j, PROMPTS, JaxSP, **sp)
    # Every decode-only step ran as its family's program, greedy and
    # sampled, at a bucket wider than the three live rows.
    family = MODELS[model][1]
    runs = p.runner.programs.runs
    if family == "flat":
        assert set(runs) == {("flat", 16, True), ("flat", 16, False)}
    else:
        k = 1 if model == "tiny-mla" else 4
        assert set(runs) == {("window", 8, k, True), ("window", 8, k, False)}
    if model != "tiny-mla":  # the split engine: every decode dispatch is a window
        assert family == "flat" or sum(runs.values()) == p.stats.decode_dispatches_total


@pytest.fixture(scope="module")
def runner():
    """A tiny CPU runner with a 20-row batch: buckets 8, 16, 20."""
    cfg = tcfg.EngineConfig(
        model=tcfg.tiny_model_config(),
        cache=tcfg.CacheConfig(page_size=4, num_blocks=64, dtype="float32"),
        scheduler=tcfg.SchedulerConfig(max_num_seqs=20, max_num_batched_tokens=32),
    )
    return ModelRunner(cfg, device="cpu")


def decode_rows(rng, n, page, num_blocks, low_page=0, seeded=(), max_len=100):
    """``n`` requests in decode, one token a row: prompts of 3-``max_len`` tokens,
    one output token not yet computed, pages drawn from [low_page,
    num_blocks) (distinct across rows when there are enough); rows in
    ``seeded`` sample with a seed, the others greedily."""
    pages = rng.permutation(np.arange(low_page, num_blocks))
    rows, off = [], 0
    for i in range(n):
        length = int(rng.integers(3, max_len + 1))
        need = -(-(length + 1) // page)
        if off + need > len(pages):
            pages, off = rng.permutation(np.arange(low_page, num_blocks)), 0
        sp = SamplingParams(temperature=0.7, seed=i) if i in seeded else SamplingParams(temperature=0.0)
        req = Request(f"r{i}", rng.integers(0, 256, size=length).tolist(), sp)
        req.output_token_ids = [int(rng.integers(0, 256))]
        req.num_computed_tokens = length
        req.block_ids = pages[off : off + need].tolist()
        off += need
        rows.append(ScheduledSeq(req, 1))
    return rows


@settings(max_examples=30, deadline=None)
@given(n=st.integers(1, 20), k=st.integers(1, 8), seed=st.integers(0, 2**16),
       seeded=st.sets(st.integers(0, 19), max_size=4))
def test_static_input_shapes_depend_only_on_the_key(runner, n, k, seed, seeded):
    """For any decode-only schedule, the arrays a step stages are the
    key's spec, name for name, shape for shape, dtype for dtype; the key
    is the batch bucket (or the 16-token granule), K and all_greedy."""
    staged = []
    runner.programs.run = lambda key, arrays: staged.append((key, arrays)) or torch.zeros(1)
    try:
        rows = decode_rows(np.random.default_rng(seed), n, runner.page, 64, seeded=seeded)
        runner.dispatch_unified([], rows)
        runner.dispatch_staged_decode(runner.stage_decode(rows, k))
    finally:
        del runner.programs.run
    greedy = not any(i < n for i in seeded)
    flat, window = staged
    assert flat[0] == ("flat", -(-n // 16) * 16, greedy)
    assert window[0] == ("window", pad_to_bucket(n, runner.batch_buckets), k, greedy)
    for key, arrays in staged:
        spec, _ = runner._program(key)
        assert set(arrays) == set(spec)
        for name, (shape, dtype) in spec.items():
            assert arrays[name].shape == shape, name
            assert torch.from_numpy(arrays[name]).dtype == dtype, name


def random_pool(runner, rng):
    """Fill the runner's pool with seeded random bytes; returns a copy."""
    pool = runner.kv_cache
    if isinstance(pool, tuple):
        pool[0].copy_(torch.from_numpy(rng.integers(-127, 128, size=pool[0].shape).astype(np.int8)))
        pool[1].copy_(torch.from_numpy(rng.uniform(0.01, 0.1, size=pool[1].shape).astype(np.float32)))
        return tuple(t.clone() for t in pool)
    pool.copy_(torch.from_numpy(rng.normal(size=pool.shape).astype(np.float32)))
    return pool.clone()


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_flat_decode_pads_write_nothing(kv_dtype):
    """A decode-only flat step at T = 32 with 17 live rows: the K|V write
    changes the live rows' slots and no other byte of the pool. A pad token
    has position 0 and the last table row, all zeros, so a write of it
    would land on page 0, slot 0; no live row holds page 0 here."""
    cfg = tcfg.EngineConfig(
        model=tcfg.tiny_model_config(),
        cache=tcfg.CacheConfig(page_size=4, num_blocks=80, dtype=kv_dtype),
        scheduler=tcfg.SchedulerConfig(max_num_seqs=20, max_num_batched_tokens=32),
    )
    r = ModelRunner(cfg, device="cpu")
    rng = np.random.default_rng(11)
    before = random_pool(r, rng)
    rows = decode_rows(rng, 17, r.page, 80, low_page=1, max_len=12)
    live = set()
    for s in rows:
        pos = s.start_pos
        live.add((s.request.block_ids[pos // r.page], pos % r.page))
    r.wait_step(unified=r.dispatch_unified([], rows))
    assert r.programs.runs == {("flat", 32, True): 1}
    after = r.kv_cache if isinstance(r.kv_cache, tuple) else (r.kv_cache,)
    before = before if isinstance(before, tuple) else (before,)
    for a, b in zip(after, before):
        # [L, P, K, page, ...] -> which (page, slot) any layer or head changed
        changed = (a != b).flatten(start_dim=4).any(-1).any(2).any(0)
        got = {(int(p), int(t)) for p, t in changed.nonzero()}
        assert got <= live
        assert not changed[0].any()
    assert (after[0] != before[0]).any()


@pytest.mark.parametrize("model,layout,keys", [
    ("tiny", "flat", {("flat", 16, g) for g in (True, False)}),
    ("tiny", "window", {("window", 8, k, g) for k in (1, 4) for g in (True, False)}),
    ("tiny", "flat_window", {("window", 8, 4, g) for g in (True, False)}
     | {("flat", 16, g) for g in (True, False)}),
    ("tiny-mla", "default", {("window", 8, 1, g) for g in (True, False)}),
])
def test_warmup_prepares_the_default_keys_and_leaves_the_pool(model, layout, keys):
    """``warmup`` prepares both ``all_greedy`` values of the largest batch
    bucket at every window K the scheduler dispatches, and of the largest
    decode-only T on the flat engine (the JAX runner's default warm set);
    it runs each body on inputs with no live row, so the pool keeps every
    byte, and a second call prepares nothing."""
    sched = {"flat_window": dict(decode_window=4)}.get(layout, LAYOUTS.get(layout, {}))
    cfg = tcfg.EngineConfig(
        model=get_model_config(model),
        cache=tcfg.CacheConfig(page_size=4, num_blocks=32, dtype="float32"),
        scheduler=tcfg.SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=32, **sched),
    )
    eng = LLMEngine(cfg, device="cpu")
    before = random_pool(eng.runner, np.random.default_rng(5))
    assert eng.warmup() == len(keys)
    assert set(eng.runner.programs.programs) == set(eng.runner.warm_keys()) == keys
    assert torch.equal(eng.runner.kv_cache, before)
    assert eng.warmup() == 0
    assert not eng.runner.programs.runs

