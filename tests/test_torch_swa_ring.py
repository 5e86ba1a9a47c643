"""The sliding-window ring (``CacheConfig.swa_ring``) of the port against
the JAX package's, on the CPU.

Under the ring a model's sliding layers live in a second, smaller pool in
which each sequence holds a fixed ring of R pages, addressed through a
ring-view page table (logical page l -> ``ring[l % R]``); its full layers
keep the main pool. Here the port's ring geometry (``swa_ring_spec``) and
ring table equal the JAX package's; the port's ring engine gives the JAX
ring engine's greedy and seeded streams on tiny-swa and the tiny gpt-oss
configuration, in the flat, split-with-windows and bucketed layouts, with
a batch, chunked prefills, preemption and generation well past the ring,
on float and int8 pools; and the pools after the run equal JAX's (f32
within 1e-4: XLA and PyTorch sum the projections in different orders, so
they differ by ~3e-6; int8 data and scales equal). The lifecycle: rings
released on finish and reused, a failed admission returns its ring, ring
pressure evicts retained sections; hybrid prefix hits seed a fresh ring
from a retained section and give the cold stream. The decode programs
read the ring table from their static buffer.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import llmd_tpu.config as jcfg
import llmd_tpu_torch.config as tcfg
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine import SamplingParams as JaxSP
from llmd_tpu.engine.scheduler import ScheduledSeq as JaxScheduledSeq
from llmd_tpu.models.registry import get_model_config as jax_model_config
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.engine.kv_cache import page_hashes_for_tokens
from llmd_tpu_torch.engine.request import Request
from llmd_tpu_torch.engine.scheduler import ScheduledSeq
from llmd_tpu_torch.models.llama import params_from_jax
from llmd_tpu_torch.models.registry import get_model_config

from test_torch_engine import LAYOUTS
from test_torch_spec import jax_compile_cache, one_thread  # noqa: F401 (module fixtures)
from test_torch_model import TINY_OSS

# tests/test_swa_ring.py's alternating pattern (gpt-oss's, in 4 layers).
ALTERNATING = dict(
    num_layers=4, num_heads=4, num_kv_heads=2, sliding_window=8,
    layer_types=("sliding_attention", "full_attention") * 2,
)
MODELS = {"tiny-oss": TINY_OSS, "tiny-swa": "tiny-swa", "alternating": ALTERNATING}
RING_LAYOUTS = ("flat", "window", "bucketed")
GREEDY = dict(temperature=0.0, max_tokens=16, ignore_eos=True)
SEEDED = dict(temperature=0.8, max_tokens=16, seed=7, ignore_eos=True)


def rand_prompt(seed, n):
    return [int(x) for x in np.random.default_rng(seed).integers(1, 256, size=n)]


# Per model: prompts around and well past the window (window 8 on tiny-oss,
# ring 7 pages = 28 tokens; window 64 on tiny-swa, ring 21 pages = 84
# tokens), one longer than the 16-token budget in every set.
PROMPTS = {
    "tiny-oss": [rand_prompt(1, 54), rand_prompt(2, 9), rand_prompt(3, 23), rand_prompt(4, 37)],
    "tiny-swa": [rand_prompt(5, 90), rand_prompt(6, 9), rand_prompt(7, 70)],
}


def model_configs(model):
    cfg = MODELS[model]
    if isinstance(cfg, dict):
        return jcfg.tiny_model_config(**cfg), tcfg.tiny_model_config(**cfg)
    return jax_model_config(cfg), get_model_config(cfg)


def ring_engines(model="tiny-oss", ring=True, page=4, num_blocks=96, max_batched=16, max_seqs=8,
                 kv_dtype="float32", cache=None, **sched):
    """The JAX engine and the port's on its parameters, both with
    ``swa_ring=ring``; ``cache`` adds ``CacheConfig`` fields."""
    cache = dict(page_size=page, num_blocks=num_blocks, dtype=kv_dtype, swa_ring=ring, **(cache or {}))
    sched = dict(max_num_seqs=max_seqs, max_num_batched_tokens=max_batched, **sched)
    jmodel, tmodel = model_configs(model)
    j = JaxEngine(jcfg.EngineConfig(
        model=jmodel, cache=jcfg.CacheConfig(**cache), scheduler=jcfg.SchedulerConfig(**sched),
        parallel=jcfg.ParallelConfig(tensor_parallel_size=1),
    ))
    params = params_from_jax(jax.tree.map(np.asarray, j.runner.params))
    p = LLMEngine(tcfg.EngineConfig(model=tmodel, cache=tcfg.CacheConfig(**cache),
                                    scheduler=tcfg.SchedulerConfig(**sched)),
                  params=params, device="cpu")
    return j, p


def port_engine(params, model="tiny-oss", ring=True, page=4, num_blocks=96, max_batched=16,
                max_seqs=8, cache=None, **sched):
    """A port engine alone, on ``params``."""
    return LLMEngine(tcfg.EngineConfig(
        model=model_configs(model)[1],
        cache=tcfg.CacheConfig(page_size=page, num_blocks=num_blocks, dtype="float32",
                               swa_ring=ring, **(cache or {})),
        scheduler=tcfg.SchedulerConfig(max_num_seqs=max_seqs, max_num_batched_tokens=max_batched,
                                       **sched),
    ), params=params, device="cpu")


def run(engine, prompts, sp_cls, **sp):
    """Every request's tokens and its last output, in arrival order."""
    rids = [engine.add_request(list(p), sp_cls(**sp)) for p in prompts]
    toks = {r: [] for r in rids}
    final = {}
    while engine.has_work():
        for out in engine.step():
            toks[out.request_id].extend(out.new_token_ids)
            final[out.request_id] = out
    return [toks[r] for r in rids], [final[r] for r in rids]


def pool_parts(pool):
    return pool if isinstance(pool, tuple) else (pool,)


def assert_pools_match_jax(j, p):
    """Both pools after the run: f32 within 1e-4, int8 data and scales
    equal. The port's ring pool holds the retained sections' pages beside
    the rings (``LLMEngine``); the JAX ring pool has the rings' pages only,
    and those are compared."""
    for jpool, tpool in ((j.runner.kv_cache, p.runner.kv_cache), (j.runner.kv_swa, p.runner.kv_swa)):
        for jt, tt in zip(pool_parts(jpool), pool_parts(tpool)):
            jt = np.asarray(jt)
            tt = tt.numpy()[:, : jt.shape[1]]
            if jt.dtype == np.float32 and not isinstance(jpool, tuple):
                np.testing.assert_allclose(tt, jt, atol=1e-4, rtol=0)
            else:
                np.testing.assert_array_equal(tt, jt)


# --------------------------------------------------------------------- #
# geometry


SPEC_MODELS = {
    "alternating": ALTERNATING,
    "uniform": dict(num_layers=3, sliding_window=8),
    "upper-layers": dict(num_layers=4, sliding_window=8, max_window_layers=2),
    "gpt-oss-20b": None,
}


@pytest.mark.parametrize("decode_window", [1, 4, 64])
@pytest.mark.parametrize("budget", [8, 32, 4096])
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("model", sorted(SPEC_MODELS))
def test_ring_spec_matches_jax(model, page, budget, decode_window):
    """``swa_ring_spec`` field for field, ``section`` and
    ``max_section_pages`` as JAX's, where the ring resolves and where it
    does not (a ring as long as the table)."""
    over = SPEC_MODELS[model]
    if over is None:
        jm, tm = jax_model_config(model), get_model_config(model)
    else:
        over = dict(over, max_model_len=256)
        jm, tm = jcfg.tiny_model_config(**over), tcfg.tiny_model_config(**over)
    sched = dict(max_num_seqs=4, max_num_batched_tokens=budget, decode_window=decode_window)
    js = jcfg.swa_ring_spec(jm, jcfg.CacheConfig(page_size=page, swa_ring=True),
                            jcfg.SchedulerConfig(**sched))
    ts = tcfg.swa_ring_spec(tm, tcfg.CacheConfig(page_size=page, swa_ring=True),
                            tcfg.SchedulerConfig(**sched))
    if js is None:
        assert ts is None
        return
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.max_section_pages(page) == js.max_section_pages(page)
    for n in (1, 5, 17, 130, 250):
        assert ts.section(n, page) == js.section(n, page)


def test_ring_spec_at_the_smoke_settings():
    """gpt-oss-20b at page 16, budget 1,024, 64 sequences: R = ceil((128 +
    1,024) / 16) + 1 = 73 pages, and the pool 64 rings."""
    spec = tcfg.swa_ring_spec(
        get_model_config("gpt-oss-20b"), tcfg.CacheConfig(page_size=16, swa_ring=True),
        tcfg.SchedulerConfig(max_num_seqs=64, max_num_batched_tokens=1024))
    assert (spec.ring_pages, spec.num_swa_blocks, spec.chunk_tokens) == (73, 4672, 1024)
    assert spec.swa_layers == tuple(range(0, 24, 2)) and spec.full_layers == tuple(range(1, 24, 2))


@pytest.mark.parametrize("case", ["off", "full-attention", "mla", "too-short"])
def test_ring_spec_none_cases_match_jax(case):
    model = {"off": ALTERNATING, "full-attention": {}, "too-short": dict(ALTERNATING, max_model_len=32),
             "mla": None}[case]
    if model is None:
        jm, tm = jax_model_config("tiny-mla"), get_model_config("tiny-mla")
    else:
        jm, tm = jcfg.tiny_model_config(**model), tcfg.tiny_model_config(**model)
    ring = case != "off"
    sched = dict(max_num_seqs=4, max_num_batched_tokens=32)
    assert jcfg.swa_ring_spec(jm, jcfg.CacheConfig(page_size=4, swa_ring=ring),
                              jcfg.SchedulerConfig(**sched)) is None
    assert tcfg.swa_ring_spec(tm, tcfg.CacheConfig(page_size=4, swa_ring=ring),
                              tcfg.SchedulerConfig(**sched)) is None


def test_swa_blocks_smaller_than_one_ring_is_refused():
    model = dict(ALTERNATING, max_model_len=256)
    sched = dict(max_num_seqs=4, max_num_batched_tokens=32)
    for cfg in (jcfg, tcfg):  # the ring is 11 pages
        with pytest.raises(ValueError, match="swa_blocks"):
            cfg.swa_ring_spec(cfg.tiny_model_config(**model),
                              cfg.CacheConfig(page_size=4, swa_ring=True, swa_blocks=8),
                              cfg.SchedulerConfig(**sched))


def test_swa_table_matches_jax(stream_pairs):
    """The ring-view table of a batch: rows with rings of R pages, a row
    without one (zeros), pad rows; logical page l -> ring[l % R]."""
    j, p = stream_pairs("tiny-oss", "flat", "float32")
    R = p.runner.swa.ring_pages
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(3):
        req = Request(f"r{i}", [1, 2, 3])
        if i != 1:
            req.swa_block_ids = rng.permutation(40)[:R].tolist()
        reqs.append(req)
    want = j.runner._swa_table([JaxScheduledSeq(r, 1) for r in reqs], 5)
    got = p.runner._swa_table(reqs, 5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :R], reqs[0].swa_block_ids)
    np.testing.assert_array_equal(got[0, R : 2 * R], reqs[0].swa_block_ids)
    assert not got[1].any() and not got[3:].any()


def test_pools_have_the_groups_planes():
    """Main pool: the full layers' planes; ring pool: the sliding layers'
    planes of max_num_seqs rings plus the sections' retention budget."""
    _, p = ring_engines("alternating", max_seqs=4)
    spec = p.runner.swa
    R = spec.ring_pages
    budget = 8 * spec.max_section_pages(4)
    assert p.runner.kv_cache.shape[:2] == (2, 96)
    assert p.runner.kv_swa.shape[:2] == (2, 4 * R + budget)
    assert p.swa_allocator.num_pages == 4 * R + budget


# --------------------------------------------------------------------- #
# streams and pools against JAX

STREAM_CASES = [(m, layout, "float32") for m in ("tiny-oss", "tiny-swa") for layout in RING_LAYOUTS] + [
    ("tiny-oss", "flat", "int8"), ("tiny-oss", "window", "int8")]


@pytest.fixture(scope="module")
def stream_pairs():
    """(JAX ring engine, port ring engine) per stream case, built once."""
    cache = {}

    def get(model, layout, kv_dtype):
        key = (model, layout, kv_dtype)
        if key not in cache:
            cache[key] = ring_engines(model, kv_dtype=kv_dtype, **LAYOUTS[layout])
        return cache[key]

    return get


@pytest.mark.parametrize("model,layout,kv_dtype", STREAM_CASES)
def test_ring_streams_and_pools_match_jax(model, layout, kv_dtype, stream_pairs):
    """Greedy streams, twice on the same engines: the second run repeats the
    prompts, so it takes hybrid hits where sections were retained; both
    packages take the same ones. Then the pools."""
    j, p = stream_pairs(model, layout, kv_dtype)
    prompts = PROMPTS[model]
    for _ in range(2):
        got, _ = run(p, prompts, SamplingParams, **GREEDY)
        want, _ = run(j, prompts, JaxSP, **GREEDY)
        assert got == want
    assert p.runner.swa is not None and j.runner.swa is not None
    assert p.stats.engine_steps_total == j.stats.engine_steps_total
    assert p.scheduler.num_preemptions == j.scheduler.num_preemptions
    assert (p._swa_sections.hits, p._swa_sections.captures) == (
        j._swa_sections.hits, j._swa_sections.captures)
    assert p._swa_sections.hits > 0
    assert_pools_match_jax(j, p)
    # Every ring went back to the pool: only retained sections hold pages.
    held = p.swa_allocator.num_pages - p.swa_allocator.num_free_pages
    assert held == p._swa_sections.retained_pages


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_ring_equals_no_ring(kv_dtype):
    """The port's ring engine against its own engine without the ring, on
    the same weights and schedule (distinct prompts: no prefix hit): equal
    streams, and its main pool bit-equal to the full layers' planes of
    the no-ring pool, so the sliding layers wrote nothing there."""
    j, ring = ring_engines("tiny-oss", kv_dtype=kv_dtype)
    plain = LLMEngine(dataclasses.replace(
        ring.config, cache=dataclasses.replace(ring.config.cache, swa_ring=False)),
        params=ring.runner.params, device="cpu")
    prompts = PROMPTS["tiny-oss"]
    got, _ = run(ring, prompts, SamplingParams, **GREEDY)
    assert got == run(plain, prompts, SamplingParams, **GREEDY)[0]
    full = list(ring.runner.swa.full_layers)
    for a, b in zip(pool_parts(ring.runner.kv_cache), pool_parts(plain.runner.kv_cache)):
        assert torch.equal(a, b[full])


@pytest.mark.parametrize("model,layout", [("tiny-oss", layout) for layout in RING_LAYOUTS]
                         + [("tiny-swa", "flat")])
def test_seeded_ring_streams_match_jax(model, layout):
    """Seeded sampling (temperature 0.8) on fresh engines. On tiny-oss the
    main pool (24 pages) is too small for the batch: recompute preemption
    releases the victim's ring. Streams, preemptions and pools as JAX's."""
    tight = model == "tiny-oss"
    j, p = ring_engines(model, num_blocks=24 if tight else 96, **LAYOUTS[layout])
    prompts = PROMPTS[model]
    got, _ = run(p, prompts, SamplingParams, **SEEDED)
    assert got == run(j, prompts, JaxSP, **SEEDED)[0]
    assert p.scheduler.num_preemptions == j.scheduler.num_preemptions
    assert (p.scheduler.num_preemptions > 0) == tight
    assert_pools_match_jax(j, p)


def test_waiting_hits_never_stall_the_engine():
    """The same tight pool, the prompts again: the repeats take hybrid
    hits at arrival and wait holding main-pool pages and rings, while the
    one running prefill waits for pages. A step that could schedule
    nothing releases the youngest waiting hit (it prefills later), so the
    run ends, with the streams of a cold engine. (The JAX engine, which
    releases no waiting hit there, spins on empty steps.)"""
    _, p = ring_engines("tiny-oss", num_blocks=24)
    prompts = PROMPTS["tiny-oss"]
    run(p, prompts, SamplingParams, **GREEDY)
    got, _ = run(p, prompts, SamplingParams, **SEEDED)
    assert p._swa_sections.hits > 0
    cold = port_engine(p.runner.params, "tiny-oss", num_blocks=24)
    assert got == run(cold, prompts, SamplingParams, **SEEDED)[0]


def test_a_step_that_would_schedule_nothing_frees_held_pages():
    """No ring: a tight pool where preempted requests, re-admitted, take
    their cached pages back as prefix hits and then wait for the rest,
    holding them, while the running sequence waits for a page. The JAX
    engine spins there on empty steps; the port releases the waiting
    requests' pages, and every request ends with the stream of an engine
    whose pool needs no preemption."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, size=32).tolist() for _ in range(6)]
    outs = []
    for blocks in (30, 96):
        eng = LLMEngine(tcfg.EngineConfig(
            model=tcfg.tiny_model_config(max_model_len=256),
            cache=tcfg.CacheConfig(page_size=4, num_blocks=blocks, dtype="float32"),
            scheduler=tcfg.SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=16),
        ), device="cpu")
        outs.append(run(eng, prompts, SamplingParams, temperature=0.0, max_tokens=24,
                        ignore_eos=True)[0])
        assert (eng.scheduler.num_preemptions > 0) == (blocks == 30)
    assert outs[0] == outs[1]


# --------------------------------------------------------------------- #
# hybrid prefix caching


def test_hybrid_hit_matches_cold_and_jax():
    """A repeated prompt seeds a fresh ring from its retained section and
    starts at n_pre pages (19 // 4 = 4 pages: 16 tokens); its stream is the
    cold one and JAX's. A longer prompt with that prefix hits at the
    retained span too (the multi-turn case) and gives a cold engine's
    stream."""
    j, p = ring_engines("alternating", max_batched=32, max_seqs=4)
    assert p.allocator.enable_prefix_caching
    prompt = [(31 * i + 6) % 47 for i in range(20)]
    sp = dict(temperature=0.0, max_tokens=10, ignore_eos=True)
    first, f1 = run(p, [prompt], SamplingParams, **sp)
    assert p._swa_sections.captures == 1 and f1[0].num_cached_tokens == 0
    second, f2 = run(p, [prompt], SamplingParams, **sp)
    assert second == first and f2[0].num_cached_tokens == 16
    assert p._swa_sections.hits == 1 and p.stats.swa_section_hits == 1
    for _ in range(2):
        want, jf = run(j, [prompt], JaxSP, **sp)
        assert want == first
    assert jf[0].num_cached_tokens == 16
    ext = prompt + [1, 2, 3, 4]
    third, f3 = run(p, [ext], SamplingParams, **sp)
    assert f3[0].num_cached_tokens == 16 and p._swa_sections.hits == 2
    cold = port_engine(p.runner.params, "alternating", max_batched=32, max_seqs=4)
    assert third == run(cold, [ext], SamplingParams, **sp)[0]
    assert third == run(j, [ext], JaxSP, **sp)[0]
    st = p.stats
    assert (st.swa_sections, st.swa_section_captures) == (2, 2)
    assert st.swa_ring_pages == p.swa_allocator.num_pages and st.swa_ring_usage > 0


def test_no_bare_prefix_hit_under_the_ring():
    """A main-pool hit whose section is gone is not taken: the request
    prefills from token 0 and decodes the cold stream."""
    _, p = ring_engines("alternating", max_batched=32, max_seqs=4)
    prompt = [(31 * i + 6) % 47 for i in range(20)]
    first, _ = run(p, [prompt], SamplingParams, **GREEDY)
    while p._swa_sections.evict_one():
        pass
    assert p.allocator.peek_hash_run(page_hashes_for_tokens(prompt, 4)) == 5
    again, f = run(p, [prompt], SamplingParams, **GREEDY)
    assert again == first and f[0].num_cached_tokens == 0


def test_sections_past_the_rings_pages_seed_right():
    """Four rings fill the rings' share of the pool, so the sections taken
    meanwhile land in the retention pages beyond it; a repeat seeded from
    one gives the stream of an engine without the ring. (The port's ring
    pool holds the retention pages; JAX's device pool is sized to the
    rings alone, so there those sections fall outside it.)"""
    _, p = ring_engines("alternating", max_batched=32, max_seqs=4, num_blocks=128)
    plain = port_engine(p.runner.params, "alternating", ring=False, max_batched=32, max_seqs=4,
                        num_blocks=128)
    prompts = [[(7 * i + 3 * k + 1) % 90 + 1 for i in range(20)] for k in range(4)]
    sp = dict(temperature=0.0, max_tokens=12, ignore_eos=True)
    run(p, prompts, SamplingParams, **sp)
    rings = 4 * p.runner.swa.ring_pages - 8 * p.runner.swa.max_section_pages(4)
    assert max(max(e[2]) for e in p._swa_sections._entries.values()) >= rings
    got, f = run(p, [prompts[3]], SamplingParams, **sp)
    assert f[0].num_cached_tokens == 16
    assert got == run(plain, prompts, SamplingParams, **sp)[0][3:]


def test_section_cache_off_turns_prefix_caching_off():
    _, p = ring_engines("alternating", cache=dict(swa_section_cache=0))
    assert not p.allocator.enable_prefix_caching and p._swa_sections is None
    assert p.swa_allocator.num_pages == 8 * p.runner.swa.ring_pages


# --------------------------------------------------------------------- #
# lifecycle


def test_rings_released_on_finish_and_reused():
    _, p = ring_engines("alternating", max_batched=32, max_seqs=4)
    R = p.runner.swa.ring_pages
    for _ in range(3):
        run(p, [[1, 2, 3, 4, 5, 6, 7, 8]], SamplingParams, temperature=0.0, max_tokens=6)
        retained = p._swa_sections.retained_pages
        assert retained > 0
        assert p.swa_allocator.num_free_pages == p.swa_allocator.num_pages - retained
    p.add_request([9, 8, 7, 6, 5], SamplingParams(max_tokens=50, temperature=0.0, ignore_eos=True))
    p.step()
    held = p.swa_allocator.num_pages - p.swa_allocator.num_free_pages
    assert held == R + p._swa_sections.retained_pages


def test_failed_admission_returns_its_ring():
    """The ring is allocated, the main pool has no pages: the waiting
    request gives its ring back."""
    _, p = ring_engines("alternating", num_blocks=8, max_batched=32, max_seqs=4)
    sp = SamplingParams(temperature=0.0, max_tokens=64, ignore_eos=True)
    p.add_request([1, 2, 3, 4] * 6, sp)  # 6 of the 8 pages
    p.step()
    free_before = p.swa_allocator.num_free_pages
    p.add_request([9, 8, 7, 6] * 5, sp)
    p.step()
    waiting = list(p.scheduler.waiting)
    assert waiting and not waiting[0].swa_block_ids
    assert p.swa_allocator.num_free_pages == free_before


def test_ring_pressure_evicts_retained_sections():
    """Live sequences outrank retention: with one page short of two rings
    free, the second admission's ring allocation fails, frees retained
    sections until it fits, and both requests run."""
    _, p = ring_engines("alternating", max_batched=32, max_seqs=2)
    for i in range(4):
        run(p, [[(7 * i + j) % 45 + 1 for j in range(12)]], SamplingParams,
            temperature=0.0, max_tokens=2)
    retained = len(p._swa_sections)
    assert retained > 0
    R = p.runner.swa.ring_pages
    hog = p.swa_allocator.allocate(p.swa_allocator.num_free_pages - (2 * R - 1))
    outs, _ = run(p, [[1, 2, 3], [2, 3, 4]], SamplingParams, temperature=0.0, max_tokens=12,
                  ignore_eos=True)
    assert [len(o) for o in outs] == [12, 12]
    assert p.stats.engine_steps_total and len(p._swa_sections) < retained
    p.swa_allocator.free(hog)


def test_waiting_hit_yields_its_ring_to_the_queue_head():
    """A ringless request at the head of the queue, nothing running, and
    the pool's last ring held by a later arrival that took a hybrid hit:
    the step that would schedule nothing releases the hit's ring and pages
    (it prefills later, from its first token), and the head runs."""
    _, p = ring_engines("alternating", max_batched=32, max_seqs=2)
    prompt = [(31 * i + 6) % 47 for i in range(20)]
    sp = SamplingParams(temperature=0.0, max_tokens=4, ignore_eos=True)
    run(p, [prompt], SamplingParams, temperature=0.0, max_tokens=4, ignore_eos=True)
    # Fill the pool to one ring short of empty, so each hit takes the last.
    R = p.runner.swa.ring_pages
    hog = p.swa_allocator.allocate(p.swa_allocator.num_free_pages - R)
    head = p.add_request([5, 6, 7], sp)
    p.scheduler.waiting[0].arrival_time = -1.0  # the queue head
    hit = p.add_request(prompt, sp)
    hit_req = next(r for r in p.scheduler.waiting if r.request_id == hit)
    assert hit_req.swa_block_ids and hit_req.num_computed_tokens == 16
    out = {}
    while p.has_work():
        for o in p.step():
            out.setdefault(o.request_id, []).extend(o.new_token_ids)
    assert len(out[head]) == 4 and len(out[hit]) == 4
    assert hit_req.num_cached_tokens == 0  # released: it prefilled from its first token
    p.swa_allocator.free(hog)


def test_footprint_drops_for_long_context():
    """tests/test_swa_ring.py:174's case: at max_model_len 4096 the ring
    pool is far smaller than the full-length planes it replaces, and the
    pools' bytes fall below 0.6 of the no-ring pool's; as JAX's."""
    over = dict(ALTERNATING, max_model_len=4096)
    sizes = {}
    for ring in (False, True):
        for pkg, cfg in (("jax", jcfg), ("port", tcfg)):
            config = cfg.EngineConfig(
                model=cfg.tiny_model_config(**over),
                cache=cfg.CacheConfig(page_size=4, num_blocks=1024, dtype="float32", swa_ring=ring),
                scheduler=cfg.SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=32),
            )
            if pkg == "jax":
                eng = JaxEngine(config)
            else:
                eng = LLMEngine(config, device="cpu")
            sizes[pkg, ring] = eng.runner.kv_bytes()
            if ring:
                assert eng.runner.swa.num_swa_blocks < 1024
    assert sizes["port", False] == sizes["jax", False]
    assert sizes["port", True] < 0.6 * sizes["port", False]
    assert sizes["jax", True] < 0.6 * sizes["jax", False]


def test_ring_ignored_for_full_attention_models():
    """swa_ring on a model without sliding layers changes nothing."""
    eng = LLMEngine(tcfg.EngineConfig(
        model=tcfg.tiny_model_config(),
        cache=tcfg.CacheConfig(page_size=4, num_blocks=32, dtype="float32", swa_ring=True),
    ), device="cpu")
    assert eng.runner.swa is None and eng.runner.kv_swa is None and eng.swa_allocator is None
    assert eng.allocator.enable_prefix_caching


# --------------------------------------------------------------------- #
# decode programs


def ring_decode_rows(rng, n, page, R, ring_pages, num_blocks):
    """``n`` requests in decode with distinct main pages and rings, at
    contexts past the ring (the write wraps)."""
    main = rng.permutation(num_blocks)
    rings = rng.permutation(ring_pages)
    rows, off = [], 0
    for i in range(n):
        length = int(rng.integers(R * page + 1, 3 * R * page))
        need = -(-(length + 1) // page)
        req = Request(f"r{i}", rng.integers(0, 256, size=length).tolist(),
                      SamplingParams(temperature=0.0))
        req.output_token_ids = [int(rng.integers(0, 256))]
        req.num_computed_tokens = length
        req.block_ids = main[off : off + need].tolist()
        req.swa_block_ids = rings[i * R : (i + 1) * R].tolist()
        off += need
        rows.append(ScheduledSeq(req, 1))
    return rows


@pytest.mark.parametrize("family", ["flat", "window"])
def test_decode_programs_write_through_the_ring_table(family):
    """A decode-only flat step and a decode window run as programs whose
    static inputs hold ``swa_table`` beside ``page_table``; the write of
    position p lands at ``ring[(p // page) % R]`` on the sliding layer's
    plane of the ring pool, and at ``block_ids[p // page]`` on the full
    layer's plane of the main pool, and nowhere else."""
    sched = {} if family == "flat" else dict(unified_step=False)
    cfg = tcfg.EngineConfig(
        model=tcfg.tiny_model_config(**TINY_OSS, max_model_len=512),
        cache=tcfg.CacheConfig(page_size=4, num_blocks=400, dtype="float32", swa_ring=True),
        scheduler=tcfg.SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=16, **sched),
    )
    p = LLMEngine(cfg, device="cpu")
    r = p.runner
    R = r.swa.ring_pages
    rows = ring_decode_rows(np.random.default_rng(3), 5, r.page, R, r.swa.num_swa_blocks, 400)
    for pool in (r.kv_cache, r.kv_swa):
        pool.normal_(generator=torch.Generator().manual_seed(1))
    main0, swa0 = r.kv_cache.clone(), r.kv_swa.clone()
    if family == "flat":
        r.wait_step(unified=r.dispatch_unified([], rows))
        key = ("flat", 16, True)
    else:
        r.wait_step(decode=r.dispatch_staged_decode(r.stage_decode(rows, 1)))
        key = ("window", 8, 1, True)
    assert r.programs.runs == {key: 1}
    prog = r.programs.programs[key]
    table = prog.inputs.views["swa_table"]
    for i, s in enumerate(rows):
        np.testing.assert_array_equal(table[i].numpy(), r._swa_table([s.request], 1)[0])

    def changed(a, b):
        return {(int(pg), int(t)) for pg, t in (a != b).flatten(start_dim=4).any(-1).any(2).any(0).nonzero()}

    want_main, want_swa = set(), set()
    for s in rows:
        pos = s.start_pos
        want_main.add((s.request.block_ids[pos // r.page], pos % r.page))
        want_swa.add((s.request.swa_block_ids[(pos // r.page) % R], pos % r.page))
    assert changed(r.kv_cache, main0) == want_main
    assert changed(r.kv_swa, swa0) == want_swa
