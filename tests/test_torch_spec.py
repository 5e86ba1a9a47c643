"""Speculative decoding of the port (``SchedulerConfig.speculative_ngram``)
against the JAX package's, on the CPU.

The contract of ``tests/test_spec_decode.py``: n-gram drafts verified in one
pass change how many tokens a step emits, never which. Here the pieces are
held to their JAX counterparts first (the proposer, the acceptance rule on
tensors and on the host, the tensor form of ``spec_seed``, the
configuration's window set and checks, the ring's chunk term), then the
engines: the same requests through the JAX speculative engine, the port's
speculative engine on its parameters and the port's engine without
speculative decoding. The streams must be equal token for token, and the
speculative counters (proposed, accepted, the accepted-length histogram,
the fused verify windows' iterations and early exits) equal to the JAX
scheduler's exactly, with drafts accepted in every case; on the flat step,
the bucketed unified step and the split engine, synchronous and async, at
verify windows 1, 2 and 4, 64 tokens a request so that a window of 4 has
steps to draft in. The allocators end empty, rejected drafts never reach
the prefix index, and a synchronous row holds no page past its computed
span between steps. This file runs the flat step; the bucketed unified
step and the split engine are in ``test_torch_spec_layouts.py``, the other
models and pools and the server in ``test_torch_spec_models.py`` and MLA
in ``test_torch_spec_mla.py``: files of their own, so that a parallel run
spreads them over four workers. Engines are built once for the module,
and the JAX engines share XLA's persistent
compilation cache (``jax_compile_cache``): the engines of one model compile
the same programs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llmd_tpu.config as jcfg
import llmd_tpu.engine.sampler as jsampler
import llmd_tpu_torch.config as tcfg
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine import SamplingParams as JaxSP
from llmd_tpu.engine.kv_cache import page_hashes_for_tokens
from llmd_tpu.engine.spec import NgramProposer as JaxProposer
from llmd_tpu.models.registry import get_model_config as jax_model_config
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.engine.sampler import accept_counts, accept_draft_tokens, spec_seed
from llmd_tpu_torch.engine.spec import NgramProposer
from llmd_tpu_torch.models.llama import params_from_jax
from llmd_tpu_torch.models.registry import get_model_config

# tests/test_spec_decode.py's prompts: periodic, so the tiny model's greedy
# output loops and drafts both accept and reject.
PROMPTS = [
    [1, 5, 9, 13] * 3,
    [3, 3, 7, 1, 3, 3, 7, 1],
    [1, 5, 9, 13, 2, 8, 4, 4, 4, 4, 6, 6, 6, 6, 11],
]
GREEDY = dict(temperature=0.0, max_tokens=64, ignore_eos=True)
SEEDED = dict(temperature=0.3, seed=77, max_tokens=64, ignore_eos=True)
# tiny-swa with a window of 16: tiny-swa's 64 leaves a ring as long as the
# page table at a 64-token budget (no ring at all).
TINY_CONFIGS = {"tiny-swa16": dict(name="tiny-swa", sliding_window=16,
                                   layer_types=("sliding_attention", "full_attention"))}
LAYOUTS = {"flat": {}, "bucketed": dict(ragged_qlens=False), "split": dict(unified_step=False),
           "default": {}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: faster on these tiny models than many, above
    all while test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE_OPTIONS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
                  "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(scope="module", autouse=True)
def jax_compile_cache(tmp_path_factory):
    """XLA's persistent compilation cache in a directory of the module's,
    for the module only: each JAX engine jits its programs anew, and the
    engines of one model compile the same ones (about 2.5x less time a
    JAX engine here)."""
    from jax._src import compilation_cache

    saved = {name: getattr(jax.config, name) for name in _CACHE_OPTIONS}
    for name, value in zip(_CACHE_OPTIONS, (str(tmp_path_factory.mktemp("xla")), 0, 0)):
        jax.config.update(name, value)
    compilation_cache.reset_cache()
    yield
    for name, value in saved.items():
        jax.config.update(name, value)
    compilation_cache.reset_cache()


# --------------------------------------------------------------------- #
# the proposer, the acceptance rule and the seeds


def histories():
    """Seeded random histories over small vocabularies (matches at every
    length), periodic ones and their mixes."""
    rng = np.random.default_rng(5)
    out = [rng.integers(0, v, size=n).tolist() for v in (2, 3, 5, 50) for n in (1, 3, 9, 40, 90)]
    out += [([7, 8, 9] * 12)[:n] for n in (2, 5, 17, 36)]
    out += [[1, 2] * 6 + rng.integers(0, 4, size=20).tolist() + [1, 2, 1]]
    return out


@pytest.mark.parametrize("min_match", [1, 2, 3])
def test_proposer_is_the_jax_proposer(min_match):
    """Every prefix of every history, at k in 0..5, stateless and through
    one incremental state per history, equals JAX's."""
    for toks in histories():
        mine, ref = NgramProposer(min_match), JaxProposer(min_match)
        st, jst = mine.new_state(), ref.new_state()
        for n in range(len(toks) + 1):
            for k in range(6):
                want = ref.propose(toks[:n], k)
                assert mine.propose(toks[:n], k) == want, (toks[:n], k)
            want = ref.propose(toks[:n], 4, jst)
            assert mine.propose(toks[:n], 4, st) == want == ref.propose(toks[:n], 4)
        assert st == jst


def test_proposer_caps_candidates_as_jax():
    """A long periodic history matches at every period: only the newest
    ``_MAX_CANDIDATES`` are scored, in both packages."""
    assert NgramProposer._MAX_CANDIDATES == JaxProposer._MAX_CANDIDATES
    rng = np.random.default_rng(1)
    toks = ([4, 5] * 60 + rng.integers(0, 3, size=7).tolist()) * 3 + [4, 5]
    assert NgramProposer(2).propose(toks, 5) == JaxProposer(2).propose(toks, 5)
    with pytest.raises(ValueError):
        NgramProposer(0)


@pytest.mark.parametrize("seed", range(4))
def test_accept_counts_is_the_jax_rule(seed):
    """Random drafts and targets over a small vocabulary (long accepted
    runs), ragged ``draft_len`` including 0 and the full width."""
    rng = np.random.default_rng(seed)
    B, k = 64, 5
    draft = rng.integers(0, 3, size=(B, k))
    target = np.where(rng.random((B, k + 1)) < 0.8, np.pad(draft, ((0, 0), (0, 1))),
                      rng.integers(0, 3, size=(B, k + 1)))
    dlen = rng.integers(0, k + 1, size=B)
    want = jsampler.accept_counts(jnp.asarray(draft), jnp.asarray(target), jnp.asarray(dlen))
    got = accept_counts(torch.from_numpy(draft), torch.from_numpy(target), torch.from_numpy(dlen))
    for g, w in zip(got, want):
        assert g.tolist() == np.asarray(w).tolist()
    for i in range(B):
        d, t = draft[i, : dlen[i]].tolist(), target[i, : dlen[i] + 1].tolist()
        assert accept_draft_tokens(d, t) == jsampler.accept_draft_tokens(d, t)
        # a sample window shorter than the draft, and no samples at all
        assert accept_draft_tokens(d, t[:2]) == jsampler.accept_draft_tokens(d, t[:2])
    assert accept_draft_tokens([4], []) == jsampler.accept_draft_tokens([4], []) == ([], 0)


def test_tensor_spec_seed_is_bit_equal_to_the_jax_forms():
    """The int64 tensor form equals JAX's uint32 array form and the
    Python-int form at the edges: seed 0 and 2**32 - 1, indices up to
    2**32 - 1, sums that wrap."""
    seeds = np.array([0, 1, 77, 1000003, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint32)
    idx = np.array([0, 1, 63, 4097, 2**20, 2**31, 2**32 - 1], np.uint32)
    S, I = np.meshgrid(seeds, idx, indexing="ij")
    want = np.asarray(jsampler.spec_seed(jnp.asarray(S), jnp.asarray(I)))
    got = spec_seed(torch.from_numpy(S.astype(np.int64)), torch.from_numpy(I.astype(np.int64)))
    assert got.dtype == torch.int64
    assert got.numpy().astype(np.uint32).tolist() == want.tolist()
    assert (got.numpy() >= 0).all() and (got.numpy() < 2**32).all()
    for s, i in zip(S.ravel().tolist(), I.ravel().tolist()):
        assert spec_seed(s, i) == jsampler.spec_seed(s, i)


# --------------------------------------------------------------------- #
# the configuration


@pytest.mark.parametrize("window,verify", [(1, 0), (2, 0), (4, 0), (8, 0), (6, 0), (8, 3),
                                           (1, 5), (4, 1)])
def test_spec_window_set_is_jax(window, verify):
    kw = dict(speculative_ngram=True, decode_window=window, spec_verify_window=verify)
    mine, ref = tcfg.SchedulerConfig(**kw), jcfg.SchedulerConfig(**kw)
    assert (mine.spec_window, mine.spec_window_set) == (ref.spec_window, ref.spec_window_set)
    off = dict(decode_window=window)
    assert tcfg.SchedulerConfig(**off).spec_window == jcfg.SchedulerConfig(**off).spec_window == 1


@pytest.mark.parametrize("kw", [
    dict(spec_verify_window=-1), dict(spec_verify_window=2),
    dict(speculative_ngram=True, spec_ngram_k=0), dict(speculative_ngram=True, spec_ngram_min_match=0),
    dict(speculative_ngram=True, decode_window=4, max_num_batched_tokens=9),
    dict(speculative_ngram=True, spec_verify_window=2, spec_ngram_k=7, max_num_batched_tokens=15),
])
def test_spec_config_checks_are_jax(kw):
    with pytest.raises(ValueError) as mine:
        tcfg.SchedulerConfig(**kw)
    with pytest.raises(ValueError) as ref:
        jcfg.SchedulerConfig(**kw)
    assert str(mine.value) == str(ref.value)
    # the boundary passes in both
    ok = dict(speculative_ngram=True, decode_window=4, max_num_batched_tokens=10)
    tcfg.SchedulerConfig(**ok)
    jcfg.SchedulerConfig(**ok)


@pytest.mark.parametrize("sched", [
    dict(speculative_ngram=True), dict(speculative_ngram=True, decode_window=4),
    dict(speculative_ngram=True, spec_ngram_k=7, spec_verify_window=8),
    dict(speculative_ngram=True, decode_window=8, max_num_batched_tokens=16),
])
def test_swa_ring_spec_takes_the_speculative_chunk_term(sched):
    """gpt-oss-20b and tiny-swa: the ring of a speculative engine is the
    JAX ring, chunk term (1 + k) x window included."""
    for name, page, budget in (("gpt-oss-20b", 16, 2048), ("tiny-swa", 4, 16)):
        s = dict(dict(max_num_batched_tokens=budget), **sched)
        cache = dict(page_size=page, swa_ring=True)
        mine = tcfg.swa_ring_spec(get_model_config(name), tcfg.CacheConfig(**cache),
                                  tcfg.SchedulerConfig(**s))
        ref = jcfg.swa_ring_spec(jax_model_config(name), jcfg.CacheConfig(**cache),
                                 jcfg.SchedulerConfig(**s))
        # (None where the ring would be as long as the page table)
        assert mine == ref or dataclasses.astuple(mine) == dataclasses.astuple(ref)
        assert name != "gpt-oss-20b" or mine is not None
    sc = tcfg.SchedulerConfig(speculative_ngram=True, spec_ngram_k=7, spec_verify_window=8,
                              max_num_batched_tokens=16)
    spec = tcfg.swa_ring_spec(get_model_config("gpt-oss-20b"), tcfg.CacheConfig(swa_ring=True), sc)
    assert spec.chunk_tokens == 64 and spec.ring_pages == -(-(128 + 64) // 16) + 1


# --------------------------------------------------------------------- #
# the engines


def build(model="tiny", layout="flat", window=1, async_mode=False, kv="float32",
          quantization=None, ring=False, page=4, num_blocks=96, max_batched=64):
    """(JAX speculative engine, the port's on its parameters, the port's
    engine without speculative decoding on the same parameters)."""
    cache = dict(page_size=page, num_blocks=num_blocks, dtype=kv, swa_ring=ring)
    sched = dict(max_num_seqs=8, max_num_batched_tokens=max_batched, decode_window=window,
                 async_scheduling=async_mode, **LAYOUTS[layout])
    spec = dict(speculative_ngram=True, spec_ngram_k=4)
    if model == "tiny":
        jmodel = jcfg.tiny_model_config(quantization=quantization)
        tmodel = tcfg.tiny_model_config(quantization=quantization)
    elif model in TINY_CONFIGS:
        jmodel = jcfg.tiny_model_config(**TINY_CONFIGS[model])
        tmodel = tcfg.tiny_model_config(**TINY_CONFIGS[model])
    else:
        jmodel, tmodel = jax_model_config(model), get_model_config(model)
    j = JaxEngine(jcfg.EngineConfig(
        model=jmodel, cache=jcfg.CacheConfig(**cache),
        scheduler=jcfg.SchedulerConfig(**sched, **spec),
        parallel=jcfg.ParallelConfig(tensor_parallel_size=1),
    ))
    params = params_from_jax(jax.tree.map(np.asarray, j.runner.params))

    def port(**extra):
        return LLMEngine(tcfg.EngineConfig(
            model=tmodel, cache=tcfg.CacheConfig(**cache),
            scheduler=tcfg.SchedulerConfig(**sched, **extra)), params=params, device="cpu")

    return j, port(**spec), port()


@pytest.fixture(scope="module")
def trios():
    """Engines by configuration, built once for the module."""
    cache = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            cache[key] = build(**kw)
        return cache[key]

    return get


def counters(sched) -> tuple:
    return (sched.spec_proposed_tokens, sched.spec_accepted_tokens,
            list(sched.spec_accept_len_hist), sched.spec_window_iters,
            sched.spec_window_early_exit)


def committed_hashes_are_accepted(eng, prompts, streams):
    """Every hash of the allocator's prefix index re-derives from some
    request's accepted prompt + output (``tests/test_spec_decode.py``'s
    walk): a committed page of rejected draft content fails it."""
    page = eng.allocator.page_size
    legit: set[bytes] = set()
    for prompt, out in zip(prompts, streams):
        legit.update(page_hashes_for_tokens(list(prompt) + list(out), page))
    committed = set(eng.allocator._cached)
    assert committed, "no page was committed: the walk proved nothing"
    assert committed <= legit


# Every stream a port engine emitted, for the prefix-index walk.
_EMITTED: dict[int, list] = {}


def run_case(trio, prompts=PROMPTS, sps=None):
    """The prompts (greedy, then again seeded, in one batch) through the
    three engines of ``trio``. Streams equal token for token, counters
    equal to the JAX scheduler's, drafts accepted, pools empty, the prefix
    index holding accepted tokens only. Returns the port's speculative
    engine."""
    j, p, off = trio
    sps = sps or [GREEDY] * len(prompts) + [SEEDED] * len(prompts)
    prompts = list(prompts) * (len(sps) // len(prompts))
    before = counters(p.scheduler)
    want = list(j.generate(prompts, [JaxSP(**s) for s in sps]).values())
    got = list(p.generate(prompts, [SamplingParams(**s) for s in sps]).values())
    plain = list(off.generate(prompts, [SamplingParams(**s) for s in sps]).values())
    assert got == want
    assert got == plain
    assert counters(p.scheduler) == counters(j.scheduler)
    assert p.scheduler.spec_accepted_tokens > before[1]
    for eng in (p, j):
        assert not eng.has_work() and eng.allocator.usage() == 0.0
    assert p.stats.async_rollbacks_total == j.stats.async_rollbacks_total
    assert p.scheduler.num_preemptions == j.scheduler.num_preemptions
    if p.allocator.enable_prefix_caching:
        emitted = _EMITTED.setdefault(id(p), [])
        emitted += zip(prompts, got)
        committed_hashes_are_accepted(p, *zip(*emitted))
    return p


def case_id(layout, window, async_mode) -> str:
    return f"{layout}-w{window}-{'async' if async_mode else 'sync'}"


# (window, async) of the flat step on tiny; window 2 runs in
# ``test_stats_fill_as_jax``, the other layouts' cases are in
# test_torch_spec_layouts.py.
FLAT_CASES = [("flat", w, a) for w in (1, 4) for a in (False, True)]


def streams_and_counters_case(trios, layout, window, async_mode):
    p = run_case(trios(layout=layout, window=window, async_mode=async_mode))
    st = p.stats
    assert st.spec_proposed_tokens_total == p.scheduler.spec_proposed_tokens > 0
    assert st.spec_accepted_len_hist == tuple(p.scheduler.spec_accept_len_hist)
    if window > 1:
        # the windows engaged
        assert p.scheduler.spec_window_iters > 0


@pytest.mark.parametrize("layout,window,async_mode", FLAT_CASES,
                         ids=[case_id(*c) for c in FLAT_CASES])
def test_streams_and_counters_match_jax(trios, layout, window, async_mode):
    streams_and_counters_case(trios, layout, window, async_mode)


def test_window_four_accepts_on_the_jax_workload(trios):
    """The JAX spec-window tests' workload at 64 tokens: the JAX engine
    proposes 35 drafts and accepts 13 at window 4, and so does the port."""
    j, p, _ = trios(window=4, num_blocks=64)
    want = list(j.generate(PROMPTS, JaxSP(**GREEDY)).values())
    assert list(p.generate(PROMPTS, SamplingParams(**GREEDY)).values()) == want
    assert counters(p.scheduler) == counters(j.scheduler)
    assert counters(p.scheduler)[:2] == (35, 13)


def test_sync_rows_hold_no_page_past_their_span(trios):
    """Between steps of the synchronous engine no running row keeps more
    than one page past its computed span (the provisional writes' pages
    are freed), on one-shot steps and on verify windows."""
    for window in (1, 4):
        _, p, _ = trios(window=window)
        for prompt in PROMPTS:
            p.add_request(list(prompt), SamplingParams(**GREEDY))
        drafted = 0
        while p.has_work():
            p.step()
            drafted = p.scheduler.spec_proposed_tokens
            page = p.allocator.page_size
            for r in p.scheduler.running:
                assert len(r.block_ids) <= -(-r.num_computed_tokens // page) + 1
        assert drafted > 0 and p.allocator.usage() == 0.0


def test_async_rollback_of_a_verify_window_row(trios):
    """Requests of different lengths finish while the next verify window is
    staged: their rows roll back (as many as in JAX) and the survivors'
    streams stay equal."""
    sps = [dict(GREEDY, max_tokens=m) for m in (9, 23, 41)] * 2
    _, p, _ = trios(window=4, async_mode=True)
    r0 = p.stats.async_rollbacks_total
    run_case(trios(window=4, async_mode=True), PROMPTS * 2, sps)
    assert p.stats.async_rollbacks_total > r0


def test_stats_fill_as_jax(trios):
    """The spec fields of ``EngineStats`` as the JAX engine fills them."""
    j, p, _ = trios(window=2)
    run_case(trios(window=2))
    names = ("spec_proposed_tokens_total", "spec_accepted_tokens_total", "spec_acceptance_rate",
             "spec_accepted_len_hist", "spec_window_iters_total", "spec_window_early_exit_total",
             "spec_row_depth_hist", "decode_dispatches_total", "generation_tokens")
    assert {n: getattr(p.stats, n) for n in names} == {n: getattr(j.stats, n) for n in names}
