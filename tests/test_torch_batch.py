"""The batch tier (``SchedulerConfig.batch_backfill``, ``PriorityClass``) of
the port against the JAX package's, on the CPU.

The contract of ``tests/test_batch_backfill.py``: requests at or below
``PriorityClass.BATCH`` only backfill the budget and pages interactive rows
leave, never displace an interactive admission, are the first preemption
victims when interactive load returns, and never evict an interactive row;
so interactive streams are the same with and without them. Here the JAX
scheduler and the port's take the same requests, step by step, in each
case of that file and in a seeded random mix (and under speculative
decoding and with a step in flight), and every scheduled batch, counter
and queue must be equal. Then the engines: interactive requests with and
without a batch backlog on the port, and with it on the JAX engine, on the
flat step, the bucketed unified step, the split engine with decode windows
of 4, async stepping and speculative decoding; every stream equal to
JAX's, the interactive ones equal to the run without the backlog, the
batch counters equal, batch rows never drafted. Last the server: the
``x-llmd-priority`` clamp equal to JAX's, and a JAX server and the port's
taking interactive and batch-header requests, whose ``/metrics`` pages
agree. Engines are built once for the module, and the JAX engines share
XLA's persistent compilation cache.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import make_mocked_request

import llmd_tpu.config as jcfg
import llmd_tpu.engine.kv_cache as jkv
import llmd_tpu.engine.request as jreq
import llmd_tpu.engine.scheduler as jsched
import llmd_tpu.serve.api as japi
import llmd_tpu_torch.config as tcfg
import llmd_tpu_torch.engine.kv_cache as tkv
import llmd_tpu_torch.engine.request as treq
import llmd_tpu_torch.engine.scheduler as tsched
import llmd_tpu_torch.serve.api as tapi
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine import SamplingParams as JaxSP
from llmd_tpu.epp.types import BATCH_PRIORITY
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.models.llama import params_from_jax
from llmd_tpu_torch.serve.metrics import render_metrics

import test_torch_serve_surface as surface
from test_torch_spec import jax_compile_cache, one_thread  # noqa: F401 (module fixtures)

BATCH = int(treq.PriorityClass.BATCH)
PKGS = {
    "jax": (jcfg, jkv, jreq, jsched),
    "port": (tcfg, tkv, treq, tsched),
}


def test_priority_class_is_the_jax_one():
    """The band's values are JAX's (and so the router's batch filter's)."""
    assert {m.name: int(m) for m in treq.PriorityClass} == {
        m.name: int(m) for m in jreq.PriorityClass}
    assert BATCH == BATCH_PRIORITY
    assert treq.Request("r", [1], priority=BATCH).is_batch
    assert not treq.Request("r", [1], priority=BATCH + 1).is_batch


@pytest.mark.parametrize("kw", [
    dict(batch_kv_watermark=0.0), dict(batch_kv_watermark=1.5), dict(batch_max_seqs=-1),
    dict(batch_kv_watermark=1.0, batch_max_seqs=3, batch_backfill=False),
])
def test_config_checks_are_jax_ones(kw):
    """The batch fields' defaults and ``__post_init__`` checks are JAX's."""
    for name in ("batch_backfill", "batch_max_seqs", "batch_kv_watermark"):
        assert getattr(tcfg.SchedulerConfig(), name) == getattr(jcfg.SchedulerConfig(), name)
    try:
        jcfg.SchedulerConfig(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            tcfg.SchedulerConfig(**kw)
    else:
        tcfg.SchedulerConfig(**kw)


# --------------------------------------------------------------------- #
# the scheduler, step by step against JAX's


class Env:
    """One package's scheduler pieces, and a log of what each step
    scheduled and left."""

    def __init__(self, pkg: str) -> None:
        self.cfg, self.kv, self.req_mod, self.sched_mod = PKGS[pkg]
        self.log: list = []

    def sched(self, max_seqs=4, budget=16, pages=16, page=4, max_model_len=128,
              prefix=False, **kw):
        sc = self.cfg.SchedulerConfig(max_num_seqs=max_seqs, max_num_batched_tokens=budget, **kw)
        cc = self.cfg.CacheConfig(page_size=page, num_blocks=pages)
        alloc = self.kv.PageAllocator(num_pages=pages, page_size=page, enable_prefix_caching=prefix)
        return self.sched_mod.EngineScheduler(sc, cc, alloc, max_model_len=max_model_len)

    def req(self, rid, n=4, priority=0, max_tokens=64, first=1, arrival=0.0):
        r = self.req_mod
        return r.Request(request_id=rid, prompt_token_ids=list(range(first, first + n)),
                         sampling=r.SamplingParams(max_tokens=max_tokens, ignore_eos=True),
                         priority=priority, arrival_time=arrival)

    def schedule(self, sched):
        batch = sched.schedule()
        self.log.append(self.describe(batch, sched))
        return batch

    def step(self, sched, token=7):
        """Schedule and commit one step: a prefill row samples one token, a
        decode window K, a speculative row (no draft here) one."""
        batch = self.schedule(sched)
        sampled = {s.request.request_id: [token] for s in batch.prefills}
        for s in batch.decodes:
            sampled[s.request.request_id] = [token] * (s.num_tokens if s.draft_tokens is None else 1)
        sched.update_after_step(batch, sampled)
        self.log.append(self.state(sched))
        return batch

    @staticmethod
    def describe(batch, sched):
        return (
            [(s.request.request_id, s.num_tokens) for s in batch.prefills],
            [(s.request.request_id, s.num_tokens, s.spec_draft_cap, s.draft_tokens is None)
             for s in batch.decodes],
            batch.spec_window, sched.last_batch_backfill_tokens,
        )

    @staticmethod
    def state(sched):
        return (
            [r.request_id for r in sched.waiting], [r.request_id for r in sched.running],
            [(r.request_id, r.status.name, len(r.block_ids), r.num_computed_tokens)
             for r in sched.waiting + sched.running],
            sched.batch_tokens, sched.num_batch_preemptions, sched.num_preemptions,
            sched.allocator.num_free_pages,
        )


def ids(batch):
    return {s.request.request_id for s in batch.seqs}


def case_leftover_budget(e):
    s = e.sched(budget=8)
    s.add_request(e.req("i0", n=8))
    s.add_request(e.req("b0", n=4, priority=BATCH, arrival=1))
    b1 = e.step(s)
    assert [x.request.request_id for x in b1.prefills] == ["i0"]
    b2 = e.step(s)
    assert ids(b2) == {"i0", "b0"} and s.last_batch_backfill_tokens == 4


def case_blocked_head(e):
    s = e.sched(pages=4, page=4, budget=64)
    s.add_request(e.req("i0", n=8))
    e.step(s)
    s.add_request(e.req("i1", n=12, arrival=1))
    s.add_request(e.req("b0", n=4, priority=BATCH, arrival=2))
    b = e.schedule(s)
    assert not {"b0", "i1"} & ids(b)


def case_admission_preempts_batch_slots(e):
    s = e.sched(max_seqs=2, budget=64)
    s.add_request(e.req("b0", n=4, priority=BATCH))
    s.add_request(e.req("b1", n=4, priority=BATCH, arrival=1))
    e.step(s)
    s.add_request(e.req("i0", n=4, arrival=2))
    b = e.step(s)
    assert "i0" in ids(b) and s.num_batch_preemptions == 1


def case_page_pressure_reclaims_batch(e):
    s = e.sched(pages=4, page=4, budget=64)
    s.add_request(e.req("i0", n=7))
    s.add_request(e.req("b0", n=7, priority=BATCH, arrival=1))
    e.step(s)
    s.add_request(e.req("i1", n=8, arrival=2))
    b = e.step(s)
    assert "i1" in ids(b) and s.num_batch_preemptions == 1
    assert any(r.request_id == "i0" for r in s.running)


def case_never_preempts_interactive(e):
    s = e.sched(pages=4, page=4, budget=64)
    s.add_request(e.req("b0", n=7, priority=BATCH))
    e.step(s)
    s.add_request(e.req("i0", n=7, arrival=1))
    for _ in range(8):
        e.step(s)
    assert s.num_preemptions == s.num_batch_preemptions > 0
    assert any(r.request_id == "i0" for r in s.running)


def case_kv_watermark(e):
    s = e.sched(pages=8, page=4, budget=64, batch_kv_watermark=0.5)
    s.add_request(e.req("i0", n=20))
    e.step(s)
    s.add_request(e.req("b0", n=4, priority=BATCH, arrival=1))
    assert "b0" not in ids(e.step(s))


def case_max_seqs_cap(e):
    s = e.sched(max_seqs=4, budget=64, batch_max_seqs=1)
    s.add_request(e.req("b0", n=4, priority=BATCH))
    s.add_request(e.req("b1", n=4, priority=BATCH, arrival=1))
    assert [x.request.request_id for x in e.step(s).prefills] == ["b0"]
    e.step(s)


def case_pins_window(e):
    s = e.sched(budget=64, decode_window=4)
    s.add_request(e.req("i0", n=4))
    s.add_request(e.req("b0", n=4, priority=BATCH, arrival=1))
    e.step(s)
    b = e.step(s)
    assert b.decodes and all(x.num_tokens == 1 for x in b.decodes)
    s2 = e.sched(budget=64, decode_window=4)
    s2.add_request(e.req("i0", n=4))
    e.step(s2)
    assert e.step(s2).decodes[0].num_tokens == 4


def case_token_accounting(e):
    s = e.sched(budget=64)
    s.add_request(e.req("b0", n=4, priority=BATCH))
    e.step(s)
    e.step(s)
    assert s.batch_tokens == 5 and s.last_batch_backfill_tokens == 1


def case_band_off(e):
    s = e.sched(max_seqs=2, budget=64, batch_backfill=False)
    s.add_request(e.req("b0", n=4, priority=BATCH))
    assert [x.request.request_id for x in e.step(s).prefills] == ["b0"]
    s.add_request(e.req("i0", n=4, arrival=1))
    s.add_request(e.req("i1", n=4, arrival=2))
    e.step(s)
    assert s.num_batch_preemptions == 0


def case_spec_draftless(e):
    """Under speculative decoding batch rows ride at one token with a draft
    cap of 0 beside interactive rows planned at 1 + k; no verify window
    while they run."""
    s = e.sched(budget=64, speculative_ngram=True, spec_ngram_k=3, decode_window=4)
    s.add_request(e.req("i0", n=6))
    s.add_request(e.req("b0", n=5, priority=BATCH, arrival=1))
    e.step(s)
    for _ in range(3):
        b = e.step(s)
        rows = {x.request.request_id: x for x in b.decodes}
        assert (rows["b0"].num_tokens, rows["b0"].spec_draft_cap) == (1, 0)
        assert rows["i0"].num_tokens == 4 and b.spec_window == 1


def case_in_flight_batch_row(e):
    """Async stepping: a batch row in flight (``protected``) is no victim
    of an interactive admission; the next step takes the slot."""
    s = e.sched(max_seqs=1, budget=64, async_scheduling=True)
    s.add_request(e.req("b0", n=4, priority=BATCH))
    b = e.schedule(s)
    s.note_dispatch(b)
    s.add_request(e.req("i0", n=4, arrival=1))
    assert "i0" not in ids(e.schedule(s))
    s.update_after_step(b, {"b0": [7]})
    e.log.append(e.state(s))
    assert "i0" in ids(e.step(s)) and s.num_batch_preemptions == 1


def case_random_mix(e):
    """A seeded stream of interactive and batch arrivals of mixed lengths
    into a small pool, with preemptions both ways and finishes."""
    rng = np.random.default_rng(3)
    s = e.sched(max_seqs=5, budget=24, pages=12, page=4, batch_max_seqs=3,
                batch_kv_watermark=0.7, prefix=True)
    for t in range(60):
        if t < 40 and rng.random() < 0.4:
            batch = rng.random() < 0.5
            s.add_request(e.req(f"r{t}", n=int(rng.integers(3, 18)),
                                priority=BATCH if batch else int(rng.integers(0, 2)),
                                max_tokens=int(rng.integers(2, 12)),
                                first=int(rng.integers(1, 4)), arrival=float(t)))
        e.step(s, token=int(rng.integers(0, 50)))
    assert s.num_preemptions > s.num_batch_preemptions > 0 and s.batch_tokens > 0


CASES = {f.__name__[5:]: f for f in (
    case_leftover_budget, case_blocked_head, case_admission_preempts_batch_slots,
    case_page_pressure_reclaims_batch, case_never_preempts_interactive, case_kv_watermark,
    case_max_seqs_cap, case_pins_window, case_token_accounting, case_band_off,
    case_spec_draftless, case_in_flight_batch_row, case_random_mix)}


@pytest.mark.parametrize("case", list(CASES))
def test_scheduler_matches_jax_step_by_step(case):
    logs = {}
    for pkg in PKGS:
        e = Env(pkg)
        CASES[case](e)
        logs[pkg] = e.log
    assert logs["port"] == logs["jax"]


# --------------------------------------------------------------------- #
# the engines: interactive streams with and without a batch backlog

INTERACTIVE = [[1, 5, 9, 13, 2, 8], [3, 3, 7, 1, 3, 3, 7, 1], [9, 2, 9, 2, 9, 2, 5]]
# Batch prompts of 4 to 26 tokens: some prefill in chunks of the budget's
# leftovers, and enough pages to preempt one another.
BATCH_PROMPTS = [[2 + i, 4, 6, 8] * (1 + i % 3) + [20 + i] * (2 * i) for i in range(6)]
SAMPLING = {"greedy": dict(temperature=0.0, max_tokens=10),
            "seeded": dict(temperature=0.9, max_tokens=10, seed=1234)}
BATCH_SP = dict(temperature=0.0, max_tokens=12, ignore_eos=True)
LAYOUTS = {
    "flat": {},
    "bucketed": dict(ragged_qlens=False),
    "split-window4": dict(unified_step=False, decode_window=4),
    "async": dict(async_scheduling=True),
    "spec": dict(speculative_ngram=True, spec_ngram_k=3),
}


def build(layout):
    """(JAX engine, port engine, port engine): the last two on the JAX
    engine's parameters, the last one for the runs without the backlog."""
    cache = dict(page_size=4, num_blocks=48, dtype="float32")
    sched = dict(max_num_seqs=8, max_num_batched_tokens=16, **LAYOUTS[layout])
    j = JaxEngine(jcfg.EngineConfig(
        model=jcfg.tiny_model_config(), cache=jcfg.CacheConfig(**cache),
        scheduler=jcfg.SchedulerConfig(**sched), parallel=jcfg.ParallelConfig()))
    params = params_from_jax(jax.tree.map(np.asarray, j.runner.params))

    def port():
        return LLMEngine(tcfg.EngineConfig(
            model=tcfg.tiny_model_config(), cache=tcfg.CacheConfig(**cache),
            scheduler=tcfg.SchedulerConfig(**sched)), params=params, device="cpu")

    return j, port(), port()


@pytest.fixture(scope="module")
def trios():
    cache = {}

    def get(layout):
        if layout not in cache:
            cache[layout] = build(layout)
        return cache[layout]

    return get


def run(eng, SP, sp: dict, backlog: bool):
    """The interactive prompts (and the batch backlog behind them) to the
    end; returns (interactive streams, batch streams, the batch requests)."""
    rids = [eng.add_request(p, SP(**sp)) for p in INTERACTIVE]
    bids, reqs = [], []
    if backlog:
        for p in BATCH_PROMPTS:
            bids.append(eng.add_request(p, SP(**BATCH_SP), priority=BATCH))
            reqs.append(next(r for r in eng.scheduler.waiting if r.request_id == bids[-1]))
    outs: dict = {}
    for _ in range(2000):
        if not eng.has_work():
            break
        for out in eng.step():
            outs.setdefault(out.request_id, []).extend(out.new_token_ids)
    assert not eng.has_work()
    return [outs[r] for r in rids], [outs[r] for r in bids], reqs


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_interactive_streams_unchanged_by_batch_load(trios, layout, sampling):
    j, p, plain = trios(layout)
    sp = SAMPLING[sampling]
    before = (j.scheduler.batch_tokens, j.scheduler.num_batch_preemptions,
              j.scheduler.spec_proposed_tokens)
    pbefore = (p.scheduler.batch_tokens, p.scheduler.num_batch_preemptions,
               p.scheduler.spec_proposed_tokens)
    want_i, want_b, _ = run(j, JaxSP, sp, backlog=True)
    got_i, got_b, reqs = run(p, SamplingParams, sp, backlog=True)
    alone, _, _ = run(plain, SamplingParams, sp, backlog=False)
    assert got_i == want_i == alone
    assert got_b == want_b and all(len(s) == BATCH_SP["max_tokens"] for s in got_b)
    jd = (j.scheduler.batch_tokens - before[0], j.scheduler.num_batch_preemptions - before[1])
    pd = (p.scheduler.batch_tokens - pbefore[0], p.scheduler.num_batch_preemptions - pbefore[1])
    assert pd == jd and pd[0] > 0
    assert p.scheduler.num_preemptions == j.scheduler.num_preemptions
    if layout == "async":
        assert p.stats.async_rollbacks_total == j.stats.async_rollbacks_total
    if layout == "spec":
        drafted = p.scheduler.spec_proposed_tokens - pbefore[2]
        assert drafted == j.scheduler.spec_proposed_tokens - before[2]
        assert drafted > 0 or sampling == "seeded"  # greedy streams loop: drafts fire
        assert p.scheduler.spec_accept_len_hist == j.scheduler.spec_accept_len_hist
        assert all(r.spec_drafted_tokens == 0 for r in reqs)
    for key in ("batch_backlog_jobs", "batch_tokens", "batch_preemptions",
                "batch_backfill_utilization"):
        assert getattr(p.stats, key) == getattr(j.stats, key), key
    assert p.allocator.num_free_pages == j.allocator.num_free_pages == 48


def test_batch_series_render_as_jax(trios):
    """The batch fields on the port's ``/metrics`` page: the JAX page's
    lines for the same stats."""
    from llmd_tpu.serve.metrics import render_metrics as jax_render

    j, p, _ = trios("flat")
    mine = [ln for ln in render_metrics(p.stats, "tiny").splitlines() if "batch" in ln]
    theirs = [ln for ln in jax_render(j.stats, "tiny").splitlines() if "batch" in ln]
    assert mine == theirs and any("batch_tokens_total" in ln for ln in mine)


# --------------------------------------------------------------------- #
# the server


@pytest.mark.parametrize("headers,body", [
    ({"x-llmd-priority": "batch"}, 0), ({"x-llmd-priority": " Batch "}, 5),
    ({"x-llmd-priority": "batch"}, -500), ({"x-llmd-priority": "interactive"}, 3),
    ({}, -100), ({}, 2),
])
def test_priority_header_clamp_is_jax_one(headers, body):
    r = make_mocked_request("POST", "/v1/completions", headers=headers)
    assert tapi._effective_priority(r, body) == japi._effective_priority(r, body)


@pytest.fixture(scope="module")
def anyio_backend():
    return "asyncio"


async def post_in_order(pair, requests):
    """The requests to each server while its engine is paused, each queued
    before the next is sent (the same arrival order on both), then the
    engine resumed; returns each server's (status, body) list."""
    out = []
    for client, aeng in zip(pair.clients, pair.aengines):
        aeng.pause()
        tasks = []
        for path, body, headers in requests:
            tasks.append(asyncio.ensure_future(client.post(path, json=body, headers=headers)))
            while len(aeng._inbox) < len(tasks):
                await asyncio.sleep(0.005)
        aeng.resume()
        out.append([(r.status, await surface.read_body(r)) for r in await asyncio.gather(*tasks)])
    return out


@pytest.mark.anyio
async def test_server_batch_header_and_metrics_match_jax():
    """Interactive requests and batch-header ones (completions, chat and
    Generate) to a JAX server and the port's: equal answers, the batch
    rows counted in the batch tier, equal ``/metrics`` pages."""
    pair = await surface.start_pair(*surface.engine_pair(sched=dict(max_num_batched_tokens=16)))
    try:
        batch = {"x-llmd-priority": "batch"}
        sp = surface.greedy(max_tokens=6)
        reqs = [
            ("/v1/completions", {"prompt": "interactive one", **sp}, {}),
            ("/v1/completions", {"prompt": "a batch job of some length", **sp}, batch),
            ("/v1/chat/completions", {"messages": surface.MESSAGES, **sp}, batch),
            ("/v1/completions", {"prompt": "interactive two", **sp}, {}),
        ]
        jout, tout = await post_in_order(pair, reqs)
        assert [s for s, _ in tout] == [s for s, _ in jout] == [200] * 4
        assert surface.strip([b for _, b in tout]) == surface.strip([b for _, b in jout])
        jtext, ttext = await pair.get_text("/metrics")
        tm = surface.metric_pages_agree(jtext, ttext)
        assert tm["llmd:batch_tokens_total"] > 0
        # Generate takes the header too (its body priority stays otherwise).
        body = {"prompt_token_ids": [5, 6, 7, 8], "sampling_params": {
            "temperature": 0.0, "max_tokens": 3, "ignore_eos": True}}
        r = await pair.clients[1].post("/vllm.Generation/Generate", json=body, headers=batch)
        assert r.status == 200, await r.text()
        await surface.read_body(r)
        teng = pair.aengines[1].engine
        assert teng.stats.batch_tokens == tm["llmd:batch_tokens_total"] + 4 + 2
    finally:
        for c in pair.clients:
            await c.close()
