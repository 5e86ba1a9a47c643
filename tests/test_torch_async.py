"""Async stepping (``SchedulerConfig.async_scheduling``) of the port against
the JAX engine's, on the CPU.

The contract of ``tests/test_async_engine.py``: the two-slot pipeline
changes when host work happens, never what the engine emits. Each case runs
the same requests through three engines built on one tiny f32 model: the
JAX engine with async stepping, the port's with async stepping (on the JAX
engine's parameters) and the port's synchronous engine; the three streams
must be equal byte for byte: greedy, seeded and unseeded sampling, chunked
prefill and recompute preemption, on the flat step, the split engine with
decode windows of 4 and the bucketed unified step (the other models are in
``test_torch_async_models.py``, a file of its own so that a parallel run
spreads the two over two workers). Late finishes (EOS, a stop token in the
middle of a batch, ``max_tokens``) roll back as many staged rows as JAX's,
and the allocators end empty. Then the
deferred abort of an in-flight request, the one-step-late stream that
drains, a failed step that must not leak pages, and the server: the
``/metrics`` page of an async JAX server and an async port server alike.
The engines of a configuration are shared by its cases (module scope), and
every case runs its requests on all three, so the three stay in step.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import llmd_tpu.config as jcfg
import llmd_tpu_torch.config as tcfg
import llmd_tpu_torch.serve.api as tapi
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine import SamplingParams as JaxSP
from llmd_tpu.models.registry import get_model_config as jax_model_config
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.models.llama import params_from_jax
from llmd_tpu_torch.models.registry import get_model_config
from llmd_tpu_torch.serve.async_engine import AsyncEngine
from llmd_tpu_torch.serve.tokenizer import ByteTokenizer

import test_torch_serve_surface as surface
from test_torch_engine import LAYOUTS
from test_torch_model import TINY_OSS

PROMPTS = [
    [1, 5, 9, 13, 2, 8],
    [3, 3, 7, 1],
    [1, 5, 9, 13, 2, 8, 4, 4, 4, 4, 6, 6, 6, 6, 11],
]
# A prompt longer than a 16-token budget (chunked over four steps) and two
# short ones, as tests/test_async_engine.py's unseeded case.
CHUNKED = [[int(x) for x in np.random.default_rng(0).integers(0, 256, size=50)],
           list(range(10)), list(range(20, 30))]
MODELS = {"tiny": "tiny", "tiny-moe": "tiny-moe", "tiny-mla": "tiny-mla", "tiny-swa": "tiny-swa",
          "tiny-oss": TINY_OSS}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: faster on these tiny models than many, above
    all while test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(model="tiny", layout="flat", num_blocks=64, page=4, max_batched=64, max_seqs=8,
          ring=False):
    """(JAX async engine, port async engine, port sync engine), the port's on
    the JAX engine's parameters."""
    cache = dict(page_size=page, num_blocks=num_blocks, dtype="float32", swa_ring=ring)
    sched = dict(max_num_seqs=max_seqs, max_num_batched_tokens=max_batched, **LAYOUTS.get(layout, {}))
    cfg = MODELS[model]
    if isinstance(cfg, dict):
        jmodel, tmodel = jcfg.tiny_model_config(**cfg), tcfg.tiny_model_config(**cfg)
    else:
        jmodel, tmodel = jax_model_config(cfg), get_model_config(cfg)
    j = JaxEngine(jcfg.EngineConfig(
        model=jmodel, cache=jcfg.CacheConfig(**cache),
        scheduler=jcfg.SchedulerConfig(**sched, async_scheduling=True),
        parallel=jcfg.ParallelConfig(tensor_parallel_size=1),
    ))
    params = params_from_jax(jax.tree.map(np.asarray, j.runner.params))

    def port(async_scheduling):
        return LLMEngine(tcfg.EngineConfig(
            model=tmodel, cache=tcfg.CacheConfig(**cache),
            scheduler=tcfg.SchedulerConfig(**sched, async_scheduling=async_scheduling),
        ), params=params, device="cpu")

    return j, port(True), port(False)


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


def as_list(sp, n):
    return sp if isinstance(sp, list) else [sp] * n


def run3(trio, prompts, sp):
    """Run ``prompts`` (``sp``: one SamplingParams kwargs dict, or one a
    prompt) on the three engines; assert the streams equal, the port async
    engine's rollbacks and preemptions equal the JAX engine's, and both
    async engines drained with empty pools. Returns the streams."""
    j, pa, ps = trio
    sps = as_list(sp, len(prompts))
    r0 = (j.stats.async_rollbacks_total, pa.stats.async_rollbacks_total)
    p0 = (j.scheduler.num_preemptions, pa.scheduler.num_preemptions)
    want = list(j.generate(prompts, [JaxSP(**s) for s in sps]).values())
    got = list(pa.generate(prompts, [SamplingParams(**s) for s in sps]).values())
    sync = list(ps.generate(prompts, [SamplingParams(**s) for s in sps]).values())
    assert got == want
    assert got == sync
    rolled = pa.stats.async_rollbacks_total - r0[1]
    assert rolled == j.stats.async_rollbacks_total - r0[0]
    assert pa.scheduler.num_preemptions - p0[1] == j.scheduler.num_preemptions - p0[0]
    for eng in (pa, j):
        assert eng._inflight is None and not eng.has_work()
    assert pa.allocator.usage() == j.allocator.usage() == 0.0
    if pa.swa_allocator is not None:
        # The ring pool holds only retained sections once nothing runs.
        assert pa.swa_allocator.usage() == j.swa_allocator.usage()
    assert not pa.scheduler.protected and all(
        r.num_pending_tokens == 0 for r in pa.scheduler.running + pa.scheduler.waiting)
    return got, rolled


GREEDY = dict(temperature=0.0, max_tokens=8)


@pytest.mark.parametrize("case", ["basic", "seeded", "max_tokens", "eos", "stop_mid_batch"])
def test_async_cases_match_jax_and_sync(trios, case):
    """tests/test_async_engine.py's cases on the flat step, its engine
    sizes: greedy, seeded (per request seed and output index at
    dispatch), LENGTH finishes (each rolls back its request's staged row),
    a stop token that ends the one request it is sampled in, and one
    that ends a single request of a batch while its mates decode on."""
    trio = trios()
    if case == "basic":
        run3(trio, PROMPTS, GREEDY)
    elif case == "seeded":
        run3(trio, [PROMPTS[0]], dict(temperature=1.0, max_tokens=9, seed=77))
    elif case == "max_tokens":
        _, rolled = run3(trio, PROMPTS, dict(temperature=0.0, max_tokens=5))
        assert rolled >= len(PROMPTS)
    elif case == "eos":
        (free,), _ = run3(trio, [PROMPTS[0]], GREEDY)
        stop = free[2]
        (got,), rolled = run3(trio, [PROMPTS[0]], dict(GREEDY, stop_token_ids=(stop,)))
        assert got == free[: free.index(stop) + 1] and rolled >= 1
    else:
        free, _ = run3(trio, PROMPTS, dict(temperature=0.0, max_tokens=10))
        got, rolled = run3(trio, PROMPTS, dict(temperature=0.0, max_tokens=10,
                                               stop_token_ids=(free[0][3],)))
        assert len(got[0]) <= 4 and rolled >= 1


def mixed_sampling_case(trios, model, layout, ring):
    """A 50-token prompt chunked over a 16-token budget beside two short
    ones, one greedy, one seeded and one unseeded (whose seed stream must
    advance at dispatch, in dispatch order), each ending on its
    ``max_tokens``; streams, rollbacks and pools as ``run3`` holds them."""
    trio = trios(model=model, layout=layout, ring=ring, max_batched=16, num_blocks=96)
    assert trio[1].runner.flat == (layout == "flat" and model != "tiny-mla")
    _, rolled = run3(trio, CHUNKED, [dict(temperature=0.0, max_tokens=11),
                                     dict(temperature=0.8, max_tokens=9, seed=7),
                                     dict(temperature=1.0, max_tokens=6)])
    assert rolled >= 1


@pytest.mark.parametrize("layout", ["flat", "window", "bucketed"])
def test_async_layouts_match_jax_and_sync(trios, layout):
    """``mixed_sampling_case`` on tiny in each step layout."""
    mixed_sampling_case(trios, "tiny", layout, False)


@pytest.mark.parametrize("layout", ["flat", "window"])
def test_async_preemption_matches_jax_and_sync(trios, layout):
    """The acceptance workload of tests/test_async_engine.py (chunked
    prefill, interleaved decodes, a tight pool), then the preemption case
    of tests/test_torch_engine.py on the same 14 pages, which preempts:
    recompute preemption, which never picks an in-flight sequence."""
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, 256, size=50)), list(range(10)), list(range(20, 30)),
               list(range(40, 50))]
    trio = trios(layout=layout, num_blocks=14, max_batched=16)
    run3(trio, prompts, [dict(temperature=0.0, max_tokens=n) for n in (6, 12, 9, 12)])
    run3(trio, PROMPTS + [[9, 9, 2, 4, 4, 1, 7]],
         dict(temperature=0.0, max_tokens=12, ignore_eos=True))
    assert trio[1].scheduler.num_preemptions > 0


def test_deferred_abort_of_an_inflight_request(trios):
    """An abort of a request whose step is in flight waits for the commit
    (its pages are freed only once the device stops writing them); the
    other request decodes to the end, as in the JAX engine."""
    j, pa, ps = trios()
    got = []
    for eng, sp_cls in ((j, JaxSP), (pa, SamplingParams)):
        keep = eng.add_request(PROMPTS[0], sp_cls(temperature=0.0, max_tokens=6))
        victim = eng.add_request(PROMPTS[1], sp_cls(temperature=0.0, max_tokens=6))
        assert eng.step() == []  # primes the pipeline: both in flight
        assert eng.abort_request(victim)
        toks = {keep: [], victim: []}
        while eng.has_work():
            for out in eng.step():
                toks[out.request_id].extend(out.new_token_ids)
        got.append((toks[keep], toks[victim]))
        assert eng.allocator.usage() == 0.0
    ref = list(ps.generate([PROMPTS[0]], SamplingParams(temperature=0.0, max_tokens=6)).values())
    assert got[1] == got[0] and got[1][0] == ref[0] and len(got[1][1]) <= 2
    assert not pa._deferred_aborts and not pa.scheduler.protected


def test_streams_one_step_late_then_drain(trios):
    """The first step only dispatches; has_work() holds while a step is in
    flight, with both queues empty; every token still arrives."""
    _, pa, ps = trios()
    pa.add_request(PROMPTS[1], SamplingParams(temperature=0.0, max_tokens=4))
    assert pa.step() == []
    assert pa.has_work() and pa._inflight is not None
    toks = []
    while pa.has_work():
        for out in pa.step():
            toks.extend(out.new_token_ids)
    ref = list(ps.generate([PROMPTS[1]], SamplingParams(temperature=0.0, max_tokens=4)).values())
    assert toks == ref[0] and pa._inflight is None


def test_a_failed_step_leaks_no_pages(trios, monkeypatch):
    """A step that raises with a step in flight: ``drop_inflight`` (the
    serving loop's first move) unprotects its requests and applies the
    deferred aborts, and the aborts that follow free every page."""
    _, pa, _ = trios()
    rids = [pa.add_request(p, SamplingParams(temperature=0.0, max_tokens=6)) for p in PROMPTS]
    pa.step()
    pa.abort_request(rids[0])  # deferred: in flight
    monkeypatch.setattr(pa.runner, "wait_step", lambda *a: (_ for _ in ()).throw(RuntimeError("x")))
    with pytest.raises(RuntimeError):
        pa.step()
    monkeypatch.undo()
    pa.drop_inflight()
    assert pa._inflight is None and not pa._deferred_aborts and not pa.scheduler.protected
    for rid in rids[1:]:
        assert pa.abort_request(rid)
    assert pa.allocator.usage() == 0.0 and not pa.has_work()


@pytest.mark.anyio
@pytest.mark.parametrize("anyio_backend", ["asyncio"])
async def test_async_servers_metrics_and_failed_step(anyio_backend, monkeypatch):
    """An async JAX server and an async port server on the same requests:
    equal answers and equal ``/metrics`` pages (host times aside), with
    ``llmd:async_rollbacks_total`` counting. Then a step of the port's
    server raises: the request fails with 500, the engine's pool is empty
    afterwards, and the next request is answered."""
    sched = dict(async_scheduling=True)
    p = await surface.start_pair(*surface.engine_pair(sched=sched))
    try:
        prompt = [3 + (11 * i) % 250 for i in range(37)]
        for body in ({"prompt": prompt}, {"prompt": prompt},
                     {"messages": surface.MESSAGES, "stream": True}):
            path = "/v1/chat/completions" if "messages" in body else "/v1/completions"
            (js, jb), (ts, tb) = await p.post(path, {**body, **surface.greedy()})
            assert js == ts == 200 and surface.strip(tb) == surface.strip(jb)
        await p.together("/v1/completions", {"prompt": "async", "n": 3, **surface.greedy()}, 3)
        jtext, ttext = await p.get_text("/metrics")
        tm = surface.metric_pages_agree(jtext, ttext)
        assert tm["llmd:async_rollbacks_total"] >= 4
    finally:
        for c in p.clients:
            await c.close()
    _, teng = surface.engine_pair(sched=sched)
    client = TestClient(TestServer(tapi.build_app(AsyncEngine(teng), ByteTokenizer(), "tiny",
                                                  surface.MAX_LEN)))
    await client.start_server()
    try:
        wait = teng.runner.wait_step
        calls = []

        def failing(*args):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("device fault")
            return wait(*args)

        monkeypatch.setattr(teng.runner, "wait_step", failing)
        r = await client.post("/v1/completions", json={"prompt": "boom", **surface.greedy()})
        assert r.status == 500
        # The serving loop aborts the request after it answered it.
        for _ in range(200):
            if teng.allocator.usage() == 0.0 and not teng.has_work():
                break
            await asyncio.sleep(0.01)
        assert teng.allocator.usage() == 0.0 and teng._inflight is None
        r = await client.post("/v1/completions", json={"prompt": "fine", **surface.greedy()})
        assert r.status == 200 and (await r.json())["usage"]["completion_tokens"] == 8
        assert teng.allocator.usage() == 0.0
    finally:
        await client.close()
