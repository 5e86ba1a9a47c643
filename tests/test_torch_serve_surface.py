"""The port's serving surface against the JAX package's, on the CPU.

The JAX ``build_app`` and the port's serve one tiny f32 model each (the
port loads the JAX engine's parameters through ``params_from_jax``); the
same requests go to both and must get the same answers: chat and
completions with n in {1, 3}, streamed and not (``id`` and ``created``
aside), ``/tokenize`` and the render routes, ``/v1/cache/probe``, and a
``/metrics`` page with the same names and the same value for every series
that does not depend on time (all but ``step_host_gap_ms*``), which the
router's ``extract_attrs`` reads alike under both mappings; on tiny-swa
with the ring too. Requests that run at once (n = 3) are submitted while
the engine is paused, so both engines schedule them in the same steps.
The admin routes (pause stops steps and resume finishes the request with
an unpaused run's tokens; drain; the loopback and token rules), the step
watchdog, and ``enable_chunked_prefill=False`` (the JAX engine's stream
and refusals) are held to the JAX package's behaviour. About 40 s serial.
"""

import asyncio
import json
import time

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer, make_mocked_request

import llmd_tpu.config as jcfg
import llmd_tpu.serve.api as japi
import llmd_tpu_torch.config as tcfg
import llmd_tpu_torch.serve.api as tapi
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine import SamplingParams as JaxSP
from llmd_tpu.epp.datalayer import extract_attrs
from llmd_tpu.models.registry import get_model_config as jax_model_config
from llmd_tpu.serve.async_engine import AsyncEngine as JaxAsyncEngine
from llmd_tpu.serve.metrics import parse_prometheus
from llmd_tpu.serve.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.models.llama import params_from_jax
from llmd_tpu_torch.models.registry import get_model_config
from llmd_tpu_torch.serve.async_engine import AsyncEngine
from llmd_tpu_torch.serve.metrics import render_metrics
from llmd_tpu_torch.serve.tokenizer import ByteTokenizer

pytestmark = pytest.mark.anyio

MAX_LEN = 128
TINY = dict(vocab_size=512, max_model_len=MAX_LEN)
CACHE = dict(page_size=16, num_blocks=64, dtype="float32")
SCHED = dict(max_num_seqs=8, max_num_batched_tokens=32)
# Series whose values are host times.
TIMED = ("step_host_gap_ms", "step_host_gap_ms_total")


@pytest.fixture(scope="module")
def anyio_backend():
    return "asyncio"


def engine_pair(model=None, cache=None, sched=None):
    """The JAX engine and the port's on its parameters; ``model`` is a
    registry name (default: the tiny llama at vocab 512)."""
    cache = dict(CACHE, **(cache or {}))
    sched = dict(SCHED, **(sched or {}))
    if model is None:
        jmodel, tmodel = jcfg.tiny_model_config(**TINY), tcfg.tiny_model_config(**TINY)
    else:
        jmodel, tmodel = jax_model_config(model), get_model_config(model)
    jeng = JaxEngine(jcfg.EngineConfig(
        model=jmodel, cache=jcfg.CacheConfig(**cache),
        scheduler=jcfg.SchedulerConfig(**sched),
        parallel=jcfg.ParallelConfig(tensor_parallel_size=1),
    ))
    params = params_from_jax(jax.tree.map(np.asarray, jeng.runner.params))
    teng = LLMEngine(tcfg.EngineConfig(
        model=tmodel, cache=tcfg.CacheConfig(**cache), scheduler=tcfg.SchedulerConfig(**sched),
    ), params=params, device="cpu")
    return jeng, teng


def port_engine():
    """The port's engine alone, on random weights."""
    return LLMEngine(tcfg.EngineConfig(
        model=tcfg.tiny_model_config(**TINY), cache=tcfg.CacheConfig(**CACHE),
        scheduler=tcfg.SchedulerConfig(**SCHED)), device="cpu")


class Pair:
    """A JAX server and the port's, and the way to ask both."""

    def __init__(self, jclient, tclient, jeng, teng):
        self.clients = (jclient, tclient)
        self.aengines = (jeng, teng)

    async def post(self, path, body, headers=None):
        """(status, JSON or SSE frames) from each server, in turn."""
        out = []
        for c in self.clients:
            r = await c.post(path, json=body, headers=headers or {})
            out.append((r.status, await read_body(r)))
        return out

    async def get_text(self, path):
        return [await (await c.get(path)).text() for c in self.clients]

    async def together(self, path, body, n):
        """POST to both while their engines are paused, and resume each
        once its n requests are queued: the n run in the same steps."""
        out = []
        for c, aeng in zip(self.clients, self.aengines):
            aeng.pause()
            task = asyncio.ensure_future(c.post(path, json=body))
            while len(aeng._inbox) < n:
                await asyncio.sleep(0.005)
            aeng.resume()
            r = await task
            out.append((r.status, await read_body(r)))
        return out


async def read_body(r):
    if not r.headers.get("Content-Type", "").startswith("text/event-stream"):
        return await r.json()
    frames = []
    async for raw in r.content:
        line = raw.decode().strip()
        if line == "data: [DONE]":
            frames.append("[DONE]")
        elif line.startswith("data: "):
            frames.append(json.loads(line[len("data: "):]))
    return frames


def by_choice(frames):
    """SSE frames of an n > 1 stream, per choice index, in order (how
    the choices interleave depends on thread timing), and the rest."""
    out = {"other": []}
    for f in frames:
        if isinstance(f, dict) and f["choices"]:
            (c,) = f["choices"]
            out.setdefault(c["index"], []).append(f)
        else:
            out["other"].append(f)
    return out


def strip(obj):
    """A response or SSE frame without its ``id`` and ``created``."""
    if isinstance(obj, list):
        return [strip(o) for o in obj]
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in ("id", "created")}
    return obj


async def start_pair(jeng, teng, **port_kw):
    jaeng, taeng = JaxAsyncEngine(jeng), AsyncEngine(teng, **port_kw)
    name = "tiny"
    jclient = TestClient(TestServer(japi.build_app(jaeng, JaxByteTokenizer(), name, MAX_LEN)))
    tclient = TestClient(TestServer(tapi.build_app(taeng, ByteTokenizer(), name, MAX_LEN)))
    await jclient.start_server()
    await tclient.start_server()
    return Pair(jclient, tclient, jaeng, taeng)


@pytest.fixture(scope="module")
async def pair():
    p = await start_pair(*engine_pair())
    yield p
    for c in p.clients:
        await c.close()


def greedy(**kw):
    return {"temperature": 0.0, "max_tokens": 8, "ignore_eos": True, **kw}


MESSAGES = [
    {"role": "system", "content": "Be brief."},
    {"role": "user", "content": [{"type": "text", "text": "Hi "},
                                 {"type": "text", "text": "there é"}]},
]


@pytest.mark.parametrize("stream", [False, True], ids=["plain", "streamed"])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("route", ["chat", "completions"])
async def test_generate_matches_jax(pair, route, n, stream):
    if route == "chat":
        path, body = "/v1/chat/completions", {"messages": MESSAGES}
    else:
        path, body = "/v1/completions", {"prompt": "The port serves."}
    body.update(greedy(stream=stream, n=n) if n == 1 else
                dict(temperature=0.8, seed=11, max_tokens=8, ignore_eos=True,
                     stream=stream, n=n))
    (js, jbody), (ts, tbody) = await (pair.together(path, body, n) if n > 1
                                      else pair.post(path, body))
    assert js == ts == 200, (jbody, tbody)
    if stream and n > 1:
        assert strip(by_choice(tbody)) == strip(by_choice(jbody))
    else:
        assert strip(tbody) == strip(jbody)
    if not stream:
        assert len(tbody["choices"]) == n
        assert tbody["usage"]["completion_tokens"] == 8 * n
    else:
        assert tbody[-1] == "[DONE]"
        assert tbody[-2]["usage"]["completion_tokens"] == 8 * n
    if n == 3 and not stream:
        texts = [c["text" if route == "completions" else "message"] for c in tbody["choices"]]
        assert len({json.dumps(t) for t in texts}) > 1  # seed + i per choice


async def test_streamed_chat_carries_the_unstreamed_text(pair):
    body = {"messages": MESSAGES, **greedy(max_tokens=12)}
    _, (_, plain) = await pair.post("/v1/chat/completions", body)
    _, (_, frames) = await pair.post("/v1/chat/completions", {**body, "stream": True})
    assert frames[0]["choices"][0]["delta"] == {"role": "assistant"}
    deltas = [f["choices"][0]["delta"].get("content") for f in frames[1:-2]]
    assert len(deltas) == 12  # one chunk a token
    assert "".join(deltas) == plain["choices"][0]["message"]["content"]


@pytest.mark.parametrize("path,body", [
    ("/tokenize", {"prompt": "héllo"}),
    ("/tokenize", {"prompt": [5, 6, 7]}),
    ("/tokenize", {"messages": MESSAGES}),
    ("/v1/completions/render", {"prompt": "héllo"}),
    ("/v1/completions/render", {"prompt": [[9, 8, 7]]}),
    ("/v1/chat/completions/render", {"messages": MESSAGES}),
], ids=["tok-text", "tok-ids", "tok-messages", "render-text", "render-ids", "render-chat"])
async def test_tokenize_and_render_match_jax(pair, path, body):
    (js, jbody), (ts, tbody) = await pair.post(path, body)
    assert js == ts == 200
    assert tbody == jbody
    ids = tbody.get("tokens", tbody.get("prompt_token_ids"))
    assert ids and all(isinstance(t, int) for t in ids)


def test_chat_template_is_the_jax_template_byte_for_byte():
    for gen in (True, False):
        want = JaxByteTokenizer().apply_chat_template(MESSAGES, gen, tokenize=False)
        assert ByteTokenizer().apply_chat_template(MESSAGES, gen, tokenize=False) == want
    assert ByteTokenizer().encode("é", add_special_tokens=False) == [0xC3 + 3, 0xA9 + 3]
    assert ByteTokenizer().decode([1, 0xC3 + 3, 0xA9 + 3, 2], skip_special_tokens=True) == "é"


async def test_cache_probe_matches_jax(pair):
    prompt = [3 + (7 * i) % 250 for i in range(40)]
    sharing = prompt[:32] + [200 + i for i in range(16)]
    probe = "/v1/cache/probe"
    for body, want in (({"prompt": prompt}, 0), ({"prompt": sharing}, 0)):
        (js, jb), (ts, tb) = await pair.post(probe, body)
        assert js == ts == 200 and tb == jb and tb["cached_full_pages"] == want
    await pair.post("/v1/completions", {"prompt": prompt, **greedy(max_tokens=2)})
    for body, full, want in (({"prompt": prompt}, 2, 2), ({"prompt": sharing}, 3, 2)):
        (_, jb), (_, tb) = await pair.post(probe, body)
        assert tb == jb == {"cached_full_pages": want, "page_size": 16, "num_full_pages": full}
    # A chat's prompt is probed through the template.
    msgs = [{"role": "user", "content": "x" * 40}]
    await pair.post("/v1/chat/completions", {"messages": msgs, **greedy(max_tokens=2)})
    (_, jb), (_, tb) = await pair.post(probe, {"messages": msgs})
    assert tb == jb and tb["cached_full_pages"] == tb["num_full_pages"] == 4
    (js, _), (ts, _) = await pair.post(probe, {"model": "tiny"})
    assert js == ts == 400


def metric_pages_agree(jtext, ttext):
    """Same names; equal values but the host times'; the router reads both
    pages alike under both mappings."""
    jm, tm = parse_prometheus(jtext), parse_prometheus(ttext)
    assert set(tm) == set(jm)
    timed = {f"{fam}:{n}" for fam in ("vllm", "llmd") for n in TIMED}
    assert {k: v for k, v in tm.items() if k not in timed} == {
        k: v for k, v in jm.items() if k not in timed}
    assert tm["llmd:step_host_gap_ms_total"] > 0
    for family in ("vllm", "llmd"):
        assert extract_attrs(ttext, family) == extract_attrs(jtext, family)
    # Labelled series (cache_config_info) agree line for line.
    assert sorted(ln for ln in ttext.splitlines() if "{" in ln and "cache_config" in ln) == sorted(
        ln for ln in jtext.splitlines() if "{" in ln and "cache_config" in ln)
    return tm


async def test_metrics_match_jax(pair):
    prompt = [3 + (11 * i) % 250 for i in range(37)]
    for body in ({"prompt": prompt}, {"prompt": prompt},
                 {"messages": MESSAGES, "stream": True}):
        path = "/v1/chat/completions" if "messages" in body else "/v1/completions"
        await pair.post(path, {**body, **greedy()})
    jtext, ttext = await pair.get_text("/metrics")
    tm = metric_pages_agree(jtext, ttext)
    assert tm["vllm:num_requests_waiting"] == tm["vllm:num_requests_running"] == 0
    assert tm["llmd:generation_tokens_total"] >= 24
    assert tm["llmd:prefix_cache_hit_rate"] > 0
    assert tm["llmd:engine_steps_total"] > 0
    attrs = extract_attrs(ttext, "llmd")
    assert attrs["BlockSize"] == 16 and attrs["NumBlocks"] == 64


async def test_ring_metrics_match_jax():
    p = await start_pair(*engine_pair(
        "tiny-swa", cache=dict(page_size=4, num_blocks=96, swa_ring=True), sched=dict(max_num_batched_tokens=16)))
    try:
        prompt = [3 + (5 * i) % 250 for i in range(70)]
        for _ in range(2):  # the repeat takes a hybrid hit
            await p.post("/v1/completions", {"prompt": prompt, **greedy(max_tokens=6)})
        await p.together("/v1/completions", {"prompt": "ring", "n": 2, **greedy(max_tokens=20)}, 2)
        jtext, ttext = await p.get_text("/metrics")
        tm = metric_pages_agree(jtext, ttext)
        for name in ("swa_ring_usage_perc", "swa_ring_pages", "kv_main_usage_perc",
                     "swa_sections", "swa_section_hits_total", "swa_section_captures_total"):
            assert f"vllm:{name}" in tm and f"llmd:{name}" in tm
        assert tm["llmd:swa_section_hits_total"] == 1
        assert tm["llmd:gpu_cache_usage_perc"] == max(tm["llmd:kv_main_usage_perc"],
                                                       tm["llmd:swa_ring_usage_perc"])
    finally:
        for c in p.clients:
            await c.close()


PAGE_STATS = {
    "ring": dict(num_waiting=3, num_running=5, kv_usage=0.25, swa_ring_usage=0.5,
                 swa_ring_pages=40, prefix_hit_ratio=0.125, num_pages=64, page_size=16,
                 prompt_tokens=100, generation_tokens=20, step_host_gap_ms=1.5,
                 step_dispatches_total=7, live_tokens_total=90, padded_tokens_total=6),
    # The labelled and histogram series the port prints once their
    # features fill them.
    "labelled": dict(max_lora=2, running_lora_adapters=("a",), available_lora_adapters=("a", "b"),
                     spec_accepted_len_hist=(3, 2, 1), spec_acceptance_rate=0.4,
                     spec_row_depth_hist=(1, 2), moe_expert_tokens=(5, 6),
                     kv_transfer_failures=((("pull", "recompute"), 2),)),
    # The store tier's and failover resume's counters, which the port fills
    # (``test_torch_kvstore.py`` holds an engine's to JAX's).
    "store": dict(offload_pages=12, offload_saves=20, offload_restores=8, kvstore_pulls=8,
                  kvstore_pull_failures=1, kvstore_misses=3, kv_federation_published=5,
                  kv_federation_hits=8, recompute_avoided_tokens=32,
                  kv_publish_paced_bytes_total=4096, stream_resumes_total=2,
                  resume_replayed_tokens_total=17, stream_resume_failures_total=1),
}


@pytest.mark.parametrize("case", PAGE_STATS)
def test_render_metrics_is_the_jax_page_for_the_same_stats(case):
    """render_metrics on equal stats gives the JAX page line for line: the
    ring's series and the binding-pool gauge, the labelled series, and the
    store tier's and failover resume's counters."""
    from llmd_tpu.engine.engine import EngineStats as JaxStats
    from llmd_tpu_torch.engine.engine import EngineStats

    values = PAGE_STATS[case]
    ttext = render_metrics(EngineStats(**values), "m")
    assert ttext == japi.render_metrics(JaxStats(**values), "m")
    if case == "ring":
        assert parse_prometheus(ttext)["vllm:gpu_cache_usage_perc"] == 0.5
    elif case == "store":
        page = parse_prometheus(ttext)
        for name, field in (("kvstore_pulls_total", "kvstore_pulls"),
                            ("kv_federation_hits_total", "kv_federation_hits"),
                            ("recompute_avoided_tokens_total", "recompute_avoided_tokens"),
                            ("kv_publish_paced_bytes_total", "kv_publish_paced_bytes_total"),
                            ("stream_resumes_total", "stream_resumes_total")):
            assert page[f"llmd:{name}"] == page[f"vllm:{name}"] == values[field]
    else:
        assert "vllm:lora_requests_info{" in ttext and "llmd:spec_accepted_len_bucket" in ttext


async def test_pause_stops_steps_and_resume_finishes_with_unpaused_tokens(pair):
    body = {"prompt": "pause me", **greedy(max_tokens=24)}
    (_, want), _ = await pair.post("/v1/completions", body)
    jclient, tclient = pair.clients
    taeng = pair.aengines[1]
    r = await tclient.post("/v1/completions", json={**body, "stream": True})
    first = await r.content.readline()  # a token is out: the request is in flight
    assert first.startswith(b"data: {")
    pause = await tclient.post("/admin/pause")
    assert pause.status == 200 and (await pause.json())["paused"] is True
    await asyncio.sleep(0.05)
    while taeng._step_started is not None:  # a step under way ends
        await asyncio.sleep(0.005)
    progs = taeng.engine.runner.programs

    def state():  # steps, prepared programs (captures on the card), runs
        return taeng.stats.engine_steps_total, set(progs.programs), sum(progs.runs.values())

    held = state()
    ready = await tclient.get("/ready")
    assert ready.status == 503 and (await ready.json())["paused"] is True
    assert (await tclient.get("/health")).status == 200  # alive
    status = await (await tclient.get("/admin/status")).json()
    assert status["paused"] is True
    await asyncio.sleep(0.3)
    assert state() == held  # no step, no staging, no capture
    assert taeng.engine.has_work()
    assert (await tclient.post("/admin/resume")).status == 200
    frames = [json.loads(raw[6:]) for raw in [first] + [ln async for ln in r.content]
              if raw.startswith(b"data: {")]
    assert "".join(f["choices"][0]["text"] for f in frames) == want["choices"][0]["text"]
    assert frames[-1]["usage"]["completion_tokens"] == 24
    after = state()
    assert after[1] == held[1] and after[2] > held[2]  # resumed on the prepared programs
    assert (await tclient.get("/ready")).status == 200
    # The JAX server gets the same request, so the pages stay comparable.
    await jclient.post("/v1/completions", json=body)


async def test_drain(pair):
    jclient, tclient = pair.clients
    for c in pair.clients:
        r = await c.post("/admin/drain?timeout=5")
        assert r.status == 200 and (await r.json())["drained"] is True
        assert (await c.get("/ready")).status == 503  # draining
        await c.post("/admin/pause")
        task = asyncio.ensure_future(c.post("/v1/completions", json={
            "prompt": "drain", **greedy(max_tokens=4)}))
        await asyncio.sleep(0.05)
        r = await c.post("/admin/drain?timeout=0.2")
        assert r.status == 504 and (await r.json())["drained"] is False
        await c.post("/admin/resume")
        assert (await task).status == 200
        assert (await c.get("/ready")).status == 200
        assert (await c.post("/admin/drain?timeout=x")).status == 400


class _Transport:
    def __init__(self, host):
        self.host = host

    def get_extra_info(self, name, default=None):
        return (self.host, 4242) if name == "peername" else default


@pytest.mark.parametrize("host,token,headers,status", [
    ("10.1.2.3", None, {}, 403),
    ("127.0.0.1", None, {}, None),
    ("::1", None, {}, None),
    ("10.1.2.3", "s3cret", {"authorization": "Bearer s3cret"}, None),
    ("10.1.2.3", "s3cret", {"x-admin-token": "s3cret"}, None),
    ("127.0.0.1", "s3cret", {"authorization": "Bearer nope"}, 403),
    ("127.0.0.1", "REPLACE-ME-admin", {"authorization": "Bearer REPLACE-ME-admin"}, 403),
], ids=["remote", "loopback", "loopback6", "bearer", "header", "wrong-token", "placeholder"])
def test_admin_access_rule_is_the_jax_rule(monkeypatch, host, token, headers, status):
    if token is None:
        monkeypatch.delenv("LLMD_ADMIN_TOKEN", raising=False)
    else:
        monkeypatch.setenv("LLMD_ADMIN_TOKEN", token)
    got = []
    for denied in (japi._admin_denied, tapi._admin_denied):
        req = make_mocked_request("POST", "/admin/pause", headers=headers,
                                  transport=_Transport(host))
        resp = denied(req)
        got.append(None if resp is None else resp.status)
    assert got == [status, status]


async def test_admin_routes_refuse_a_placeholder_token(pair, monkeypatch):
    monkeypatch.setenv("LLMD_ADMIN_TOKEN", "REPLACE-ME")
    for c in pair.clients:
        r = await c.post("/admin/pause", headers={"authorization": "Bearer REPLACE-ME"})
        assert r.status == 403
        assert (await c.get("/admin/status")).status == 403
    assert not pair.aengines[1].paused


async def test_step_watchdog_fails_streams_and_health():
    """A step that outlives the 0.2 s watchdog: the stream gets a terminal
    error frame well before the step ends, /health and /ready are 503
    while it runs, and the trip is counted."""
    eng = port_engine()
    await watchdog_trips(eng, AsyncEngine(eng, watchdog_s=0.2))


async def watchdog_trips(eng, aeng):
    """Wedge one step of ``eng`` for 2 s under ``aeng``, whose watchdog is
    armed at 0.2 s, and check the trip (``test_step_watchdog_fails_streams_and_health``)."""
    assert aeng.watchdog_s == 0.2
    client = TestClient(TestServer(tapi.build_app(aeng, ByteTokenizer(), "tiny", MAX_LEN)))
    await client.start_server()
    try:
        r = await client.post("/v1/completions", json={"prompt": "warm", **greedy(max_tokens=2)})
        assert r.status == 200
        assert (await client.get("/health")).status == 200
        step = eng.step

        def wedged():
            eng.step = step
            time.sleep(2.0)
            return step()

        eng.step = wedged
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        r = await client.post("/v1/completions", json={
            "prompt": "wedge", "stream": True, **greedy(max_tokens=4)})
        body = (await r.read()).decode()
        assert "watchdog" in body and body.rstrip().endswith("data: [DONE]")
        assert loop.time() - t0 < 1.5  # well before the step ends
        health = await client.get("/health")
        assert health.status == 503 and (await health.json())["status"] == "stalled"
        ready = await client.get("/ready")
        assert ready.status == 503 and (await ready.json())["stalled"] is True
        await asyncio.sleep(2.0)
        assert (await client.get("/health")).status == 200
        page = parse_prometheus(await (await client.get("/metrics")).text())
        assert page["llmd:engine_watchdog_stalls_total"] == 1
    finally:
        await client.close()


def test_serve_flag_sets_the_watchdog():
    from llmd_tpu_torch.serve import __main__ as serve_main

    args = serve_main.build_parser().parse_args(["--step-watchdog-s", "2.5"])
    assert args.step_watchdog_s == 2.5
    # Without the flag the budget is None: AsyncEngine reads
    # LLMD_STEP_WATCHDOG_S, as the reference's does.
    assert serve_main.build_parser().parse_args([]).step_watchdog_s is None


def test_chunked_prefill_off_matches_jax():
    """Without chunked prefill a prompt is admitted only whole: the 25-token
    prompt waits while the 20-token one takes the step's budget, and the
    streams equal the JAX engine's with that setting. A prompt over the
    budget is refused, as is the ring."""
    sched = dict(enable_chunked_prefill=False)
    jeng, teng = engine_pair(sched=sched)
    prompts = [[3 + (i * 13 + j) % 250 for j in range(n)] for i, n in enumerate((20, 25, 9))]
    started = []
    schedule = teng.scheduler.schedule

    def logged():
        batch = schedule()
        started.append(sorted(s.num_tokens for s in batch.prefills))
        return batch

    teng.scheduler.schedule = logged
    want = jeng.generate(prompts, JaxSP(temperature=0.0, max_tokens=6, ignore_eos=True))
    got = teng.generate(prompts, SamplingParams(temperature=0.0, max_tokens=6, ignore_eos=True))
    assert list(got.values()) == list(want.values())
    assert started[:2] == [[20], [25]]  # whole prompts; the 9 waits behind the 25 (FCFS)
    assert teng.stats.prompt_tokens == jeng.stats.prompt_tokens == 54
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match="chunked prefill is disabled"):
            eng.add_request(list(range(3, 36)))
    for cfg, cache in ((jcfg, jcfg.CacheConfig), (tcfg, tcfg.CacheConfig)):
        model = (jax_model_config if cfg is jcfg else get_model_config)("tiny-swa")
        econf = cfg.EngineConfig(model=model, cache=cache(page_size=4, num_blocks=96, swa_ring=True),
                                 scheduler=cfg.SchedulerConfig(**SCHED, **sched))
        with pytest.raises(ValueError, match="chunked prefill"):
            if cfg is jcfg:
                JaxEngine(econf)
            else:
                LLMEngine(econf, device="cpu")


def test_cached_prefix_pages_touches_nothing():
    teng = port_engine()
    prompt = list(range(3, 60))
    teng.generate([prompt], SamplingParams(temperature=0.0, max_tokens=2, ignore_eos=True))
    alloc = teng.allocator
    before = (alloc.metrics_queries, alloc.metrics_hits, list(alloc._free), alloc.num_free_pages)
    assert teng.cached_prefix_pages(prompt) == 3
    assert teng.cached_prefix_pages(prompt[:20] + [1] * 40) == 1
    assert (alloc.metrics_queries, alloc.metrics_hits, list(alloc._free),
            alloc.num_free_pages) == before


def test_surface_routes_are_the_jax_routes_but_the_deferred():
    """Every route the port serves, the JAX server serves under the same
    method and path, and the port serves all of the JAX server's but the
    two that wait for embeddings (LoRA's load and unload routes came with
    the adapters)."""
    def routes(app):
        return {(r.method, r.resource.canonical) for r in app.router.routes()
                if r.method != "HEAD"}

    port = routes(tapi.build_app(AsyncEngine(None), ByteTokenizer(), "m", 8))
    ref = routes(japi.build_app(JaxAsyncEngine.__new__(JaxAsyncEngine), JaxByteTokenizer(), "m", 8))
    assert port <= ref
    # What waits for its item: embeddings.
    assert ref - port == {("POST", "/v1/embeddings"), ("POST", "/vllm.Generation/Embed")}


def strip_response(obj):
    """A Responses API object without its ids and times."""
    if isinstance(obj, (list, tuple)):
        return [strip_response(o) for o in obj]
    if isinstance(obj, dict):
        return {k: strip_response(v) for k, v in obj.items()
                if k not in ("id", "created", "created_at")}
    return obj


async def read_events(r):
    """A Responses stream's (event, data) pairs."""
    events, name = [], None
    async for raw in r.content:
        line = raw.decode().strip()
        if line.startswith("event: "):
            name = line[len("event: "):]
        elif line.startswith("data: ") and name:
            events.append((name, json.loads(line[len("data: "):])))
    return events


async def each(pair, method, path, body=None, ids=(None, None)):
    """(status, JSON) from the JAX server, then the port's; ``ids`` fill a
    ``{}`` in ``path`` with each server's own object id."""
    out = []
    for c, oid in zip(pair.clients, ids):
        r = await c.request(method, path.format(oid), json=body)
        out.append((r.status, await r.json()))
    return out


def same_response(replies, status=200):
    (js, jbody), (ts, tbody) = replies
    assert js == ts == status, (jbody, tbody)
    assert strip_response(tbody) == strip_response(jbody)
    return jbody, tbody


async def test_responses_create_retrieve_chain_delete_match_jax(pair):
    """The cases of ``tests/test_serve_api.py``: create, retrieve, chain
    through ``previous_response_id``, delete, unknown ids; and the greedy
    text is the chat route's for the same messages."""
    body = {"model": "tiny", "input": "hello there", "max_output_tokens": 6, "temperature": 0.0}
    jfirst, tfirst = same_response(await each(pair, "POST", "/v1/responses", body))
    assert tfirst["object"] == "response" and tfirst["status"] == "completed"
    assert tfirst["usage"]["output_tokens"] == 6
    ids = (jfirst["id"], tfirst["id"])
    got = same_response(await each(pair, "GET", "/v1/responses/{}", ids=ids))
    assert [g["id"] for g in got] == list(ids)
    _, (_, chat) = await pair.post("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hello there"}], "max_tokens": 6,
        "temperature": 0.0})
    assert tfirst["output"][0]["content"][0]["text"] == chat["choices"][0]["message"]["content"]
    chained = []
    for c, rid in zip(pair.clients, ids):
        r = await c.post("/v1/responses", json={**body, "input": "second turn",
                                                "previous_response_id": rid})
        chained.append((r.status, await r.json()))
    _, tsecond = same_response(chained)
    assert tsecond["usage"]["input_tokens"] > tfirst["usage"]["input_tokens"]
    same_response(await each(pair, "POST", "/v1/responses",
                             {**body, "previous_response_id": "resp_nope"}), status=404)
    same_response(await each(pair, "DELETE", "/v1/responses/{}", ids=ids))
    same_response(await each(pair, "GET", "/v1/responses/{}", ids=ids), status=404)
    same_response(await each(pair, "POST", "/v1/responses",
                             {**body, "max_output_tokens": 0}), status=400)


async def test_responses_stream_events_match_jax(pair):
    body = {"model": "tiny", "input": "stream me", "max_output_tokens": 5,
            "temperature": 0.0, "stream": True}
    jevents, tevents = [await read_events(await c.post("/v1/responses", json=body))
                        for c in pair.clients]
    assert strip_response(tevents) == strip_response(jevents)
    names = [e for e, _ in tevents]
    assert names[0] == "response.created" and names[-1] == "response.completed"
    assert set(names[1:-1]) == {"response.output_text.delta"}
    final = tevents[-1][1]["response"]
    assert final["output"][0]["content"][0]["text"] == "".join(
        d["delta"] for e, d in tevents if e == "response.output_text.delta")


async def test_conversations_match_jax(pair):
    replies = await each(pair, "POST", "/v1/conversations", {"metadata": {"t": "1"}})
    jconv, tconv = same_response(replies)
    assert tconv["object"] == "conversation"
    ids = (jconv["id"], tconv["id"])
    same_response(await each(pair, "GET", "/v1/conversations/{}", ids=ids))
    items = {"items": [{"type": "message", "role": "user", "content": "remember me"}]}
    same_response(await each(pair, "POST", "/v1/conversations/{}/items", items, ids=ids))
    replies = []
    for c, cid in zip(pair.clients, ids):
        r = await c.post("/v1/responses", json={"model": "tiny", "input": "and this",
                                                "conversation": cid, "max_output_tokens": 4,
                                                "temperature": 0.0})
        replies.append((r.status, await r.json()))
    same_response(replies)
    _, listed = same_response(await each(pair, "GET", "/v1/conversations/{}/items", ids=ids))
    assert [m["role"] for m in listed["data"]] == ["user", "user", "assistant"]
    same_response(await each(pair, "POST", "/v1/responses", {
        "model": "tiny", "input": "x", "conversation": "conv_nope"}), status=404)
    same_response(await each(pair, "GET", "/v1/conversations/{}/items",
                             ids=("conv_nope", "conv_nope")), status=404)


@pytest.mark.parametrize("stream", [False, True], ids=["plain", "streamed"])
async def test_generate_matches_jax_and_the_completion_routes_tokens(pair, stream):
    """Generate, token in and token out: the JAX server's token ids,
    finish reason and usage; and the token ids the completion route
    annotates for the same prompt."""
    prompt = [7, 8, 9, 10, 11, 12]
    body = {"prompt_token_ids": prompt, "model": "any name", "stream": stream,
            "sampling_params": {"max_tokens": 9, "temperature": 0.8, "seed": 4,
                                "ignore_eos": True, "priority": 1}}
    (js, jbody), (ts, tbody) = await pair.post("/vllm.Generation/Generate", body)
    assert js == ts == 200
    assert strip(tbody) == strip(jbody)
    if stream:
        assert tbody[-1] == "[DONE]"
        ids = [t for f in tbody[:-2] for t in f["token_ids"]]
        final = tbody[-2]
    else:
        ids, final = tbody["token_ids"], tbody
        assert tbody["kv_transfer_params"] is None and tbody["model"] == "tiny"
    assert len(ids) == 9 and final["finish_reason"] == "length"
    assert final["usage"]["completion_tokens"] == 9 and final["usage"]["prompt_tokens"] == 6
    r = await pair.clients[1].post("/v1/completions", json={
        "prompt": prompt, "max_tokens": 9, "temperature": 0.8, "seed": 4, "ignore_eos": True,
        "stream": True}, headers={"x-llmd-stream-tokens": "1"})
    frames = await read_body(r)
    assert [t for f in frames[:-2] for t in f["token_ids"]] == ids


@pytest.mark.parametrize("body", [
    [1, 2],
    {"prompt_token_ids": []},
    {"prompt_token_ids": ["a"]},
    {"prompt_token_ids": [1] * MAX_LEN},
    {"prompt_token_ids": [1, 2], "sampling_params": [1]},
    {"prompt_token_ids": [1, 2], "sampling_params": {"max_tokens": -1}},
    {"prompt_token_ids": [1, 2], "sampling_params": {"temperature": "hot"}},
], ids=["not-object", "empty", "not-ints", "too-long", "params-list", "negative", "bad-value"])
async def test_generate_refusals_match_jax(pair, body):
    (js, jbody), (ts, tbody) = await pair.post("/vllm.Generation/Generate", body)
    assert js == ts == 400 and tbody == jbody
