"""Failover resume, request deadlines and the fault plan: the port's server
against the JAX server, on the CPU.

A JAX server and the port's serve one tiny f32 model each (the port on the
JAX engine's parameters, ``test_torch_serve_surface.engine_pair``), and the
same bodies go to both:

- ``resume_token_ids``: greedy and seeded streams on completions and chat,
  resumed at every cut point (the first token, the middle, the last but
  one, all of them), must give the JAX server's continuation frame for
  frame, and with the history the uncut stream; so must the unstreamed
  continuation, a history that ends on a stop token, Generate's resume,
  the refusals (and their count), the admission counters, and the chat
  preamble that ``x-llmd-resume`` suppresses (the cases of
  ``tests/test_stream_resume.py``).
- A mixed fleet: the JAX package's ``Router`` over one JAX replica and one
  port replica, each package's fault plan cutting its own replica's leg in
  turn; the client must receive the uncut stream.
- ``x-request-deadline-s`` and ``LLMD_REQUEST_DEADLINE_S``: a 504 or a
  terminal frame with the JAX server's status and body, the engine request
  aborted, and a malformed value meaning no deadline. A step stalled by
  each package's ``engine.step.stall`` site outlives the deadline.
- One fault plan's JSON armed in both packages fires the same hits over the
  same calls, ``p < 1`` included, and ``/metrics`` prints the same
  ``faults_injected_total`` lines.

About 25 s serial.
"""

import asyncio
import json
import time

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import llmd_tpu.faults as jfaults
import llmd_tpu_torch.faults as tfaults
from llmd_tpu.engine.engine import EngineStats as JaxStats
from llmd_tpu.epp.config import DEFAULT_CONFIG, build_flow_control, build_scheduler
from llmd_tpu.epp.datalayer import EndpointStore, MetricsCollector
from llmd_tpu.epp.server import Router
from llmd_tpu.epp.types import HDR_RESUME, HDR_STREAM_TOKENS, Endpoint
from llmd_tpu.serve.metrics import render_metrics as jax_render_metrics
from llmd_tpu_torch.engine import SamplingParams
from llmd_tpu_torch.engine.engine import EngineStats
from llmd_tpu_torch.serve import api as tapi
from llmd_tpu_torch.serve.metrics import render_metrics

import test_torch_serve_surface as surface

pytestmark = pytest.mark.anyio

STREAM_TOKENS = {"x-llmd-stream-tokens": "1"}
ROUTES = {
    "completions": ("/v1/completions", {"prompt": "resume parity matrix"}),
    "chat": ("/v1/chat/completions", {"messages": [{"role": "user", "content": "resume, please"}]}),
}
SAMPLING = {"greedy": {"temperature": 0.0}, "seeded": {"temperature": 0.8, "seed": 11}}


@pytest.fixture(scope="module")
def anyio_backend():
    return "asyncio"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def disarmed():
    yield
    jfaults.disarm()
    tfaults.disarm()


@pytest.fixture(scope="module")
async def servers():
    p = await surface.start_pair(*surface.engine_pair())
    yield p
    for c in p.clients:
        await c.close()


def same(replies, status=200):
    """The port's reply equals the JAX server's (``id`` and ``created``
    aside); returns the port's body."""
    (js, jbody), (ts, tbody) = replies
    assert js == ts == status, (jbody, tbody)
    assert surface.strip(tbody) == surface.strip(jbody)
    return tbody


def tokens_text(frames, chat: bool):
    """A stream's annotated token ids, its text, its finish reason and
    its usage."""
    toks, text, finish, usage = [], "", None, None
    for f in frames:
        if not isinstance(f, dict) or "choices" not in f:
            continue
        toks += f.get("token_ids") or []
        for c in f["choices"]:
            text += (c.get("delta", {}).get("content") or "") if chat else (c.get("text") or "")
            finish = c.get("finish_reason") or finish
        usage = f.get("usage") or usage
    return toks, text, finish, usage


@pytest.mark.parametrize("sampling", SAMPLING)
@pytest.mark.parametrize("route", ROUTES)
async def test_resumed_streams_match_jax_at_every_cut(servers, route, sampling):
    """A stream resumed from each cut point continues as the JAX server's
    does, frame for frame, and the history plus the continuation is the
    uncut stream: tokens, text, finish reason and usage."""
    path, body = ROUTES[route]
    chat = route == "chat"
    body = {**body, **SAMPLING[sampling], "max_tokens": 12, "stream": True}
    frames = same(await servers.post(path, body, STREAM_TOKENS))
    toks, text, finish, usage = tokens_text(frames, chat)
    assert len(toks) >= 2 and finish
    for cut in sorted({1, len(toks) // 2, len(toks) - 1, len(toks)}):
        got = same(await servers.post(path, {**body, "resume_token_ids": toks[:cut]},
                              STREAM_TOKENS))
        rt, rx, rf, rusage = tokens_text(got, chat)
        assert toks[:cut] + rt == toks, f"cut {cut}: the token stream parted"
        assert text.endswith(rx) and rf == finish
        assert (rusage["completion_tokens"], rusage["prompt_tokens"]) == (
            usage["completion_tokens"], usage["prompt_tokens"])
        if chat:
            assert all(f["choices"][0]["delta"] != {"role": "assistant"}
                       for f in got if isinstance(f, dict) and f.get("choices"))


async def test_unstreamed_continuation_matches_jax(servers):
    body = {"prompt": "nonstream resume", "max_tokens": 8, "temperature": 0.0}
    frames = same(await servers.post("/v1/completions", {**body, "stream": True}, STREAM_TOKENS))
    toks, text, finish, usage = tokens_text(frames, chat=False)
    reply = same(await servers.post("/v1/completions", {**body, "resume_token_ids": toks[:3]}))
    assert text.endswith(reply["choices"][0]["text"])
    assert reply["choices"][0]["finish_reason"] == finish
    assert reply["usage"]["completion_tokens"] == usage["completion_tokens"]
    assert reply["usage"]["prompt_tokens"] == usage["prompt_tokens"]


async def test_history_ending_on_a_stop_token_finishes_as_jax(servers):
    body = {"prompt": "stop resume", "max_tokens": 12, "temperature": 0.0, "stream": True}
    toks, *_ = tokens_text(same(await servers.post("/v1/completions", body, STREAM_TOKENS)), False)
    sbody = {**body, "stop_token_ids": [toks[4]]}
    st, _, sf, susage = tokens_text(
        same(await servers.post("/v1/completions", sbody, STREAM_TOKENS)), False)
    assert sf == "stop" and st[-1] == toks[4]
    for stream in (True, False):
        got = same(await servers.post("/v1/completions",
                              {**sbody, "stream": stream, "resume_token_ids": st}, STREAM_TOKENS))
        rt, rx, rf, rusage = tokens_text(got if stream else [got], False)
        assert (rt, rx, rf) == ([], "", "stop")
        assert rusage["completion_tokens"] == susage["completion_tokens"]


async def test_generate_resume_matches_jax(servers):
    body = {"prompt_token_ids": [7, 8, 9, 10, 11],
            "sampling_params": {"max_tokens": 10, "temperature": 0.0, "ignore_eos": True}}
    base = same(await servers.post("/vllm.Generation/Generate", body))
    assert len(base["token_ids"]) == 10
    got = same(await servers.post("/vllm.Generation/Generate",
                          {**body, "resume_token_ids": base["token_ids"][:4]}))
    assert base["token_ids"][:4] + got["token_ids"] == base["token_ids"]
    assert (got["finish_reason"], got["usage"]["completion_tokens"]) == (
        base["finish_reason"], 10)
    frames = same(await servers.post("/vllm.Generation/Generate",
                             {**body, "stream": True, "resume_token_ids": base["token_ids"][:4]}))
    assert [t for f in frames[:-2] for t in f["token_ids"]] == got["token_ids"]
    assert frames[-2]["usage"]["completion_tokens"] == 10
    # The whole history: only the lost terminal frame is sent again.
    for stream in (False, True):
        done = same(await servers.post("/vllm.Generation/Generate",
                               {**body, "stream": stream, "resume_token_ids": base["token_ids"]}))
        final = done[0] if stream else done
        assert final["finish_reason"] == "length" and final.get("token_ids", []) == []


async def test_refused_resumes_count_as_in_jax(servers):
    before = [a.stats.stream_resume_failures_total for a in servers.aengines]
    for body in ({"prompt": "x", "max_tokens": 4, "n": 2, "resume_token_ids": [1]},
                 {"prompt": "x", "max_tokens": 2, "resume_token_ids": [1, 2, 3]},
                 {"prompt": "x", "max_tokens": 4, "resume_token_ids": [-1]}):
        same(await servers.post("/v1/completions", body), status=400)
    same(await servers.post("/vllm.Generation/Generate", {
        "prompt_token_ids": [5, 6], "sampling_params": {"max_tokens": 1},
        "resume_token_ids": [1, 2]}), status=400)
    assert [a.stats.stream_resume_failures_total - b
            for a, b in zip(servers.aengines, before)] == [4, 4]


async def test_resume_admission_counters_match_jax(servers):
    body = {"prompt": "metrics resume", "max_tokens": 6, "temperature": 0.0, "stream": True}
    toks, *_ = tokens_text(same(await servers.post("/v1/completions", body, STREAM_TOKENS)), False)
    stats = [a.stats for a in servers.aengines]
    before = [(s.stream_resumes_total, s.resume_replayed_tokens_total) for s in stats]
    same(await servers.post("/v1/completions", {**body, "resume_token_ids": toks[:2]}))
    assert [(s.stream_resumes_total - r, s.resume_replayed_tokens_total - t)
            for s, (r, t) in zip(stats, before)] == [(1, 2), (1, 2)]
    pages = await servers.get_text("/metrics")
    names = ("stream_resumes_total", "resume_replayed_tokens_total",
             "stream_resume_failures_total")
    jlines, tlines = ([ln for ln in page.splitlines() if ln.split("{")[0].split(":")[-1] in names]
                      for page in pages)
    assert tlines == jlines and len(tlines) == 6


async def test_resume_header_suppresses_the_chat_preamble(servers):
    body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
            "temperature": 0.0, "stream": True}
    frames = same(await servers.post("/v1/chat/completions", body))
    assert frames[0]["choices"][0]["delta"] == {"role": "assistant"}
    frames = same(await servers.post("/v1/chat/completions", body, {HDR_RESUME: "1"}))
    assert all(f["choices"][0]["delta"] != {"role": "assistant"}
               for f in frames if isinstance(f, dict) and f.get("choices"))


def test_header_names_are_the_routers():
    assert (tapi.HDR_STREAM_TOKENS, tapi.HDR_RESUME) == (HDR_STREAM_TOKENS, HDR_RESUME)


def test_engines_refuse_a_resume_without_a_prompt_head(servers):
    errors = []
    for aeng in servers.aengines:
        with pytest.raises(ValueError) as e:
            aeng.engine.add_request([5, 6, 7], SamplingParams(max_tokens=2), resume_output_tokens=3)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


class FirstPick:
    """The router's scheduler, whose first pick for a request is
    ``address``: the replica whose leg a test cuts. The resume leg goes to
    the other replica, as the router excludes the endpoint it tried."""

    def __init__(self, inner, address: str) -> None:
        self.inner, self.address = inner, address

    def schedule(self, req, pods):
        return self.inner.schedule(req, [p for p in pods if p.address == self.address] or pods)

    def __getattr__(self, name):
        return getattr(self.inner, name)


@pytest.mark.parametrize("sampling", SAMPLING)
@pytest.mark.parametrize("cut", ["port", "jax"])
async def test_mixed_fleet_router_hides_a_cut_leg(servers, cut, sampling):
    """The JAX package's router over a JAX replica and a port replica: when
    one dies mid-stream (its own package's ``serve.stream.cut``), the
    router resumes the stream on the other from the delivered token ids,
    and the client receives the uncut stream's text, finish and usage."""
    addresses = {name: f"{c.server.host}:{c.server.port}"
                 for name, c in zip(("jax", "port"), servers.clients)}
    store = EndpointStore()
    for address in addresses.values():
        store.upsert(Endpoint(address=address, labels={"llm-d.ai/engine-type": "llmd"}))
    router = Router(
        store=store,
        scheduler=FirstPick(build_scheduler(DEFAULT_CONFIG), addresses[cut]),
        flow_control=build_flow_control(DEFAULT_CONFIG),
        collector=MetricsCollector(store, interval_s=0.2),
        max_resumes=2, retry_backoff_s=0.001, retry_backoff_cap_s=0.01,
    )
    rc = TestClient(TestServer(router.build_app()))
    await rc.start_server()
    try:
        body = {"prompt": f"mixed fleet, {cut} leg cut", "max_tokens": 10, "stream": True,
                **SAMPLING[sampling]}
        base = await surface.read_body(await rc.post("/v1/completions", json=body))
        bt, bx, bf, busage = tokens_text(base, chat=False)
        assert bt == [] and bf, "token annotations must not reach the client"
        plan = json.dumps({"seed": 3, "faults": [
            {"site": "serve.stream.cut", "after": 2, "times": 1}]})
        faults = tfaults if cut == "port" else jfaults
        faults.arm(faults.FaultPlan.from_json(plan))
        resumes = router.metrics.stream_resumes
        got = await surface.read_body(await rc.post("/v1/completions", json=body))
        assert faults.injected_counts() == {"serve.stream.cut": 1}
        t, x, f, usage = tokens_text(got, chat=False)
        assert (t, x, f) == ([], bx, bf), "the resumed stream parted from the uncut one"
        assert usage["completion_tokens"] == busage["completion_tokens"]
        assert router.metrics.stream_resumes == resumes + 1
    finally:
        await rc.close()


async def wait_idle(aeng, timeout_s: float = 10.0) -> None:
    t0 = time.monotonic()
    while aeng.engine.has_work() or aeng._inbox:
        assert time.monotonic() - t0 < timeout_s, "the engine kept working"
        await asyncio.sleep(0.01)


async def stalled_both(servers, path, body, headers, stall_ms=300):
    """Each server in turn with its first engine step stalled by its own
    package's ``engine.step.stall``; waits until the engine is idle again."""
    out = []
    plan = json.dumps({"faults": [{"site": "engine.step.stall", "delay_ms": stall_ms}]})
    for faults, c, aeng in zip((jfaults, tfaults), servers.clients, servers.aengines):
        faults.arm(faults.FaultPlan.from_json(plan))
        r = await c.post(path, json=body, headers=headers)
        out.append((r.status, await surface.read_body(r)))
        await wait_idle(aeng)
        faults.disarm()
        # Aborted: nothing runs (the gauges refresh at the next step).
        assert aeng.engine.scheduler.num_running == 0
    return out


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("stream", [False, True], ids=["plain", "streamed"])
async def test_deadline_matches_jax(servers, route, stream):
    """A deadline that passes during a stalled step: 504 ``timeout_error``
    unstreamed, a terminal error frame streamed; the request is aborted."""
    path, body = ROUTES[route]
    body = {**body, "max_tokens": 4, "temperature": 0.0, "stream": stream}
    reply = same(await stalled_both(servers, path, body, {"x-request-deadline-s": "0.05"}),
                 status=200 if stream else 504)
    error = reply[-2] if stream else reply
    assert error["error"]["code"] == 504 and "deadline" in error["error"]["message"]
    if not stream:
        assert error["error"]["type"] == "timeout_error"


async def test_generate_deadline_matches_jax(servers):
    body = {"prompt_token_ids": [9, 8, 7], "sampling_params": {"max_tokens": 4}}
    for stream in (False, True):
        same(await stalled_both(servers, "/vllm.Generation/Generate", {**body, "stream": stream},
                                {"x-request-deadline-s": "0.05"}),
             status=200 if stream else 504)


@pytest.mark.parametrize("header,env,status", [
    (None, "0.05", 504),      # the environment's deadline
    ("soon", "0.05", 200),    # a malformed header: no deadline, env unread
    ("-1", None, 200),        # not positive: no deadline
    ("60", None, 200),        # ample
], ids=["env", "malformed", "negative", "ample"])
async def test_deadline_sources_match_jax(servers, monkeypatch, header, env, status):
    if env is None:
        monkeypatch.delenv("LLMD_REQUEST_DEADLINE_S", raising=False)
    else:
        monkeypatch.setenv("LLMD_REQUEST_DEADLINE_S", env)
    body = {"prompt": "deadline sources", "max_tokens": 4, "temperature": 0.0}
    headers = {} if header is None else {"x-request-deadline-s": header}
    reply = same(await stalled_both(servers, "/v1/completions", body, headers), status=status)
    if status == 200:
        # The text of the same request without a deadline.
        monkeypatch.delenv("LLMD_REQUEST_DEADLINE_S", raising=False)
        plain = same(await servers.post("/v1/completions", body))
        assert reply["choices"] == plain["choices"]


PLANS = {
    "windows": {"faults": [{"site": "serve.stream.cut", "match": "req-a", "times": 2, "after": 1}]},
    "probability": {"seed": 7, "faults": [
        {"site": "serve.stream.cut", "p": 0.3, "times": None},
        {"site": "engine.step.stall", "p": 0.5, "times": 5, "delay_ms": 4}]},
    "catalog": {"seed": 2, "faults": [
        {"site": "kv.pull.drop", "match": "b", "times": None, "p": 0.6},
        {"site": "replica.crash", "after": 3, "times": 2},
        {"site": "serve.stream.cut", "match": "req-b", "after": 5, "times": None, "p": 0.8}]},
}


@pytest.mark.parametrize("plan", PLANS)
def test_one_plan_fires_alike_in_both_packages(plan):
    text = json.dumps(PLANS[plan])
    sites = ("serve.stream.cut", "engine.step.stall", "kv.pull.drop", "replica.crash")
    calls = [(sites[i % 4], f"req-{'ab'[i % 3 % 2]}:{i}") for i in range(240)]
    hits = []
    for faults in (jfaults, tfaults):
        faults.arm(faults.FaultPlan.from_json(text))
        hits.append(([faults.delay_s(s, k) if s == "engine.step.stall" else faults.fires(s, k)
                      for s, k in calls], faults.injected_counts()))
    assert hits[1] == hits[0]
    assert any(hits[0][0])


def test_fault_catalog_and_refusals_are_the_jax_packages():
    assert tfaults.SITES == jfaults.SITES
    for faults in (jfaults, tfaults):
        with pytest.raises(ValueError, match="unknown fault site"):
            faults.FaultSpec(site="serve.stream.cutt")
        faults.disarm()
        assert not faults.fires("serve.stream.cut", "x") and faults.active() is None
        assert faults.delay_s("engine.step.stall") == 0.0 and faults.injected_counts() == {}


def test_injected_faults_on_metrics_match_jax():
    text = json.dumps(PLANS["catalog"])
    for faults in (jfaults, tfaults):
        faults.arm(faults.FaultPlan.from_json(text))
        for i in range(12):
            faults.fires("kv.pull.drop", f"b{i}")
            faults.fires("replica.crash", "r")
    page = render_metrics(EngineStats(), "m")
    assert page == jax_render_metrics(JaxStats(), "m")
    assert 'llmd:faults_injected_total{site="replica.crash",model_name="m"} 2' in page
    tfaults.disarm()
    assert "faults_injected_total" not in render_metrics(EngineStats(), "m")


def test_step_stall_site_delays_the_ports_step():
    eng = surface.port_engine()
    eng.add_request([5, 6, 7], SamplingParams(max_tokens=1, temperature=0.0))
    tfaults.arm(tfaults.FaultPlan.from_json(
        json.dumps({"faults": [{"site": "engine.step.stall", "delay_ms": 200}]})))
    t0 = time.perf_counter()
    eng.step()
    assert time.perf_counter() - t0 >= 0.2
    assert tfaults.injected_counts() == {"engine.step.stall": 1}
