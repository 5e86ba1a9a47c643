"""The port's tracing (``llmd_tpu_torch.obs.tracing``) against the JAX
package's, on the CPU.

The cases of ``tests/test_tracing.py`` run on both modules; the same inputs
give the same ``traceparent`` strings, sampling decisions and OTLP JSON
(span items and the exporter's payload, which a stdlib HTTP sink receives
alike from both exporters). The port's server continues a caller's
``traceparent`` in an ``engine.generate`` span whose attributes equal the
JAX server's on the same requests (streamed, unstreamed, resumed, failed by
a deadline; an unsampled parent exports nothing), a collector that is down
costs no request, and the JAX package's router and a port replica share one
trace. About 8 s serial.
"""

import asyncio
import http.server
import json
import random
import socket
import threading

import pytest
from aiohttp.test_utils import TestClient, TestServer

import llmd_tpu.faults as jfaults
import llmd_tpu.obs.tracing as jtracing
import llmd_tpu_torch.faults as tfaults
import llmd_tpu_torch.obs.tracing as ttracing
from llmd_tpu.epp.config import DEFAULT_CONFIG, build_flow_control, build_scheduler
from llmd_tpu.epp.datalayer import EndpointStore
from llmd_tpu.epp.server import Router
from llmd_tpu.epp.types import Endpoint
from llmd_tpu_torch.serve.api import build_app
from llmd_tpu_torch.serve.async_engine import AsyncEngine
from llmd_tpu_torch.serve.tokenizer import ByteTokenizer

import test_torch_serve_surface as surface

pytestmark = pytest.mark.anyio

MODULES = {"jax": jtracing, "port": ttracing}
PARENT = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"


@pytest.fixture(scope="module")
def anyio_backend():
    return "asyncio"


@pytest.fixture(autouse=True)
def reset():
    yield
    for mod in MODULES.values():
        mod.reset_tracing()
    jfaults.disarm()
    tfaults.disarm()


@pytest.fixture(params=MODULES)
def tr(request):
    return MODULES[request.param]


# The cases of tests/test_tracing.py, on each module.


def test_traceparent_roundtrip(tr):
    tp = tr.format_traceparent("ab" * 16, "cd" * 8, True)
    assert tr.parse_traceparent(tp) == ("ab" * 16, "cd" * 8, 1)
    assert tr.parse_traceparent("garbage") is None
    assert tr.parse_traceparent(None) is None
    assert tr.parse_traceparent("00-" + "0" * 32 + "-" + "1" * 16 + "-01") is None


def test_sampling_ratio_extremes(tr):
    assert tr.Tracer("t", tr.InMemoryExporter(), sample_ratio=1.0).start_span("x").sampled
    assert not tr.Tracer("t", tr.InMemoryExporter(), sample_ratio=0.0).start_span("x").sampled


def test_parent_based_sampling_honors_parent_decision(tr):
    t = tr.Tracer("t", tr.InMemoryExporter(), sample_ratio=0.0)
    s = t.start_span("x", traceparent=tr.format_traceparent("ab" * 16, "cd" * 8, True))
    assert s.sampled and s.trace_id == "ab" * 16 and s.parent_id == "cd" * 8
    t2 = tr.Tracer("t", tr.InMemoryExporter(), sample_ratio=1.0)
    assert not t2.start_span("x", traceparent=tr.format_traceparent("ab" * 16, "cd" * 8, False)).sampled


def test_span_export_and_otlp_shape(tr):
    exp = tr.InMemoryExporter()
    t = tr.Tracer("svc", exp, sample_ratio=1.0)
    with t.span("op", foo="bar") as s:
        s.set("n", 3)
        s.event("milestone", k=1)
    (span,) = exp.spans
    otlp = span.to_otlp()
    assert otlp["name"] == "op" and {"foo", "n"} <= {a["key"] for a in otlp["attributes"]}
    assert otlp["events"][0]["name"] == "milestone"
    assert otlp["status"]["code"] == "STATUS_CODE_OK"


def test_span_error_status(tr):
    exp = tr.InMemoryExporter()
    t = tr.Tracer("svc", exp, sample_ratio=1.0)
    with pytest.raises(RuntimeError):
        with t.span("op"):
            raise RuntimeError("boom")
    assert exp.spans[0].to_otlp()["status"]["code"] == "STATUS_CODE_ERROR"


def test_file_exporter(tr, tmp_path):
    path = str(tmp_path / "spans.jsonl")
    t = tr.Tracer("svc", tr.FileExporter(path), sample_ratio=1.0)
    for name in ("a", "b"):
        with t.span(name):
            pass
    assert [json.loads(x)["name"] for x in open(path).read().splitlines()] == ["a", "b"]


def test_unconfigured_tracer_is_a_noop(tr):
    s = tr.get_tracer().start_span("x", traceparent=PARENT)
    assert not s.sampled and s.traceparent == ""
    s.set("k", 1)
    s.end()


# The same inputs, the same outputs.


def test_same_traceparents_and_sampling_decisions():
    rng = random.Random(5)
    ids = [f"{rng.getrandbits(128):032x}" for _ in range(200)]
    for ratio in (0.0, 0.1, 0.5, 1.0):
        tracers = [m.Tracer("t", m.InMemoryExporter(), sample_ratio=ratio) for m in MODULES.values()]
        for tid in ids:
            for flags in (None, 0, 1, 3):
                assert tracers[0]._sample(tid, flags) == tracers[1]._sample(tid, flags)
    values = [PARENT, "00-" + "ab" * 16 + "-" + "cd" * 8 + "-00", "garbage", "", None,
              "00-" + "ab" * 16 + "-" + "cd" * 8 + "-zz", " 00-" + "12" * 16 + "-" + "34" * 8 + "-01 "]
    assert [jtracing.parse_traceparent(v) for v in values] == [
        ttracing.parse_traceparent(v) for v in values]
    for tid in ids[:8]:
        for sampled in (False, True):
            assert jtracing.format_traceparent(tid, tid[:16], sampled) == (
                ttracing.format_traceparent(tid, tid[:16], sampled))


def fixed_span(mod, ok: bool = True):
    """One span with fixed ids, times, attributes of every type and an
    event, as ``mod`` encodes it."""
    s = mod.Span(None, "engine.generate", "ab" * 16, "cd" * 8, "ef" * 8, True, "SPAN_KIND_SERVER")
    s.start_ns, s.end_ns = 1_000, 2_000
    for k, v in (("b", True), ("i", 7), ("f", 0.5), ("s", "x"), ("o", [1])):
        s.set(k, v)
    s.events.append((1_500, "milestone", {"k": 1, "t": "y"}))
    if not ok:
        s.error("boom")
    return s


@pytest.mark.parametrize("ok", [True, False], ids=["ok", "error"])
def test_same_otlp_json(ok):
    jspan, tspan = fixed_span(jtracing, ok), fixed_span(ttracing, ok)
    assert tspan.to_otlp() == jspan.to_otlp()
    assert tspan.traceparent == jspan.traceparent
    jexp = jtracing.OtlpHttpExporter.__new__(jtracing.OtlpHttpExporter)
    texp = ttracing.OtlpHttpExporter.__new__(ttracing.OtlpHttpExporter)
    jexp.service_name = texp.service_name = "llmd-engine"
    assert texp._payload([tspan.to_otlp()]) == jexp._payload([jspan.to_otlp()])


class Sink:
    """A stdlib OTLP/HTTP collector on localhost: the bodies POSTed to
    ``/v1/traces``."""

    def __init__(self) -> None:
        bodies = self.bodies = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                bodies.append((self.path, json.loads(self.rfile.read(int(self.headers["Content-Length"])))))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def test_otlp_exporters_post_the_same_payload():
    sink = Sink()
    try:
        for mod in MODULES.values():
            exp = mod.OtlpHttpExporter(sink.url, "llmd-engine", flush_s=60.0)
            exp.export(fixed_span(mod))
            exp.close()  # flushes
        (jpath, jbody), (tpath, tbody) = sink.bodies
        assert tpath == jpath == "/v1/traces" and tbody == jbody
        assert tbody["resourceSpans"][0]["scopeSpans"][0]["spans"][0]["traceId"] == "ab" * 16
    finally:
        sink.close()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def test_a_collector_that_is_down_costs_no_request():
    """Spans bound for a closed port are dropped at export; the requests
    that ended them answer as without tracing."""
    tracer = ttracing.configure_tracing(
        "llmd-engine", otlp_endpoint=f"http://127.0.0.1:{free_port()}", sample_ratio=1.0)
    tracer.exporter.flush_s = 0.01
    c = TestClient(TestServer(build_app(AsyncEngine(surface.port_engine()), ByteTokenizer(),
                                        "tiny", surface.MAX_LEN)))
    await c.start_server()
    try:
        for stream in (False, True):
            r = await c.post("/v1/completions", json={"prompt": "hi", "max_tokens": 3,
                                                      "stream": stream},
                             headers={"traceparent": PARENT})
            assert r.status == 200
            await r.read()
    finally:
        await c.close()
    ttracing.reset_tracing()  # flushes into the closed port: dropped, no raise


@pytest.fixture(scope="module")
async def servers():
    p = await surface.start_pair(*surface.engine_pair())
    yield p
    for c in p.clients:
        await c.close()


def attributes(span) -> dict:
    return {a["key"]: a["value"] for a in span.to_otlp()["attributes"]}


async def traced_both(servers, path, body, headers, ratio=0.0):
    """Each server's reply and the spans its package exported."""
    out = []
    for mod, c in zip(MODULES.values(), servers.clients):
        exp = mod.InMemoryExporter()
        mod.configure_tracing("llmd-engine", exporter=exp, sample_ratio=ratio)
        r = await c.post(path, json=body, headers=headers)
        out.append((r.status, await surface.read_body(r), exp.spans))
        mod.reset_tracing()
    return out


@pytest.mark.parametrize("case", ["plain", "streamed", "chat", "n=2", "resumed", "deadline"])
async def test_server_span_matches_jax(servers, case):
    """The ``engine.generate`` span continues the caller's trace, child of
    its span, with the JAX server's attributes and status; its token
    attributes are the reply's usage."""
    path, body = "/v1/completions", {"prompt": "traced", "max_tokens": 5, "temperature": 0.0}
    headers = {"traceparent": PARENT}
    if case == "streamed":
        body["stream"] = True
    elif case == "chat":
        path, body = "/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                               "max_tokens": 4, "temperature": 0.0, "stream": True}
    elif case == "n=2":
        body.update(n=2, seed=1, temperature=0.8)
    elif case == "resumed":
        body["resume_token_ids"] = [70, 71]
    elif case == "deadline":
        headers["x-request-deadline-s"] = "0.05"
        plan = json.dumps({"faults": [{"site": "engine.step.stall", "delay_ms": 200}]})
        jfaults.arm(jfaults.FaultPlan.from_json(plan))
        tfaults.arm(tfaults.FaultPlan.from_json(plan))
    (js, jbody, jspans), (ts, tbody, tspans) = await traced_both(servers, path, body, headers)
    assert js == ts
    assert len(jspans) == len(tspans) == 1
    (jspan,), (tspan,) = jspans, tspans
    assert (tspan.name, tspan.kind, tspan.trace_id, tspan.parent_id) == (
        "engine.generate", "SPAN_KIND_SERVER", "ab" * 16, "cd" * 8)
    assert attributes(tspan) == attributes(jspan)
    assert tspan.status_ok == jspan.status_ok == (case != "deadline")
    if case == "deadline":
        await asyncio.sleep(0.3)  # the stalled steps end
        return
    usage = tbody["usage"] if isinstance(tbody, dict) else tbody[-2]["usage"]
    attrs = attributes(tspan)
    assert int(attrs["gen_ai.usage.completion_tokens"]["intValue"]) == usage["completion_tokens"]
    assert int(attrs["gen_ai.usage.prompt_tokens"]["intValue"]) == usage["prompt_tokens"]
    assert int(attrs["llm_d.cache.hit_tokens"]["intValue"]) == usage.get(
        "prompt_tokens_details", {}).get("cached_tokens", 0)
    if case == "resumed":
        assert attrs["llm_d.resume.tokens"] == {"intValue": "2"}


async def test_unsampled_parent_exports_nothing(servers):
    headers = {"traceparent": PARENT[:-2] + "00"}
    replies = await traced_both(servers, "/v1/completions", {"prompt": "quiet", "max_tokens": 2},
                                headers, ratio=1.0)
    assert [(s, spans) for s, _, spans in replies] == [(200, []), (200, [])]


async def test_router_to_port_engine_trace_linkage():
    """One request through the JAX package's router to a port replica: the
    router's span and the port's engine span share the trace, the engine's
    a child of the router's."""
    jexp, texp = jtracing.InMemoryExporter(), ttracing.InMemoryExporter()
    jtracing.configure_tracing("test", exporter=jexp, sample_ratio=1.0)
    ttracing.configure_tracing("test", exporter=texp, sample_ratio=1.0)
    es = TestServer(build_app(AsyncEngine(surface.port_engine()), ByteTokenizer(), "tiny",
                              surface.MAX_LEN))
    await es.start_server()
    store = EndpointStore()
    store.upsert(Endpoint(address=f"{es.host}:{es.port}"))
    router = Router(store=store, scheduler=build_scheduler(DEFAULT_CONFIG),
                    flow_control=build_flow_control(DEFAULT_CONFIG))
    rc = TestClient(TestServer(router.build_app()))
    await rc.start_server()
    try:
        r = await rc.post("/v1/completions",
                          json={"model": "tiny", "prompt": "hello", "max_tokens": 4})
        assert r.status == 200
        routers = [s for s in jexp.spans if s.name == "router.request"]
        (engine_span,) = texp.spans
        (router_span,) = routers
        assert engine_span.name == "engine.generate"
        assert engine_span.trace_id == router_span.trace_id
        assert engine_span.parent_id == router_span.span_id
        assert router_span.attributes.get("llm_d.decision.endpoint") == f"{es.host}:{es.port}"
        assert "llm_d.cache.hit_tokens" in engine_span.attributes
    finally:
        await rc.close()
        await es.close()
