"""Two port servers in one process speaking llm-d's P/D two-phase protocol,
against two JAX servers, on the CPU.

The routing sidecar's flow (``deploy/guides/pd-disaggregation``): the
prefill server gets the request with ``max_tokens=1`` and
``kv_transfer_params: {"do_remote_decode": true}`` and answers with the
transfer params; the decode server gets the request with those params,
pulls the KV over the shipper (TCP: each pair's fast path is off) and
decodes. On completions, chat and Generate, streamed and not, the port
pair's answers equal the JAX pair's (ids, times and the shipper's key and
port aside), and so do the ``/metrics`` pages of both roles (but the host
times and the first-group ms). A deadline that passes during the fetch is
a 504 on both, and the import's pages come back. With the producer gone
the decode server answers alone (``import_failures`` counts it), as the
guide's "Verify" step 3 asks.
"""

import asyncio
import json
import socket
import time

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

import llmd_tpu.config as jcfg
import llmd_tpu.serve.api as japi
import llmd_tpu_torch.config as tcfg
import llmd_tpu_torch.serve.api as tapi
from llmd_tpu import faults as jfaults
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.serve.async_engine import AsyncEngine as JaxAsyncEngine
from llmd_tpu.serve.metrics import parse_prometheus
from llmd_tpu.serve.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmd_tpu_torch import faults as tfaults
from llmd_tpu_torch.engine import LLMEngine
from llmd_tpu_torch.models.llama import params_from_jax
from llmd_tpu_torch.serve.async_engine import AsyncEngine
from llmd_tpu_torch.serve.tokenizer import ByteTokenizer

from test_torch_serve_surface import read_body, strip
from test_torch_spec import jax_compile_cache, one_thread  # noqa: F401 (module fixtures)

pytestmark = pytest.mark.anyio

MAX_LEN = 256
TINY = dict(vocab_size=512, max_model_len=MAX_LEN)
CACHE = dict(page_size=16, num_blocks=64, dtype="float32")
SCHED = dict(max_num_seqs=8, max_num_batched_tokens=64)
# Series that are host times.
TIMED = ("step_host_gap_ms", "step_host_gap_ms_total", "kv_stream_first_group_ms")


@pytest.fixture(scope="module")
def anyio_backend():
    return "asyncio"


def kw(mod, role):
    return dict(model=mod.tiny_model_config(**TINY), cache=mod.CacheConfig(**CACHE),
                scheduler=mod.SchedulerConfig(**SCHED), kv_role=role, kv_transfer_port=0,
                kv_local_fastpath=False)


class Servers:
    """The JAX prefill and decode servers and the port's (on the JAX
    parameters)."""

    async def start(self):
        self.jeng = {r: JaxEngine(jcfg.EngineConfig(**kw(jcfg, r), parallel=jcfg.ParallelConfig()))
                     for r in ("kv_producer", "kv_consumer")}
        params = params_from_jax(jax.tree.map(np.asarray, self.jeng["kv_producer"].runner.params))
        self.teng = {r: LLMEngine(tcfg.EngineConfig(**kw(tcfg, r)), params=params, device="cpu")
                     for r in ("kv_producer", "kv_consumer")}
        self.clients = {}
        for side, engines, build, AE, Tok in (
                ("jax", self.jeng, japi.build_app, JaxAsyncEngine, JaxByteTokenizer),
                ("port", self.teng, tapi.build_app, AsyncEngine, ByteTokenizer)):
            for role, eng in engines.items():
                c = TestClient(TestServer(build(AE(eng), Tok(), "tiny", MAX_LEN)))
                await c.start_server()
                self.clients[side, role] = c
        return self

    async def post(self, side, role, path, body, headers=None):
        r = await self.clients[side, role].post(path, json=body, headers=headers or {})
        return r.status, await read_body(r)

    async def close(self):
        for c in self.clients.values():
            await c.close()
        for e in (*self.jeng.values(), *self.teng.values()):
            e.close()


@pytest.fixture(scope="module")
async def servers():
    s = await Servers().start()
    yield s
    await s.close()


def prompt_text(i: int) -> str:
    rng = np.random.default_rng(i)
    return "".join(chr(c) for c in rng.integers(97, 123, size=90))


def without_transfer_ids(obj):
    """A response without ids, times and the shipper's key and port."""
    obj = strip(obj)
    if isinstance(obj, dict) and isinstance(obj.get("kv_transfer_params"), dict):
        obj["kv_transfer_params"] = {k: v for k, v in obj["kv_transfer_params"].items()
                                     if k not in ("remote_key", "remote_port")}
    return obj


async def two_phase(s, side, route, body, stream=False, headers=None):
    """The sidecar's two requests; returns (prefill answer, decode status
    and answer)."""
    prefill = {**body, "max_tokens": 1, "temperature": 0.0,
               "kv_transfer_params": {"do_remote_decode": True}}
    if route == "/vllm.Generation/Generate":
        prefill = {"prompt_token_ids": body["prompt_token_ids"], "kv_transfer_params":
                   {"do_remote_decode": True},
                   "sampling_params": {"max_tokens": 1, "temperature": 0.0}}
    st, pre = await s.post(side, "kv_producer", route, prefill)
    assert st == 200, pre
    params = pre["kv_transfer_params"]
    assert params["remote_host"] == "127.0.0.1" and params["num_full_pages"] >= 5
    decode = {**body, "kv_transfer_params": params, "stream": stream}
    st, out = await s.post(side, "kv_consumer", route, decode, headers)
    return pre, st, out


ROUTES = {
    "/v1/completions": lambda i: {"prompt": prompt_text(i), "max_tokens": 8, "temperature": 0.0},
    "/v1/chat/completions": lambda i: {"messages": [{"role": "user", "content": prompt_text(i)}],
                                       "max_tokens": 8, "temperature": 0.0},
    "/vllm.Generation/Generate": lambda i: {
        "prompt_token_ids": [int(t) for t in np.random.default_rng(i).integers(3, 500, 90)],
        "sampling_params": {"max_tokens": 8, "temperature": 0.0, "ignore_eos": True}},
}


@pytest.mark.parametrize("stream", [False, True], ids=["unstreamed", "streamed"])
@pytest.mark.parametrize("route", list(ROUTES))
async def test_two_phase_answers_equal_the_jax_pair(servers, route, stream):
    i = list(ROUTES).index(route) * 2 + int(stream) + 1
    got = {}
    for side in ("jax", "port"):
        imported = servers.jeng if side == "jax" else servers.teng
        before = imported["kv_consumer"].kv_connector.imported_requests
        pre, st, out = await two_phase(servers, side, route, ROUTES[route](i), stream)
        assert st == 200
        assert imported["kv_consumer"].kv_connector.imported_requests == before + 1
        got[side] = (without_transfer_ids(pre), without_transfer_ids(out))
    assert got["port"] == got["jax"]


def metric_values(text: str) -> dict:
    timed = {f"{fam}:{n}" for fam in ("vllm", "llmd") for n in TIMED}
    return {k: v for k, v in parse_prometheus(text).items() if k not in timed}


async def test_metrics_of_both_roles_equal_the_jax_pair(servers):
    for side in ("jax", "port"):
        await two_phase(servers, side, "/v1/completions", ROUTES["/v1/completions"](20))
    # The staging threads count their bytes after the last registration,
    # and the page reads the stats of the last step: let them end, then
    # step each producer once more.
    for eng in (servers.jeng["kv_producer"], servers.teng["kv_producer"]):
        deadline = time.monotonic() + 10
        while eng.kv_connector._staging_active:
            assert time.monotonic() < deadline
            await asyncio.sleep(0.01)
    for side in ("jax", "port"):
        st, _ = await servers.post(side, "kv_producer", "/v1/completions",
                                   {"prompt": "x", "max_tokens": 1})
        assert st == 200
    pages = {}
    for (side, role), c in servers.clients.items():
        pages[side, role] = metric_values(await (await c.get("/metrics")).text())
    # The JAX producer dispatches an export-only step as prefill groups;
    # the port's keeps the flat step (its kernels K1'/K2').
    for fam in ("vllm", "llmd"):
        key = f"{fam}:unified_steps_total"
        assert pages["port", "kv_producer"].pop(key) > pages["jax", "kv_producer"].pop(key)
    for role in ("kv_producer", "kv_consumer"):
        assert pages["port", role] == pages["jax", role], role
    assert pages["port", "kv_producer"]["llmd:kv_transfer_exported_requests_total"] >= 1
    assert pages["port", "kv_consumer"]["llmd:kv_transfer_imported_bytes_total"] > 0
    assert pages["port", "kv_consumer"]["llmd:kv_stream_groups_total"] > 0


async def test_a_deadline_during_the_fetch_is_a_504(servers):
    """The consumer's first pull waits 1.5 s (``kv.pull.delay_ms``); the
    request's 0.3 s deadline passes during the fetch: 504 on both
    servers, and once the fetch ends the port's import pages are free."""
    plan = {"faults": [{"site": "kv.pull.delay_ms", "match": ":g0:c0", "delay_ms": 1500}]}
    free = servers.teng["kv_consumer"].allocator.num_free_pages
    for side, faults in (("jax", jfaults), ("port", tfaults)):
        faults.arm(faults.FaultPlan.from_json(json.dumps(plan)))
        try:
            _, st, out = await two_phase(servers, side, "/v1/completions",
                                         ROUTES["/v1/completions"](30),
                                         headers={"x-request-deadline-s": "0.3"})
        finally:
            faults.disarm()
        assert st == 504 and out["error"]["type"] == "timeout_error", (side, out)
    deadline = time.monotonic() + 10
    while servers.teng["kv_consumer"].allocator.num_free_pages != free:
        assert time.monotonic() < deadline
        await asyncio.sleep(0.05)


async def test_the_decoder_answers_alone_once_the_producer_is_gone(servers):
    """The producer is gone after its answer (its params name a port where
    nothing listens): the decode server recomputes, answers as the JAX
    pair does, and counts the failed import."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        dead_port = sock.getsockname()[1]
    got = {}
    for side, engines in (("jax", servers.jeng), ("port", servers.teng)):
        body = ROUTES["/v1/completions"](40)
        prefill = {**body, "max_tokens": 1, "kv_transfer_params": {"do_remote_decode": True}}
        st, pre = await servers.post(side, "kv_producer", "/v1/completions", prefill)
        params = {**pre["kv_transfer_params"], "remote_port": dead_port}
        failures = engines["kv_consumer"].kv_connector.import_failures
        st, out = await servers.post(side, "kv_consumer", "/v1/completions",
                                     {**body, "kv_transfer_params": params})
        assert st == 200
        assert engines["kv_consumer"].kv_connector.import_failures == failures + 1
        got[side] = without_transfer_ids(out)
    assert got["port"] == got["jax"]
    assert "prompt_tokens_details" not in got["port"]["usage"]  # recomputed


@pytest.mark.parametrize("address,host,warns", [
    ("10.1.2.3:8000", "10.1.2.3", False), (None, "0.0.0.0", True)])
def test_advertised_address_is_the_producers_host(monkeypatch, caplog, address, host, warns):
    """``--advertised-address`` (else ``--host``:``--port``) names the host
    a producer tells consumers; binding all interfaces without it warns,
    as the JAX server does."""
    from aiohttp import web

    import llmd_tpu_torch.engine as engine_pkg
    from llmd_tpu_torch.serve import __main__ as serve

    made = []

    class Recording(LLMEngine):
        def __init__(self, config, **kw):
            super().__init__(config, **kw)
            made.append(self)

    monkeypatch.setattr(engine_pkg, "LLMEngine", Recording)
    monkeypatch.setattr(web, "run_app", lambda app, **kw: None)
    argv = ["--model", "tiny", "--device", "cpu", "--dtype", "float32", "--num-blocks", "16",
            "--skip-warmup", "--kv-transfer-config",
            '{"kv_connector": "TPUConnector", "kv_role": "kv_producer", "transfer_port": 0}']
    serve.main(argv + (["--advertised-address", address] if address else []))
    (eng,) = made
    try:
        assert eng.config.kv_host == eng.kv_connector.cfg.host == host
        assert eng.kv_connector.server.port > 0
        assert ("binds all interfaces" in caplog.text) == warns
    finally:
        eng.close()
