"""The port's store tier (``kvstore/``, ``federation/``, the offload's
store leg) against the JAX package's, on the CPU.

* The masters: the same call sequence (registrations, puts, a rejected
  second copy, locates, heartbeats carrying the evictions past the
  watermark, removals, an owner's shutdown, an unknown segment) gets the
  same JSON from both apps, and a snapshot of either restores the same
  metadata into either.
* The clients across packages: the port's client against JAX's master and
  JAX's client against the port's master, each pulling the other's
  objects.
* The page wire: ``encode_page`` gives JAX's bytes for f32, int8 and bf16
  pages (numpy, ``ml_dtypes`` and torch forms); a two-byte void page
  decodes as bf16 bits.
* Engines (tiny, f32, the port's on the JAX engine's parameters): a JAX
  engine publishes and a port engine fetches the pages byte for byte, and
  the other way round; streams equal, ``recompute_avoided_tokens`` equals
  the restored pages times the page size, the counters agree, ``/metrics``
  renders them as JAX's page does. ``kv.pull.drop`` and
  ``kvstore.get.timeout`` degrade to recompute in both packages with the
  same streams and counters. An unknown publish policy is refused where
  JAX refuses it.
* bf16 (ROADMAP.md queue 3 caveat 7): JAX's own engine cannot restore the
  bf16 page its federation hands back (a ``|V2`` array: numpy has no cast
  for it); the port restores JAX's bf16 pages bit for bit.

Every wait has a deadline. About 20 s serial.
"""

import asyncio
import json
import threading
import time
import urllib.request

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestServer

import llmd_tpu.config as jcfg
from llmd_tpu import faults as jfaults
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine import SamplingParams as JaxSP
from llmd_tpu.federation import wire as jwire
from llmd_tpu.kvstore.client import CrossSliceStoreClient as JaxClient
from llmd_tpu.kvstore.master import MasterState as JaxMasterState
from llmd_tpu.kvstore.master import build_app as jax_build_app
from llmd_tpu.serve.metrics import render_metrics as jax_render
import llmd_tpu_torch.config as tcfg
from llmd_tpu_torch import faults as tfaults
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.engine.kv_cache import page_hashes_for_tokens
from llmd_tpu_torch.engine.runner import pages_to_numpy
from llmd_tpu_torch.federation import wire as twire
from llmd_tpu_torch.kvstore import CrossSliceStoreClient, MasterState, build_app
from llmd_tpu_torch.kvtransfer import shipper
from llmd_tpu_torch.models.llama import params_from_jax
from llmd_tpu_torch.serve.metrics import render_metrics

from test_torch_spec import jax_compile_cache, one_thread  # noqa: F401 (module fixtures)

DEADLINE_S = 10.0


class Master:
    """A master app (either package's) on an event loop of its own, so the
    synchronous clients can call it."""

    def __init__(self, state, app_fn) -> None:
        self.state = state
        self.loop = asyncio.new_event_loop()
        self.url = None
        started = threading.Event()

        def run() -> None:
            asyncio.set_event_loop(self.loop)

            async def start():
                self.server = TestServer(app_fn(state))
                await self.server.start_server()
                self.url = f"http://{self.server.host}:{self.server.port}"
                started.set()

            self.loop.run_until_complete(start())
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(DEADLINE_S), "the master did not start"

    def on_loop(self, fn):
        """Run ``fn`` on the master's loop (the one thread that changes its
        state) and return what it returns."""
        async def call():
            return fn()

        return asyncio.run_coroutine_threadsafe(call(), self.loop).result(DEADLINE_S)

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(self.server.close(), self.loop).result(DEADLINE_S)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=DEADLINE_S)


MASTERS = {"jax": (JaxMasterState, jax_build_app), "port": (MasterState, build_app)}
CLIENTS = {"jax": JaxClient, "port": CrossSliceStoreClient}


def wait_until(cond, what: str) -> None:
    end = time.monotonic() + DEADLINE_S
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


# --------------------------------------------------------------------- #
# the masters


def call(url: str, path: str, body=None, method: str = "POST"):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=DEADLINE_S) as r:
        raw = r.read()
    return raw.decode() if path == "/metrics" else json.loads(raw)


def master_sequence(url: str) -> list:
    """One fixed call sequence; every reply."""
    out = []
    seg = [("s1", "h1:1", 1000), ("s2", "h2:2", 1000)]
    for sid, addr, cap in seg:
        out.append(call(url, "/v1/segments/register",
                        {"segment_id": sid, "address": addr, "capacity_bytes": cap}))
    for i in range(12):  # 1,200 bytes into 2,000: past the 0.95 watermark at 19
        out.append(call(url, "/v1/objects/put",
                        {"segment_id": seg[i % 2][0], "key": f"k{i}", "nbytes": 160}))
    out.append(call(url, "/v1/objects/put", {"segment_id": "s2", "key": "k0", "nbytes": 160}))
    out.append(call(url, "/v1/objects/put", {"segment_id": "s1", "key": "k0", "nbytes": 170}))
    out.append(call(url, "/v1/objects/put", {"segment_id": "nobody", "key": "z", "nbytes": 1}))
    out.append(call(url, "/v1/objects/locate", {"keys": ["k1", "k3", "missing", "k0"]}))
    for sid, *_ in seg:
        out.append(call(url, "/v1/segments/heartbeat", {"segment_id": sid}))
    out.append(call(url, "/v1/segments/heartbeat", {"segment_id": "gone"}))
    out.append(call(url, "/v1/objects/remove", {"segment_id": "s2", "keys": ["k3", "k4"]}))
    out.append(call(url, "/v1/objects/locate", {"keys": [f"k{i}" for i in range(12)]}))
    out.append(call(url, "/healthz", method="GET"))
    out.append(call(url, "/metrics", method="GET"))
    out.append(call(url, "/v1/segments/s1", method="DELETE"))
    out.append(call(url, "/healthz", method="GET"))
    return out


def test_masters_answer_alike(tmp_path):
    """Both masters on a small pool (watermark 0.95, evict 30% a pass, no
    read lease) answer the sequence alike, and their snapshots restore the
    same metadata into either master."""
    replies, snaps = {}, {}
    for name, (State, app_fn) in MASTERS.items():
        path = tmp_path / f"{name}.json"
        m = Master(State(eviction_ratio=0.3, default_kv_lease_ttl_ms=0, snapshot_path=str(path)),
                   app_fn)
        try:
            replies[name] = master_sequence(m.url)
            m.on_loop(m.state.snapshot)
            snaps[name] = path.read_text()
        finally:
            m.close()
    assert replies["port"] == replies["jax"]
    puts = [r["accepted"] for r in replies["port"] if isinstance(r, dict) and "accepted" in r]
    assert puts == [True] * 13 + [False, False]  # the second copy, the unknown segment
    assert any(r.get("evict") for r in replies["port"] if isinstance(r, dict))
    assert snaps["port"] == snaps["jax"]
    restored = {}
    for src in MASTERS:
        for dst, (State, _) in MASTERS.items():
            st = State(snapshot_path=str(tmp_path / f"{src}.json"))
            restored[(src, dst)] = (st.stats(), sorted(st.objects), sorted(st.segments))
    assert len(set(map(repr, restored.values()))) == 1
    assert restored[("port", "port")][1]


@pytest.mark.parametrize("pair", [("port", "jax"), ("jax", "port")],
                         ids=["port-client-jax-master", "jax-client-port-master"])
def test_clients_across_packages(pair):
    """A client of one package on the other's master, beside a client of
    its own package: puts, a rejected second copy, reads each way (one
    and batched), a miss, the withdrawal of a segment's objects, and an
    owner's shutdown."""
    client_pkg, master_pkg = pair
    State, app_fn = MASTERS[master_pkg]
    m = Master(State(), app_fn)
    a = CLIENTS[client_pkg](m.url, segment_bytes=1 << 20, heartbeat_s=0.2)
    b = CLIENTS[master_pkg](m.url, segment_bytes=1 << 20, heartbeat_s=0.2)
    try:
        assert a.put("obj1", b"from a" * 50) and b.put("obj2", b"from b")
        assert not b.put("obj1", b"from a" * 50)  # the first copy wins
        assert b.get("obj1") == b"from a" * 50 and a.get("obj2") == b"from b"
        assert a.get_many(["obj1", "obj2", "missing"]) == {"obj1": b"from a" * 50,
                                                            "obj2": b"from b"}
        assert a.get("missing") is None
        a_stats = a.stats()
        assert (a_stats["pulls"], a_stats["misses"], a_stats["puts"]) == (3, 2, 1)
        a.clear_local()
        assert b.get("obj1") is None and m.state.stats()["objects"] == 1
        a.close()
        wait_until(lambda: len(m.state.segments) == 1, "a's segment to go")
    finally:
        a.close()
        b.close()
        m.close()


# --------------------------------------------------------------------- #
# the page wire


@pytest.mark.parametrize("kind", ["float32", "int8", "bfloat16"])
def test_pages_are_jax_bytes(kind):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, 4, 16)).astype(np.float32)
    page = {"float32": x, "int8": (x * 40).astype(np.int8),
            "bfloat16": x.astype(ml_dtypes.bfloat16)}[kind]
    blob = jwire.encode_page(page)
    assert twire.encode_page(page) == blob
    if kind == "bfloat16":
        t = torch.from_numpy(page.view(np.int16)).view(torch.bfloat16)
        assert twire.encode_page(t) == blob
        back = twire.decode_page(blob, torch.bfloat16)
        assert back.dtype == torch.bfloat16 and torch.equal(back, t)
        assert np.array_equal(twire.decode_page(blob), page.view(np.uint16))
        assert jwire.decode_page(blob).dtype.str == "|V2"  # JAX's reading (caveat 7)
    else:
        assert twire.encode_page(torch.from_numpy(page)) == blob
        assert np.array_equal(twire.decode_page(blob), page)
        assert torch.equal(twire.decode_page(blob, torch.float32), torch.from_numpy(page).float())
    for bad in (blob[:5], b"XXXX" + blob[4:], blob[:-1] + bytes([blob[-1] ^ 1])):
        with pytest.raises(twire.PageDecodeError):
            twire.decode_page(bad)


# --------------------------------------------------------------------- #
# engines on one store


PAGE = 4
PROMPTS = {"jax": list(range(1, 33)), "port": list(range(40, 72))}  # 8 full pages each
SP = dict(temperature=0.0, max_tokens=4, ignore_eos=True)


def engine_pair(url: str, policy: str, dtype: str = "float32", params=None):
    """A JAX engine and a port engine (on the JAX engine's parameters) with
    a host tier on the store."""
    def cfg(mod):
        return mod.EngineConfig(
            model=mod.tiny_model_config(dtype=dtype),
            cache=mod.CacheConfig(page_size=PAGE, num_blocks=64, dtype=dtype),
            scheduler=mod.SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=64),
            offload=mod.OffloadConfig(cpu_chunks=256, store_master_url=url,
                                      store_segment_bytes=1 << 22, store_data_port=0,
                                      publish_policy=policy))

    j = JaxEngine(cfg(jcfg))
    if params is None:
        params = params_from_jax(jax.tree.map(np.asarray, j.runner.params))
    return j, LLMEngine(cfg(tcfg), params=params, device="cpu"), params


@pytest.fixture(scope="module")
def fleet():
    """One master; a publishing (``save``) and a fetching (``off``) engine
    of each package."""
    m = Master(MasterState(), build_app)
    pub_j, pub_t, params = engine_pair(m.url, "save")
    get_j, get_t, _ = engine_pair(m.url, "off", params=params)
    yield m, {"jax": pub_j, "port": pub_t}, {"jax": get_j, "port": get_t}
    for e in (pub_j, pub_t, get_j, get_t):
        e.close()
    m.close()


def gen(eng, prompt) -> list[int]:
    SPc = JaxSP if isinstance(eng, JaxEngine) else SamplingParams
    return next(iter(eng.generate([list(prompt)], SPc(**SP)).values()))


def forget(eng) -> None:
    """Drop a fetching engine's device and host tiers."""
    eng._host_cache.clear()
    eng.allocator.clear()


def counters(eng) -> dict:
    eng._refresh_gauges()
    return {k: getattr(eng.stats, k) for k in (
        "kvstore_pulls", "kvstore_pull_failures", "kvstore_misses", "kv_federation_published",
        "kv_federation_hits", "recompute_avoided_tokens", "offload_restores")}


def host_page_np(eng, h) -> np.ndarray:
    page = eng._host_cache._pages[h]
    return pages_to_numpy(page) if isinstance(page, torch.Tensor) else np.asarray(page)


@pytest.mark.parametrize("publisher", ["jax", "port"], ids=["jax-publishes", "port-publishes"])
def test_a_fetch_across_packages_is_byte_identical(fleet, publisher):
    """One package's engine serves a prompt and publishes its pages; the
    other's fetching engine, whose tiers hold nothing, serves the same
    prompt from the store: the same stream, every full page pulled once,
    its bytes the published ones, the avoided tokens the restored pages
    times the page size; the fetching engines of both packages count
    alike and render the series alike."""
    m, pubs, gets = fleet
    prompt = PROMPTS[publisher]
    fetcher = gets["port" if publisher == "jax" else "jax"]
    want = gen(pubs[publisher], prompt)
    pubs[publisher]._kvstore_client.flush_publishes(DEADLINE_S)
    hashes = page_hashes_for_tokens(prompt, PAGE)
    keys = [h.hex() for h in hashes]
    assert set(keys) <= set(pubs[publisher]._kvstore_client._local_keys)
    got = {}
    for name, eng in gets.items():
        forget(eng)
        before = counters(eng)
        assert gen(eng, prompt) == want
        after = counters(eng)
        got[name] = {k: after[k] - before[k] for k in after}
    assert got["port"] == got["jax"]
    n = len(hashes)
    assert got["port"]["kvstore_pulls"] == got["port"]["kv_federation_hits"] == n
    assert got["port"]["recompute_avoided_tokens"] == n * PAGE
    port = pubs[publisher]._kvstore_client.server.port
    for h in hashes:
        blob = bytes(shipper.pull("127.0.0.1", port, h.hex()))
        assert np.array_equal(host_page_np(fetcher, h), jwire.decode_page(blob))
    # The publisher's accepted publications on both pages.
    assert counters(pubs[publisher])["kv_federation_published"] >= n
    mine = [ln for ln in render_metrics(gets["port"].stats, "tiny").splitlines()
            if "kvstore" in ln or "federation" in ln or "recompute_avoided" in ln]
    assert mine == [ln for ln in jax_render(gets["jax"].stats, "tiny").splitlines()
                    if "kvstore" in ln or "federation" in ln or "recompute_avoided" in ln]


FAULTS = {
    "kv.pull.drop": {"site": "kv.pull.drop", "match": "store|", "times": None},
    "kvstore.get.timeout": {"site": "kvstore.get.timeout", "match": "locate", "times": None},
}


@pytest.mark.parametrize("site", list(FAULTS))
def test_faults_degrade_to_recompute_like_jax(fleet, site):
    """With the site armed in each package, its fetching engine computes
    the published prompt: the publisher's stream, no store hit, nothing
    avoided, the same counters and injections in both packages."""
    m, pubs, gets = fleet
    prompt = PROMPTS["jax"]
    want = gen(pubs["jax"], prompt)
    pubs["jax"]._kvstore_client.flush_publishes(DEADLINE_S)
    got, injected = {}, {}
    for name, eng in gets.items():
        mod = jfaults if name == "jax" else tfaults
        forget(eng)
        before = counters(eng)
        mod.arm(mod.FaultPlan([mod.FaultSpec(**FAULTS[site])]))
        try:
            assert gen(eng, prompt) == want
            injected[name] = mod.injected_counts()
        finally:
            mod.disarm()
        after = counters(eng)
        got[name] = {k: after[k] - before[k] for k in after}
    assert got["port"] == got["jax"] and injected["port"] == injected["jax"]
    assert got["port"]["kv_federation_hits"] == got["port"]["recompute_avoided_tokens"] == 0
    assert injected["port"][site] >= 1
    if site == "kvstore.get.timeout":
        assert got["port"]["kvstore_misses"] == len(prompt) // PAGE


def test_fetched_pages_keep_the_host_pool_at_its_reserve(fleet):
    """A port engine whose host tier holds fewer pages than a prompt has
    fetches the prompt from the store, again and again: the host tier
    keeps its cap, every page it holds is a slot of the pool (a tensor
    from elsewhere is refused), the pool stays at its reserve, the pages
    in DRAM are the published bytes, and a fetched page, saved under the
    ``save`` policy, is not published again."""
    m, pubs, gets = fleet
    prompt = PROMPTS["port"]
    want = gen(pubs["port"], prompt)
    pubs["port"]._kvstore_client.flush_publishes(DEADLINE_S)
    params = params_from_jax(jax.tree.map(np.asarray, gets["jax"].runner.params))
    eng = LLMEngine(tcfg.EngineConfig(
        model=tcfg.tiny_model_config(),
        cache=tcfg.CacheConfig(page_size=PAGE, num_blocks=64, dtype="float32"),
        scheduler=tcfg.SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=64),
        offload=tcfg.OffloadConfig(cpu_chunks=3, store_master_url=m.url,
                                   store_segment_bytes=1 << 22, store_data_port=0,
                                   publish_policy="save")), params=params, device="cpu")
    try:
        pool, host = eng.offloader.pool, eng._host_cache
        free0, bytes0 = len(pool._free), pool.bytes
        n = len(prompt) // PAGE
        for rnd in range(3):
            forget(eng)
            assert gen(eng, prompt) == want
            assert counters(eng)["kv_federation_hits"] == (rnd + 1) * n
            assert len(host) == 3 and len(pool._free) == free0 - 3 and pool.bytes == bytes0
        slabs = {t.untyped_storage().data_ptr() for t in pool._slabs}
        port = pubs["port"]._kvstore_client.server.port
        for h, page in host._pages.items():
            assert page.untyped_storage().data_ptr() in slabs
            blob = bytes(shipper.pull("127.0.0.1", port, h.hex()))
            assert np.array_equal(pages_to_numpy(page), jwire.decode_page(blob))
        with pytest.raises(ValueError, match="not a slot of this pool"):
            pool.give(torch.zeros(pool.shape, dtype=pool.dtype))
        assert len(pool._free) == free0 - 3
        assert not eng._kvstore_client._local_keys
    finally:
        eng.close()


def test_unknown_publish_policy_is_refused_like_jax(fleet, monkeypatch):
    """Both engines refuse the policy where they build their federation;
    the port's closes the store client it had started (JAX's keeps its
    threads: the test closes it)."""
    import llmd_tpu.kvstore as jkvstore

    m, _, _ = fleet
    started = []

    class Client(JaxClient):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            started.append(self)

    monkeypatch.setattr(jkvstore, "CrossSliceStoreClient", Client)
    try:
        for mod, Engine, kw in ((tcfg, LLMEngine, {"device": "cpu"}), (jcfg, JaxEngine, {})):
            cfg = mod.EngineConfig(model=mod.tiny_model_config(), offload=mod.OffloadConfig(
                cpu_chunks=8, store_master_url=m.url, publish_policy="sometimes"))
            with pytest.raises(ValueError, match="unknown publish policy 'sometimes'"):
                Engine(cfg, **kw)
    finally:
        for c in started:
            c.close()
    assert len(started) == 1


def test_bf16_store_pages(tmp_path):
    """Caveat 7: a JAX bf16 engine's published page comes back to JAX's
    own engine as a ``|V2`` array, and its restore raises; the port's
    engine restores the same pages as bf16 bits, equal to JAX's host
    pages."""
    m = Master(MasterState(), build_app)
    pub, port, _ = engine_pair(m.url, "save", dtype="bfloat16")
    fetch_j = None
    try:
        prompt = PROMPTS["jax"]
        gen(pub, prompt)
        pub._kvstore_client.flush_publishes(DEADLINE_S)
        fetch_j = JaxEngine(jcfg.EngineConfig(
            model=jcfg.tiny_model_config(dtype="bfloat16"),
            cache=jcfg.CacheConfig(page_size=PAGE, num_blocks=64, dtype="bfloat16"),
            scheduler=jcfg.SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=64),
            offload=jcfg.OffloadConfig(cpu_chunks=256, store_master_url=m.url,
                                       store_segment_bytes=1 << 22, publish_policy="off")))
        with pytest.raises(ValueError, match="No cast function available"):
            fetch_j.add_request(prompt, JaxSP(**SP))
        assert fetch_j._federation.hits == len(prompt) // PAGE
        out = gen(port, prompt)
        assert len(out) == SP["max_tokens"]
        port._refresh_gauges()
        n = len(prompt) // PAGE
        assert port.stats.kv_federation_hits == n and port.stats.recompute_avoided_tokens == n * PAGE
        for h in page_hashes_for_tokens(prompt, PAGE):
            want = np.asarray(pub._host_cache._pages[h]).view(np.uint16)
            pid = port.allocator._cached[h]
            got = port.runner.kv_cache[:, pid]  # [L, K, page, 2D], bf16
            assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    finally:
        for e in (pub, port, fetch_j):
            if e is not None:
                e.close()
        m.close()
