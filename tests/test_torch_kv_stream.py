"""P/D engine pairs of the port against the JAX package's, on the CPU.

A port producer engine exports a finished prefill's KV and a port consumer
engine imports it (``EngineConfig.kv_role``): the consumer's greedy stream,
its cached tokens and the transfer counters (the connectors' and the
engines' ``kv_*`` stats) equal a JAX producer/consumer pair's on the same
parameters and prompt, on tiny, tiny-moe, tiny-mla, tiny-swa (4 layers)
under the sliding-window ring and tiny on the int8 pool (whose pool bytes
always ship in the q8 form), with the exact and the int8 wire (MLA: exact
only), 1 and 4 layer groups, and the in-process fast path on and off (each
package's pair takes its own fast path; off, both go over TCP). Across
packages, over TCP on the v3 wire: a JAX producer feeds a port consumer and
a port producer feeds a JAX consumer, each giving the JAX pair's stream; the
v2 pin's chunk framing feeds a JAX consumer too. Adaptive encoding picks as
JAX's picker does on the same rates, and an adaptive producer serves both
forms. A
streamed import parks its request until the stream resolves; an abort while
parked frees its pages. Failures degrade as in JAX: a producer gone
(recompute, or ``KVLoadError`` under 'fail'), ``kv.pull.drop`` and
``kv.bundle.corrupt`` (the CRC counter), each counted as JAX counts it.
Engines are built once for the module, and the JAX engines share XLA's
persistent compilation cache.
"""

import json
import threading
import time

import jax
import numpy as np
import pytest

import llmd_tpu.config as jcfg
import llmd_tpu_torch.config as tcfg
from llmd_tpu import faults as jfaults
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine import SamplingParams as JaxSP
from llmd_tpu.models.registry import get_model_config as jax_model_config
from llmd_tpu_torch import faults as tfaults
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.kvtransfer.connector import KVConnector, KVLoadError, layer_groups
from llmd_tpu_torch.models.llama import params_from_jax
from llmd_tpu_torch.models.registry import get_model_config

from test_torch_spec import jax_compile_cache, one_thread  # noqa: F401 (module fixtures)

SWA4 = dict(num_layers=4, layer_types=("sliding_attention", "full_attention") * 2)
# name: (registry name, overrides, the ring, the pool's dtype)
MODELS = {
    "tiny": ("tiny", {}, False, "float32"),
    "tiny-moe": ("tiny-moe", {}, False, "float32"),
    "tiny-mla": ("tiny-mla", {}, False, "float32"),
    "tiny-swa": ("tiny-swa", SWA4, True, "float32"),
    "tiny-int8-pool": ("tiny", {}, False, "int8"),
}
# (wire, layer groups, fast path) of each model's runs.
RUNS = {
    "tiny": [(w, g, f) for w in ("auto", "int8") for g in (1, 4) for f in (False, True)],
    "tiny-moe": [("auto", 4, False), ("auto", 4, True), ("int8", 1, False)],
    "tiny-mla": [("auto", 4, False), ("auto", 1, True), ("auto", 4, True)],
    "tiny-swa": [("auto", 4, False), ("auto", 4, True), ("int8", 4, False)],
    # An int8 pool ships its bytes in the q8 form whatever the wire asks.
    "tiny-int8-pool": [("auto", 4, False), ("auto", 1, False), ("auto", 4, True)],
}
CONSUMER_KEYS = ("imported_requests", "imported_bytes", "import_failures", "crc_failures",
                 "recompute_fallbacks", "local_imports", "stream_imports", "stream_groups_total",
                 "transfer_failures")
STAT_KEYS = ("kv_exported_requests", "kv_imported_requests", "kv_imported_bytes",
             "kv_import_failures", "kv_stream_groups_total", "kv_bundle_crc_failures_total",
             "kv_recompute_fallbacks_total")


def engine_kw(model: str, role, mod):
    name, over, ring, kv_dtype = MODELS[model]
    return dict(
        model=(jax_model_config if mod is jcfg else get_model_config)(name, **over),
        cache=mod.CacheConfig(page_size=4, num_blocks=96, dtype=kv_dtype, swa_ring=ring),
        scheduler=mod.SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=32),
        kv_role=role, kv_transfer_port=0, kv_local_fastpath=True)


class Pairs:
    """A model's JAX producer and consumer and the port's, the port's on
    the JAX parameters; each with the fast path, which a run turns off on
    its consumer."""

    def __init__(self, model: str) -> None:
        self.model = model
        self.jp, self.jc = (JaxEngine(jcfg.EngineConfig(**engine_kw(model, r, jcfg),
                                                        parallel=jcfg.ParallelConfig()))
                            for r in ("kv_producer", "kv_consumer"))
        self.params = params_from_jax(jax.tree.map(np.asarray, self.jp.runner.params))
        self.tp, self.tc = (self.port(r) for r in ("kv_producer", "kv_consumer"))
        self.n = 0

    def port(self, role, **kw):
        return LLMEngine(tcfg.EngineConfig(**{**engine_kw(self.model, role, tcfg), **kw}),
                         params=self.params, device="cpu")

    def prompt(self) -> list[int]:
        """A fresh prompt (no consumer holds its pages yet): 70 tokens,
        past tiny-swa's 64-token window."""
        self.n += 1
        rng = np.random.default_rng(1000 * self.n + len(self.model))
        return [int(t) for t in rng.integers(1, 250, size=70)]

    def close(self) -> None:
        for e in (self.jp, self.jc, self.tp, self.tc):
            e.close()


@pytest.fixture(scope="module")
def pairs():
    made = {}

    def get(model):
        if model not in made:
            made[model] = Pairs(model)
        return made[model]

    yield get
    for p in made.values():
        p.close()


def run(eng, SP, prompt, n, kvp=None):
    rid = eng.add_request(list(prompt), SP(temperature=0.0, max_tokens=n, ignore_eos=True),
                          kv_transfer_params=kvp)
    toks, final = [], None
    while eng.has_work():
        for out in eng.step():
            if out.request_id == rid:
                toks += out.new_token_ids
                final = out if out.finished else final
    return toks, final


def settle(conn) -> None:
    """Wait for a producer's staging threads to end (the consumer has
    pulled every cell, or claimed them)."""
    deadline = time.monotonic() + 10
    while conn._staging_active and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not conn._staging_active


def pd(producer, consumer, SP, prompt, wire, groups, fast, n=8):
    """One two-phase transfer: the producer's one-token prefill with
    ``do_remote_decode``, then the consumer's decode from its params.
    Returns the stream, the consumer's cached tokens, the params and the
    counters' moves."""
    pc, cc = producer.kv_connector, consumer.kv_connector
    pc.cfg.transfer_dtype, pc.cfg.stream_groups = wire, groups
    cc.cfg.local_fastpath = fast
    before = cc.stats()
    exported0 = pc.stats()["exported_bytes"]
    engines0 = [getattr(e.stats, k) for e in (producer, consumer) for k in STAT_KEYS]
    first, pre = run(producer, SP, prompt, 1, {"do_remote_decode": True})
    assert first == [0]  # eager-ACK: the prefill's token is not read back
    params = pre.kv_transfer_params
    toks, fin = run(consumer, SP, prompt, n, params)
    settle(pc)
    after = cc.stats()
    moved = {k: after[k] - before[k] for k in CONSUMER_KEYS if k != "transfer_failures"}
    moved["transfer_failures"] = {k: v - before["transfer_failures"].get(k, 0)
                                  for k, v in after["transfer_failures"].items()}
    moved["exported_bytes"] = pc.stats()["exported_bytes"] - exported0
    # The engines' kv_* series (refreshed each step) moved as the
    # connectors' counters did.
    moved["engine_stats"] = [getattr(e.stats, k) - v0 for (e, k), v0 in zip(
        [(e, k) for e in (producer, consumer) for k in STAT_KEYS], engines0)]
    return toks, fin.num_cached_tokens, params, moved


@pytest.mark.parametrize("model,wire,groups,fast",
                         [(m, *r) for m, runs in RUNS.items() for r in runs])
def test_port_pair_is_the_jax_pair(pairs, model, wire, groups, fast):
    p = pairs(model)
    prompt = p.prompt()
    want, want_cached, jparams, jmoved = pd(p.jp, p.jc, JaxSP, prompt, wire, groups, fast)
    got, cached, params, moved = pd(p.tp, p.tc, SamplingParams, prompt, wire, groups, fast)
    assert got == want and cached == want_cached
    assert {k: v for k, v in params.items() if k not in ("remote_key", "remote_port")} == {
        k: v for k, v in jparams.items() if k not in ("remote_key", "remote_port")}
    plan = layer_groups(p.tp.kv_connector._pool_layers, groups)
    assert params.get("num_groups", 1) == len(plan) and (len(plan) > 1) == (groups > 1)
    if fast:
        # JAX's staging thread may register cells before its claim lands
        # (it marks itself active late); the port's never does.
        jmoved.pop("exported_bytes")
        assert moved.pop("exported_bytes") == 0
    assert moved == jmoved
    assert moved["imported_requests"] == 1 and moved["import_failures"] == 0
    assert moved["local_imports"] == int(fast)
    assert p.tc.allocator.num_free_pages == p.jc.allocator.num_free_pages
    assert p.tp.kv_connector.server.registered_count == 0 or not fast


def test_staging_downloads_into_its_reserved_slots(pairs):
    """The producer's staging threads download every cell (exact and q8,
    one group and four) and the ring's section into the pinned slots
    reserved when the connector starts, and give each back once the
    shipper holds its copy: after the transfers every slot is free and
    the pool never grew."""
    for model in ("tiny", "tiny-swa"):
        p = pairs(model)
        pool = p.tp.kv_connector._staging
        for wire, groups in (("auto", 1), ("int8", 4), ("auto", 4)):
            got, *_ = pd(p.tp, p.tc, SamplingParams, p.prompt(), wire, groups, False)
            assert len(got) == 8
        assert len(pool._slabs) == 1 and len(pool._free) == KVConnector.STAGING_SLOTS


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_the_packages_feed_each_other_over_the_v3_wire(pairs, direction):
    """A JAX producer feeds a port consumer and a port producer a JAX
    consumer, over TCP (JAX's in-process registry does not see the
    port's connectors): the JAX-only pair's stream and cached tokens."""
    p = pairs("tiny")
    prompt = p.prompt()
    want, want_cached, jparams, _ = pd(p.jp, p.jc, JaxSP, prompt, "auto", 4, False)
    prompt2 = list(prompt)  # the second consumer has not seen it
    if direction == "jax-to-port":
        producer, consumer, SPp, SPc = p.jp, p.tc, JaxSP, SamplingParams
    else:
        producer, consumer, SPp, SPc = p.tp, p.jc, SamplingParams, JaxSP
    producer.kv_connector.cfg.transfer_dtype = "auto"
    producer.kv_connector.cfg.stream_groups = 4
    consumer.kv_connector.cfg.local_fastpath = True  # no in-process producer of its package
    _, pre = run(producer, SPp, prompt2, 1, {"do_remote_decode": True})
    assert pre.kv_transfer_params["num_groups"] == 2
    imported = consumer.kv_connector.imported_requests
    got, fin = run(consumer, SPc, prompt2, 8, pre.kv_transfer_params)
    assert got == want and fin.num_cached_tokens == want_cached
    assert consumer.kv_connector.imported_requests == imported + 1
    settle(producer.kv_connector)


def test_the_v2_pin_restores_the_chunk_framing(pairs, monkeypatch):
    """``LLMD_KV_STREAM_COMPAT_V2`` (read as JAX reads it): a producer
    exports in the v2 chunk framing (no layer groups), which both
    packages' consumers import as before."""
    from llmd_tpu_torch.kvtransfer import connector as tconn

    p = pairs("tiny")
    monkeypatch.setattr(tconn, "_COMPAT_V2", True)
    prompt = p.prompt()
    p.tp.kv_connector.cfg.stream_groups = 4
    p.tp.kv_connector.cfg.transfer_dtype = "auto"
    _, pre = run(p.tp, SamplingParams, prompt, 1, {"do_remote_decode": True})
    assert "num_groups" not in pre.kv_transfer_params
    want, _ = run(p.port(None), SamplingParams, prompt, 8)
    p.jc.kv_connector.cfg.local_fastpath = False
    got, fin = run(p.jc, JaxSP, prompt, 8, pre.kv_transfer_params)
    assert got == want and fin.num_cached_tokens == 68
    settle(p.tp.kv_connector)


def test_mla_refuses_the_int8_wire_and_downgrades_adaptive(pairs):
    p = pairs("tiny-mla")
    with pytest.raises(ValueError, match="not supported for MLA"):
        p.port("kv_producer", kv_transfer_dtype="int8")
    eng = p.port("kv_producer", kv_transfer_dtype="adaptive")
    assert eng.kv_connector.cfg.transfer_dtype == "auto"
    eng.close()
    with pytest.raises(ValueError, match="enable_prefix_caching"):
        LLMEngine(tcfg.EngineConfig(
            model=get_model_config("tiny"), kv_role="kv_consumer", kv_transfer_port=0,
            cache=tcfg.CacheConfig(page_size=4, num_blocks=16, dtype="float32",
                                   enable_prefix_caching=False)), device="cpu")


def test_adaptive_picks_as_jax_picks():
    """``transfer_dtype='adaptive'``: the same observed staging rates give
    the same encoding picks as JAX's picker (cold alternation, the faster
    form, every 8th export probing the other, the rates' EWMA)."""
    from llmd_tpu.kvtransfer.connector import TPUConnector as JaxConnector
    from llmd_tpu_torch.kvtransfer.connector import KVConnector

    picks = []
    for cls in (JaxConnector, KVConnector):
        conn = cls.__new__(cls)
        conn._local_lock = threading.Lock()
        conn._enc_rate = {"exact": None, "q8": None}
        conn._adaptive_exports = 0
        seq = [conn._adaptive_pick_q8() for _ in range(4)]
        for q8, nbytes, dt in ((False, 100 << 20, 1.0), (True, 100 << 20, 2.0)):
            conn._observe_encoding(q8, nbytes, dt)
        seq += [conn._adaptive_pick_q8() for _ in range(9)]
        for _ in range(12):
            conn._observe_encoding(False, 10 << 20, 4.0)
            conn._observe_encoding(True, 10 << 20, 1.0)
        seq += [conn._adaptive_pick_q8() for _ in range(9)]
        picks.append((seq, dict(conn._enc_rate)))
    assert picks[0] == picks[1]
    assert True in picks[1][0][:4] and False in picks[1][0][:4]


def test_an_adaptive_producer_serves_both_encodings(pairs):
    """An adaptive export decides per cell on its staging thread; the
    consumer imports either form, and both rates get measured."""
    p = pairs("tiny")
    producer = p.port("kv_producer", kv_transfer_dtype="adaptive", kv_local_fastpath=False)
    conn = p.tc.kv_connector
    conn.cfg.local_fastpath = False
    imported = conn.imported_requests
    try:
        for _ in range(3):
            prompt = p.prompt()
            _, pre = run(producer, SamplingParams, prompt, 1, {"do_remote_decode": True})
            toks, _ = run(p.tc, SamplingParams, prompt, 4, pre.kv_transfer_params)
            assert len(toks) == 4
        settle(producer.kv_connector)
        st = producer.kv_connector.stats()
        assert st["enc_rate_exact_mbps"] > 0 and st["enc_rate_q8_mbps"] > 0
        assert conn.imported_requests == imported + 3 and conn.import_failures == 0
    finally:
        producer.close()


def test_a_producer_runs_its_steps_synchronously(pairs):
    p = pairs("tiny")
    eng = p.port("kv_producer", scheduler=tcfg.SchedulerConfig(
        max_num_seqs=4, max_num_batched_tokens=32, async_scheduling=True))
    assert not eng._async
    eng.close()


# --------------------------------------------------------------------- #
# the streamed import's admission seam


def test_a_streamed_import_parks_then_admits(pairs):
    p = pairs("tiny")
    prompt = p.prompt()
    want, _ = run(p.port(None), SamplingParams, prompt, 8)
    p.tp.kv_connector.cfg.stream_groups = 4
    _, pre = run(p.tp, SamplingParams, prompt, 1, {"do_remote_decode": True})
    params = pre.kv_transfer_params
    conn = p.tc.kv_connector
    conn.cfg.local_fastpath = False
    assert conn.streaming_import(params)
    handle = conn.make_stream_handle(params)
    gate = threading.Event()

    def fetch():
        gate.wait(10)
        conn.fetch_remote_policy(list(prompt), params, handle)

    t = threading.Thread(target=fetch, daemon=True)
    t.start()
    rid = p.tc.add_request(list(prompt), SamplingParams(temperature=0.0, max_tokens=8,
                                                         ignore_eos=True),
                           kv_transfer_params={**params, "__stream__": handle})
    assert p.tc.has_work() and not p.tc.scheduler.has_work()
    assert p.tc.step() == []  # parked: nothing to schedule
    streams = conn.stream_imports
    gate.set()
    toks, fin = [], None
    while p.tc.has_work():
        for out in p.tc.step():
            if out.request_id == rid:
                toks += out.new_token_ids
                fin = out if out.finished else fin
    t.join(10)
    assert toks == want and fin.num_cached_tokens == 68
    assert conn.stream_imports == streams + 1
    settle(p.tp.kv_connector)


def test_an_abort_while_parked_frees_the_stream_pages(pairs):
    p = pairs("tiny")
    prompt = p.prompt()
    p.tp.kv_connector.cfg.stream_groups = 4
    _, pre = run(p.tp, SamplingParams, prompt, 1, {"do_remote_decode": True})
    params = pre.kv_transfer_params
    conn = p.tc.kv_connector
    conn.cfg.local_fastpath = False
    free = p.tc.allocator.num_free_pages
    handle = conn.make_stream_handle(params)
    gate = threading.Event()

    def fetch():
        gate.wait(10)
        conn.fetch_remote_policy(list(prompt), params, handle)

    t = threading.Thread(target=fetch, daemon=True)
    t.start()
    rid = p.tc.add_request(list(prompt), SamplingParams(temperature=0.0, max_tokens=8),
                           kv_transfer_params={**params, "__stream__": handle})
    assert p.tc.abort_request(rid) and not p.tc.has_work()
    gate.set()  # the fetch lands after the abort
    t.join(10)
    assert handle.done.wait(10)
    assert p.tc.allocator.num_free_pages == free
    settle(p.tp.kv_connector)


# --------------------------------------------------------------------- #
# failures


def test_a_producer_gone_recomputes_or_fails(pairs):
    p = pairs("tiny")
    prompt = p.prompt()
    producer = p.port("kv_producer")
    _, pre = run(producer, SamplingParams, prompt, 1, {"do_remote_decode": True})
    settle(producer.kv_connector)
    producer.close()  # its shipper is gone
    conn = p.tc.kv_connector
    conn.cfg.local_fastpath = False
    before = conn.stats()
    agg = p.port(None)
    want, _ = run(agg, SamplingParams, prompt, 8)
    got, fin = run(p.tc, SamplingParams, prompt, 8, pre.kv_transfer_params)
    assert got == want and fin.num_cached_tokens == 0
    after = conn.stats()
    assert after["import_failures"] - before["import_failures"] == 1
    assert after["recompute_fallbacks"] - before["recompute_fallbacks"] == 1
    assert (after["transfer_failures"][("fetch", "recompute")]
            - before["transfer_failures"].get(("fetch", "recompute"), 0)) == 1
    strict = p.port("kv_consumer", kv_load_failure_policy="fail", kv_local_fastpath=False)
    with pytest.raises(KVLoadError):
        strict.add_request(list(prompt), SamplingParams(max_tokens=4),
                           kv_transfer_params=pre.kv_transfer_params)
    assert strict.kv_connector.stats()["transfer_failures"] == {("fetch", "fail"): 1}
    strict.close()


@pytest.mark.parametrize("site,crc", [("kv.pull.drop", 0), ("kv.bundle.corrupt", 1)])
def test_injected_pull_faults_degrade_as_in_jax(pairs, site, crc):
    """Each package's fault site on its own consumer's pull: the request
    recomputes, and the counters move alike (a corrupted bundle also
    counts a CRC failure)."""
    p = pairs("tiny")
    plan = {"faults": [{"site": site, "match": ":g1:c1"}]}
    moved = []
    for producer, consumer, SP, faults in ((p.jp, p.jc, JaxSP, jfaults),
                                           (p.tp, p.tc, SamplingParams, tfaults)):
        faults.arm(faults.FaultPlan.from_json(json.dumps(plan)))
        try:
            toks, cached, _, m = pd(producer, consumer, SP, PROMPTS[site], "auto", 4, False)
        finally:
            faults.disarm()
        moved.append((toks, cached, m))
    assert moved[0] == moved[1]
    toks, cached, m = moved[1]
    assert cached == 0 and m["import_failures"] == 1 and m["crc_failures"] == crc
    assert m["recompute_fallbacks"] == 1 and m["imported_requests"] == 0


PROMPTS = {site: [int(t) for t in np.random.default_rng(77 + i).integers(1, 250, size=70)]
           for i, site in enumerate(("kv.pull.drop", "kv.bundle.corrupt"))}
