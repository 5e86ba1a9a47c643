"""LoRA adapters and the paged adapter pool (``models/llama.py``'s slots,
``ModelRunner.set_lora_weights``, ``lora/``, the engine's loading queue and
the server's adapter ids and load routes) of the port against the JAX
package's, on the CPU.

The contract of ``tests/test_lora.py`` and ``tests/test_lora_pool.py``: a
row's adapter slot picks its q and v deltas, slot 0 and an adapter whose B
is zero are the base model, one batch mixes adapters, an adapter's pages
never serve another adapter or the base model, and a paged pool evicts
only idle adapters, cold-loads at a step boundary and gives the same
streams resident or cold. Here: one forward with mixed slots on the flat
and the bucketed layouts equals JAX's (dense, biased and a tiny gpt-oss
config); engines with mixed adapters give JAX's streams in every layout
and on int8 weights; page hashes, salted and not, equal JAX's byte for
byte; the ``LORA1`` frame and the PEFT loader equal JAX's; the pool's
evictions, cold loads and failed loads equal JAX's on the same calls; and
the servers answer the same adapter requests, load and unload routes and
metric lines. JAX engines share XLA's persistent compilation cache.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import llmd_tpu.config as jcfg
import llmd_tpu.engine.kv_cache as jkv
import llmd_tpu.lora as jlora
import llmd_tpu.lora.source as jsource
import llmd_tpu.models.loader as jloader
import llmd_tpu.serve.api as japi
import llmd_tpu_torch.config as tcfg
import llmd_tpu_torch.engine.kv_cache as tkv
import llmd_tpu_torch.lora as tlora
import llmd_tpu_torch.lora.source as tsource
import llmd_tpu_torch.models.loader as tloader
import llmd_tpu_torch.serve.api as tapi
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine import SamplingParams as JaxSP
from llmd_tpu.models import llama as jllama
from llmd_tpu.models.common import StepInput as JaxStepInput
from llmd_tpu.serve.__main__ import parse_lora_adapters as jax_parse
from llmd_tpu.serve.async_engine import AsyncEngine as JaxAsyncEngine
from llmd_tpu.serve.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.models import llama
from llmd_tpu_torch.models.common import StepInput
from llmd_tpu_torch.serve.__main__ import parse_lora_adapters
from llmd_tpu_torch.serve.async_engine import AsyncEngine
from llmd_tpu_torch.serve.tokenizer import ByteTokenizer

from test_torch_kv_events import Recorder
from test_torch_model import NUM_PAGES, PAGE, ROWS, TINY_OSS, randomise, step
from test_torch_spec import jax_compile_cache, one_thread  # noqa: F401 (module fixtures)

FACTORS = ("la_q", "lb_q", "la_v", "lb_v")
ADAPTERS = 3
FORWARD_CASES = {"dense": {}, "attention_bias": {"attention_bias": True}, "gpt-oss": TINY_OSS}


@pytest.fixture
def anyio_backend():
    return "asyncio"


def lora_tree(case):
    """A JAX tree with LoRA slots, every factor of slots 1.. drawn (slot 0
    stays zero) and the biases and norms randomised."""
    cfg = jcfg.tiny_model_config(**FORWARD_CASES[case], num_lora_adapters=ADAPTERS, lora_rank=4)
    params = randomise(jllama.init_params(cfg, jax.random.key(0)))
    rng = np.random.default_rng(5)
    layers = dict(params["layers"])
    for name in FACTORS:
        v = 0.3 * rng.normal(size=layers[name].shape)
        v[:, 0] = 0.0
        layers[name] = jnp.asarray(v, jnp.float32)
    return cfg, jax.tree.map(np.asarray, {**params, "layers": layers})


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
@pytest.mark.parametrize("layout", ["flat", "bucketed"])
def test_forward_with_mixed_slots_matches_jax(case, layout):
    """Rows on slots 0, 1, 2 and 3 in one step: hidden states, logits and
    the pool equal JAX's (each row's delta on q and v after the bias)."""
    cfg, tree = lora_tree(case)
    tconfig = tcfg.tiny_model_config(**FORWARD_CASES[case], num_lora_adapters=ADAPTERS,
                                     lora_rank=4)
    rng = np.random.default_rng(2)
    s = step(rng, cfg)
    slots = np.arange(len(ROWS), dtype=np.int32) % (ADAPTERS + 1)
    pool = rng.normal(size=(cfg.num_layers, NUM_PAGES, cfg.num_kv_heads, PAGE,
                            2 * cfg.head_dim)).astype(np.float32)
    if layout == "flat":
        arrays = dict(token_ids=s["ids"][:, None], positions=s["positions"][:, None],
                      kv_lens=s["kv_lens"], page_table=s["page_table"])
        jextra = dict(query_lens=s["live"].astype(np.int32), token_rows=s["rows"],
                      lora_ids=slots[s["rows"]])
        textra = dict(token_rows=s["rows"], lora_ids=slots[s["rows"]],
                      num_live=np.asarray([s["total"]], np.int32))
        live = s["live"]
    else:
        Q = max(w for _, w in ROWS)
        ids = np.zeros((len(ROWS), Q), np.int32)
        pos = np.zeros((len(ROWS), Q), np.int32)
        for r, (p0, w) in enumerate(ROWS):
            ids[r, :w] = rng.integers(0, cfg.vocab_size, size=w)
            pos[r, :w] = np.arange(p0, p0 + w)
            pos[r, w:] = p0 + w - 1
        qlens = np.asarray([w for _, w in ROWS], np.int32)
        arrays = dict(token_ids=ids, positions=pos, kv_lens=pos[:, -1] + 1,
                      page_table=s["page_table"])
        jextra = dict(query_lens=qlens, lora_ids=slots)
        textra = dict(query_lens=qlens, lora_ids=slots)
        live = np.arange(Q)[None, :] < qlens[:, None]
    jinp = JaxStepInput(**{k: jnp.asarray(v) for k, v in {**arrays, **jextra}.items()})
    jparams = jax.tree.map(jnp.asarray, tree)
    jh, jpool = jllama.forward_hidden(jparams, jnp.asarray(pool), jinp, cfg)
    inp = StepInput(**{k: torch.from_numpy(np.asarray(v)) for k, v in {**arrays, **textra}.items()})
    params = llama.params_from_jax(tree)
    th, tpool = llama.forward_hidden(params, torch.from_numpy(pool.copy()), inp, tconfig)
    np.testing.assert_allclose(th.numpy()[live], np.asarray(jh)[live], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=1e-4, rtol=0)
    # The adapters matter: without the slots the hidden states differ.
    base, _ = llama.forward_hidden(params, torch.from_numpy(pool.copy()),
                                   StepInput(**{**inp.__dict__, "lora_ids": None}), tconfig)
    assert not torch.allclose(base[torch.from_numpy(live)], th[torch.from_numpy(live)], atol=1e-3)


# --------------------------------------------------------------------- #
# engines


LAYOUTS = {
    "flat": ({}, None),
    "bucketed": (dict(ragged_qlens=False), None),
    "split-window": (dict(unified_step=False, decode_window=4), None),
    "window": (dict(decode_window=4), None),
    "async": (dict(async_scheduling=True), None),
    "int8": ({}, "int8"),
}


def engine_config(pkg, slots=2, dynamic=False, blocks=128, quant=None, **sched):
    model = pkg.tiny_model_config(name="tiny-lora", num_lora_adapters=slots, lora_rank=4,
                                  lora_dynamic=dynamic, quantization=quant)
    return pkg.EngineConfig(
        model=model, cache=pkg.CacheConfig(page_size=4, num_blocks=blocks, dtype="float32"),
        scheduler=pkg.SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=64, **sched))


_PARAMS = {}


def pair(slots=2, dynamic=False, quant=None, **sched):
    """A JAX engine and the port's on its parameters (recording sinks)."""
    j = JaxEngine(engine_config(jcfg, slots, dynamic, quant=quant, **sched), event_sink=Recorder())
    key = (slots, quant)
    if key not in _PARAMS:
        _PARAMS[key] = jax.tree.map(np.asarray, j.runner.params)
    # A tree of its own: an install writes the slots in place.
    t = LLMEngine(engine_config(tcfg, slots, dynamic, quant=quant, **sched),
                  params=llama.params_from_jax(_PARAMS[key]), device="cpu", event_sink=Recorder())
    return j, t


def adapter(seed, L=2, scale=0.5, keys=FACTORS):
    """Slot-form factors of the tiny config (rank 4)."""
    shapes = {"la_q": (64, 4), "lb_q": (4, 64), "la_v": (64, 4), "lb_v": (4, 32)}
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0.0, scale, (L, *shapes[k])).astype(np.float32) for k in keys}


def drain(eng):
    out = {}
    for _ in range(500):
        if not eng.has_work():
            break
        for res in eng.step():
            out.setdefault(res.request_id, []).extend(res.new_token_ids)
    assert not eng.has_work()
    return out


def gen(eng, SP, lora_name="", lora_id=0, max_tokens=5, seed=None, prompt=None):
    sp = SP(temperature=0.0 if seed is None else 0.8, max_tokens=max_tokens, ignore_eos=True,
            seed=seed)
    rid = eng.add_request(prompt or list(range(1, 11)), sp, lora_id=lora_id, lora_name=lora_name)
    return drain(eng)[rid]


def mixed(eng, SP):
    """Base, slot 1 and slot 2 rows in one batch (greedy and seeded), then
    two prefix-sharing prompts on one adapter."""
    prompt = list(range(1, 11))
    rids = []
    for i, seed in ((0, None), (1, None), (2, None), (1, 7)):
        sp = SP(temperature=0.0 if seed is None else 0.8, max_tokens=6, ignore_eos=True, seed=seed)
        rids.append(eng.add_request(prompt, sp, lora_id=i, lora_name=f"ad{i}" if i else ""))
    out = drain(eng)
    streams = [out[r] for r in rids]
    streams.append(gen(eng, SP, "ad1", 1, prompt=list(range(1, 21))))
    streams.append(gen(eng, SP, "ad1", 1, prompt=list(range(1, 21))))
    return streams


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mixed_adapter_streams_equal_jax(layout):
    sched, quant = LAYOUTS[layout]
    j, t = pair(quant=quant, **sched)
    for s in (1, 2):
        w = adapter(1000 + s)
        j.set_lora_weights(s, w)
        t.set_lora_weights(s, w)
    jout, tout = mixed(j, JaxSP), mixed(t, SamplingParams)
    assert tout == jout
    assert tout[0] != tout[1] != tout[2] and tout[4] == tout[5]
    # The adapter's second prompt hit its own cached pages, under its salt.
    assert t.allocator.event_sink.events == j.allocator.event_sink.events
    t._refresh_gauges()
    assert t.stats.max_lora == 2


def test_zero_b_is_the_base_model_and_slot_writes_are_in_place():
    """Slots start as the base model (B zero), bit for bit; an install
    writes the slot's leaves in place (a captured graph reads the same
    tensors) and is refused while a row on the slot is in flight."""
    _, t = pair()
    base = gen(t, SamplingParams)
    assert gen(t, SamplingParams, "ad1", 1) == base
    leaves = {k: t.runner.params["layers"][k] for k in FACTORS}
    ptrs = {k: v.data_ptr() for k, v in leaves.items()}
    w = adapter(3)
    t.set_lora_weights(1, w)
    assert {k: t.runner.params["layers"][k].data_ptr() for k in FACTORS} == ptrs
    np.testing.assert_array_equal(t.runner.params["layers"]["lb_v"][:, 1].numpy(), w["lb_v"])
    assert gen(t, SamplingParams, "ad1", 1) != base
    t.add_request([1, 2, 3], SamplingParams(max_tokens=4), lora_id=1)
    t.step()
    with pytest.raises(RuntimeError, match="in flight"):
        t.set_lora_weights(1, w)
    with pytest.raises(ValueError, match="pair"):
        t.runner.set_lora_weights(2, {"lb_q": w["lb_q"]})
    with pytest.raises(ValueError):
        t.add_request([1, 2, 3], lora_id=5)
    with pytest.raises(ValueError, match="unknown lora_name 'typo'"):
        t.add_request([1, 2, 3], lora_name="typo")
    with pytest.raises(ValueError):
        tcfg.tiny_model_config(kv_lora_rank=32, num_lora_adapters=2)


@pytest.mark.parametrize("extra", [b"", b"lora:sql", b"lora-slot:2"])
def test_page_hashes_equal_jax(extra):
    rng = np.random.default_rng(4)
    tokens = [int(t) for t in rng.integers(0, 50000, size=37)]
    assert tkv.page_hashes_for_tokens(tokens, 8, extra) == jkv.page_hashes_for_tokens(tokens, 8, extra)
    assert tkv.hash_page(b"p", tokens[:8], extra) == jkv.hash_page(b"p", tokens[:8], extra)
    if extra:
        assert tkv.page_hashes_for_tokens(tokens, 8, extra) != tkv.page_hashes_for_tokens(tokens, 8)


def test_scheduler_salt_equals_jax():
    from llmd_tpu.engine.request import Request as JReq
    from llmd_tpu.engine.scheduler import EngineScheduler as JSched
    from llmd_tpu_torch.engine.request import Request as TReq
    from llmd_tpu_torch.engine.scheduler import EngineScheduler as TSched

    for lid, name in ((0, ""), (0, "x"), (2, ""), (2, "sql-adapter")):
        assert (TSched.hash_extra(TReq("r", [1], lora_id=lid, lora_name=name))
                == JSched._hash_extra(JReq("r", [1], lora_id=lid, lora_name=name)))


# --------------------------------------------------------------------- #
# frames, the registry and the PEFT loader


def test_lora1_frame_equals_jax(monkeypatch):
    """The frame is JAX's byte for byte (the zip's timestamps pinned), and
    each package decodes the other's; corruption is caught by the CRC."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    w = {"la_q": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
         "lb_q": np.zeros((2, 4, 3), np.float32)}
    blob = tsource.encode_adapter(w)
    assert blob == jsource.encode_adapter(w)
    assert blob == tsource.encode_adapter({k: torch.from_numpy(v) for k, v in w.items()})
    for dec in (tsource.decode_adapter, jsource.decode_adapter):
        np.testing.assert_array_equal(dec(blob)["la_q"], w["la_q"])
    assert tsource.weights_crc(w) == jsource.weights_crc(w)
    corrupt = bytearray(blob)
    corrupt[len(corrupt) // 2] ^= 0xFF
    for bad, match in ((bytes(corrupt), "CRC"), (b"NOPE!" + blob[5:], "magic"), (b"xx", "short")):
        with pytest.raises(tlora.AdapterDecodeError, match=match):
            tsource.decode_adapter(bad)


def test_registry_tombstones_equal_jax():
    w1 = {"la_q": np.ones((1, 2, 2), np.float32)}
    w2 = {"la_q": np.full((1, 2, 2), 2.0, np.float32)}
    results = []
    for reg in (tlora.AdapterRegistry(), jlora.AdapterRegistry()):
        log = [reg.register("a", w1)[1]]
        with pytest.raises(ValueError, match="already loaded"):
            reg.register("a", w2)
        reg.unregister("a")
        log.append(reg.register("a", w1)[1])
        reg.unregister("a")
        log.append(reg.register("a", w2)[1])
        log.append(reg.names())
        results.append(log)
    assert results[0] == results[1] == [False, False, True, ["a"]]


def write_peft(d, r=2, alpha=4.0, targets=("q_proj", "v_proj"), **extra):
    from safetensors.numpy import save_file

    d.mkdir(parents=True, exist_ok=True)
    (d / "adapter_config.json").write_text(json.dumps(
        {"r": r, "lora_alpha": alpha, "target_modules": list(targets), "bias": "none", **extra}))
    rng = np.random.default_rng(9)
    tensors = {}
    for layer in range(2):
        for proj, out in (("q_proj", 64), ("v_proj", 32)):
            if proj not in targets:
                continue
            pre = f"base_model.model.model.layers.{layer}.self_attn.{proj}"
            tensors[f"{pre}.lora_A.weight"] = rng.normal(size=(r, 64)).astype(np.float32)
            tensors[f"{pre}.lora_B.weight"] = rng.normal(size=(out, r)).astype(np.float32)
    save_file(tensors, str(d / "adapter_model.safetensors"))
    return str(d)


@pytest.mark.parametrize("kw", [{}, dict(use_rslora=True), dict(targets=("v_proj",))])
def test_peft_loader_equals_jax(tmp_path, kw):
    d = write_peft(tmp_path / "peft", **kw)
    jc = jcfg.tiny_model_config(num_lora_adapters=2, lora_rank=4)
    tc = tcfg.tiny_model_config(num_lora_adapters=2, lora_rank=4)
    jw, tw = jloader.load_lora_adapter(jc, d), tloader.load_lora_adapter(tc, d)
    assert jw.keys() == tw.keys()
    for k in jw:
        np.testing.assert_array_equal(tw[k].numpy(), np.asarray(jw[k]))


def test_peft_loader_refuses_what_slots_cannot_hold(tmp_path):
    tc = tcfg.tiny_model_config(num_lora_adapters=2, lora_rank=4)
    for i, (kw, match) in enumerate(((dict(targets=("q_proj", "k_proj")), "unsupported"),
                                     (dict(use_dora=True), "use_dora"),
                                     (dict(r=8), "raise --lora-rank"))):
        d = write_peft(tmp_path / f"p{i}", **kw)
        with pytest.raises(ValueError, match=match):
            tloader.load_lora_adapter(tc, d)
        with pytest.raises(ValueError, match=match):
            jloader.load_lora_adapter(jcfg.tiny_model_config(num_lora_adapters=2, lora_rank=4), d)


def test_parse_lora_adapters_equals_jax():
    for spec in ("a, b ,a", None, "sql=/adapters/sql, chat"):
        assert parse_lora_adapters(spec) == jax_parse(spec)
    with pytest.raises(ValueError, match="invalid adapter name"):
        parse_lora_adapters('bad"name')


# --------------------------------------------------------------------- #
# the paged adapter pool


def pool_churn(eng, SP):
    """Five tenants over two slots, twice (greedy and seeded), a pinned
    pair with a third tenant waiting, an unload and a reload."""
    log = []
    names = [f"ad{i}" for i in range(5)]
    for i, n in enumerate(names):
        eng.load_adapter(n, weights=adapter(100 + i))
    log.append({n: gen(eng, SP, n) for n in names})
    log.append({n: gen(eng, SP, n, seed=11) for n in reversed(names)})
    log.append(dict(eng.adapter_pool.counters()))
    long_sp = SP(temperature=0.0, max_tokens=12, ignore_eos=True)
    short_sp = SP(temperature=0.0, max_tokens=3, ignore_eos=True)
    ra = eng.add_request(list(range(1, 9)), long_sp, lora_name="ad0")
    rb = eng.add_request(list(range(1, 9)), short_sp, lora_name="ad1")
    eng.step()
    rc = eng.add_request(list(range(1, 9)), short_sp, lora_name="ad2")
    eng.step()
    eng._refresh_gauges()
    log.append((eng.adapter_pool.slot_of("ad2"), eng.stats.waiting_lora_adapters,
                eng.stats.running_lora_adapters))
    out = drain(eng)
    log.append([out.get(r) for r in (ra, rb, rc)])
    eng.unload_adapter("ad3")
    with pytest.raises(KeyError):
        eng.unload_adapter("ad3")
    eng.load_adapter("ad3", weights=adapter(103))
    log.append(gen(eng, SP, "ad3"))
    eng._refresh_gauges()
    st = eng.stats
    log.append((dict(eng.adapter_pool.counters()), st.lora_pool_resident_adapters,
                st.lora_pool_evictions_total, st.lora_cold_loads_total,
                st.resident_lora_adapters, st.available_lora_adapters))
    return log


def test_pool_churn_equals_jax():
    """Evictions, cold loads, residency, the labels and every stream equal
    JAX's on the same calls; each adapter's stream is its own, resident or
    cold-loaded."""
    j, t = pair(dynamic=True)
    jlog, tlog = pool_churn(j, JaxSP), pool_churn(t, SamplingParams)
    assert tlog == jlog
    counters = tlog[2]
    assert counters["evictions"] >= 1 and counters["cold_loads"] >= 1
    assert len({tuple(v) for v in tlog[0].values()}) == 5
    assert tlog[3][0] is None and tlog[3][1] == ("ad2",)


def test_load_failures_are_counted_as_jax_counts(tmp_path):
    """A missing source, a corrupt frame and an injected ``lora.load.fail``
    each fail the load and count, as in JAX; the registry is unchanged."""
    from llmd_tpu import faults as jfaults
    from llmd_tpu_torch import faults as tfaults

    good = tmp_path / "good.lora"
    good.write_bytes(tsource.encode_adapter(adapter(5)))
    bad = tmp_path / "bad.lora"
    bad.write_bytes(good.read_bytes()[:-9] + b"corrupted")
    plan = {"faults": [{"site": "lora.load.fail", "match": "flaky", "times": 2}]}
    logs = []
    for (eng, faults) in zip(pair(dynamic=True), (jfaults, tfaults)):
        log = []
        faults.arm(faults.FaultPlan.from_json(json.dumps(plan)))
        try:
            for name, src in (("ghost", str(tmp_path / "no")), ("bad", str(bad)),
                              ("flaky", str(good)), ("ok", str(good))):
                try:
                    eng.load_adapter(name, src)
                    log.append((name, "ok"))
                except Exception as e:
                    log.append((name, type(e).__name__))
        finally:
            faults.disarm()
        log.append((eng.stats.lora_load_failures_total, eng.adapter_registry.names()))
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][-1] == (3, ["ok"])


def test_concurrent_load_unload_beside_serving():
    _, t = pair(dynamic=True)
    t.load_adapter("stable", weights=adapter(50))
    errors = []

    def churn(idx):
        try:
            for i in range(4):
                name = f"t{idx}-{i}"
                t.load_adapter(name, weights=adapter(idx * 31 + i))
                t.unload_adapter(name)
        except Exception as e:  # re-raised on the main thread below
            errors.append(e)

    threads = [threading.Thread(target=churn, args=(i,)) for i in (1, 2)]
    for th in threads:
        th.start()
    streams = [gen(t, SamplingParams, "stable") for _ in range(3)]
    for th in threads:
        th.join(timeout=60)
    assert not errors and len({tuple(s) for s in streams}) == 1
    assert t.adapter_registry.names() == ["stable"]
    assert t.adapter_pool.counters()["resident"] <= 2


# --------------------------------------------------------------------- #
# the servers


async def serve_both(jeng, teng, **kw):
    clients = []
    for eng, api, A, Tok in ((jeng, japi, JaxAsyncEngine, JaxByteTokenizer),
                             (teng, tapi, AsyncEngine, ByteTokenizer)):
        c = TestClient(TestServer(api.build_app(A(eng), Tok(), "tiny-lora", 128, **kw)))
        await c.start_server()
        clients.append(c)
    return clients


def strip_ids(obj):
    if isinstance(obj, list):
        return [strip_ids(o) for o in obj]
    if isinstance(obj, dict):
        return {k: strip_ids(v) for k, v in obj.items()
                if k not in ("id", "created", "owned_by", "message")}
    return obj


@pytest.mark.anyio
async def test_fixed_adapters_served_as_model_ids_as_jax():
    j, t = pair()
    for s in (1, 2):
        j.set_lora_weights(s, adapter(1000 + s))
        t.set_lora_weights(s, adapter(1000 + s))
    clients = await serve_both(j, t, lora_adapters={"sql-adapter": 1, "chat-adapter": 2})
    try:
        answers = []
        for c in clients:
            got = [strip_ids(await (await c.get("/v1/models")).json())]
            for model in ("sql-adapter", "chat-adapter", "tiny-lora", "sql-typo"):
                r = await c.post("/v1/completions", json={"model": model, "prompt": "hello",
                                                          "max_tokens": 4})
                got.append((r.status, strip_ids(await r.json())))
            r = await c.post("/vllm.Generation/Generate", json={
                "model": "chat-adapter", "prompt_token_ids": [5, 6, 7],
                "sampling_params": {"max_tokens": 3, "temperature": 0.0}})
            got.append((r.status, (await r.json())["token_ids"]))
            text = await (await c.get("/metrics")).text()
            got.append([ln for ln in text.splitlines() if ln.startswith("vllm:lora_requests_info")])
            answers.append(got)
        assert answers[1] == answers[0]
        assert answers[1][4][0] == 404
    finally:
        for c in clients:
            await c.close()


@pytest.mark.anyio
async def test_load_and_unload_routes_as_jax(tmp_path):
    j, t = pair(dynamic=True)
    blob = tmp_path / "sql.lora"
    blob.write_bytes(tsource.encode_adapter(adapter(77)))
    clients = await serve_both(j, t)
    names = ("lora_requests_info", "lora_pool_resident_adapters", "lora_cold_loads_total",
             "lora_pool_evictions_total", "lora_load_failures_total")
    try:
        answers = []
        for c in clients:
            got = []
            for path, body in (
                ("/v1/load_lora_adapter", {"lora_name": "sql-adapter", "lora_path": str(blob)}),
                ("/v1/completions", {"model": "sql-adapter", "prompt": "hello", "max_tokens": 4}),
                ("/v1/completions", {"model": "sql-typo", "prompt": "x", "max_tokens": 2}),
                ("/v1/load_lora_adapter", {"lora_name": "sql-adapter", "lora_path": str(blob)}),
                ("/v1/load_lora_adapter", {"lora_name": "ghost", "lora_path": str(tmp_path / "n")}),
                ("/v1/load_lora_adapter", {"lora_name": 'bad"name', "lora_path": str(blob)}),
                ("/v1/load_lora_adapter", {"lora_name": "tiny-lora", "lora_path": str(blob)}),
                ("/v1/unload_lora_adapter", {"lora_name": "sql-adapter"}),
                ("/v1/unload_lora_adapter", {"lora_name": "sql-adapter"}),
            ):
                r = await c.post(path, json=body)
                got.append((r.status, strip_ids(await r.json()) if r.status == 200 else None))
                if path.endswith("load_lora_adapter") and len(got) == 1:
                    got.append(strip_ids(await (await c.get("/v1/models")).json()))
                    text = await (await c.get("/metrics")).text()
                    got.append(sorted(ln for ln in text.splitlines()
                                      if any(n in ln for n in names) and not ln.startswith("#")))
            text = await (await c.get("/metrics")).text()
            got.append(sorted(ln for ln in text.splitlines()
                              if any(n in ln for n in names) and not ln.startswith("#")))
            answers.append(got)
        assert answers[1] == answers[0]
        assert [a[0] for a in answers[1] if isinstance(a, tuple)] == [
            200, 200, 404, 400, 400, 400, 400, 200, 404]
    finally:
        for c in clients:
            await c.close()


@pytest.mark.anyio
async def test_load_route_disabled_without_a_pool():
    _, t = pair()
    c = TestClient(TestServer(tapi.build_app(AsyncEngine(t), ByteTokenizer(), "tiny", 128)))
    await c.start_server()
    try:
        r = await c.post("/v1/load_lora_adapter", json={"lora_name": "x", "lora_path": "/nope"})
        assert r.status == 400 and "disabled" in (await r.json())["error"]["message"]
    finally:
        await c.close()


@pytest.mark.anyio
async def test_responses_route_serves_the_adapter():
    """The port's ``/v1/responses`` resolves the model id as completions
    and chat do (the JAX server's Responses route serves the base model:
    ROADMAP.md queue 3): an adapter's id answers with the adapter's text,
    which chat gives for the same messages, and an unknown id is a 404."""
    _, t = pair()
    for s in (1, 2):
        t.set_lora_weights(s, adapter(1000 + s))
    c = TestClient(TestServer(tapi.build_app(AsyncEngine(t), ByteTokenizer(), "tiny-lora", 128,
                                             lora_adapters={"sql": 1, "chat": 2})))
    await c.start_server()
    try:
        texts = {}
        for model in ("sql", "chat", "tiny-lora"):
            r = await c.post("/v1/responses", json={"model": model, "input": "hello",
                                                    "max_output_tokens": 6, "temperature": 0.0})
            body = await r.json()
            assert r.status == 200 and body["model"] == model
            r = await c.post("/v1/chat/completions", json={
                "model": model, "messages": [{"role": "user", "content": "hello"}],
                "max_tokens": 6, "temperature": 0.0})
            texts[model] = (body["output"][0]["content"][0]["text"],
                            (await r.json())["choices"][0]["message"]["content"])
            assert texts[model][0] == texts[model][1]
        assert len({v[0] for v in texts.values()}) == 3
        r = await c.post("/v1/responses", json={"model": "typo", "input": "x"})
        assert r.status == 404
    finally:
        await c.close()
