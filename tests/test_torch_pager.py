"""The decode pager (``OffloadConfig.decode_paging``, ``engine/pager.py``) of
the port against the JAX package's, on the CPU.

The contract of ``tests/test_kv_pager.py``: with the pager on, every token
equals an engine's without it. Spills free only pages no read needs (the
window masks them), a restore brings back the exact bytes, and a page the
host tier lost refunds the sequence to a recompute, which gives the same
tokens. Here the same requests on the same parameters run through the JAX
pager engine and the port's, in the flat, split, bucketed and window
layouts, under async stepping and with the int8 pool, on a pool small
enough that a victim parks: the streams, JAX's six pager counters, the
gauges and the KV events are equal. Then the resident bound, the refund,
the fetch-pending wait, the refusal of a model with a full layer, and the
plain ``[B, Q]`` and flat attention functions, which read a row's whole
page table: pages below the window that hold another sequence's bytes
change nothing. JAX engines share XLA's persistent compilation cache.
"""

import jax
import numpy as np
import pytest
import torch

import llmd_tpu.config as jcfg
import llmd_tpu_torch.config as tcfg
from llmd_tpu.engine.engine import LLMEngine as JaxEngine
from llmd_tpu.engine.request import SamplingParams as JaxSP
from llmd_tpu.serve.metrics import render_metrics as jax_render
from llmd_tpu_torch import ops
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.models.llama import params_from_jax
from llmd_tpu_torch.serve.metrics import render_metrics

from test_torch_kv_events import Recorder
from test_torch_spec import jax_compile_cache, one_thread  # noqa: F401 (module fixtures)

COUNTERS = ("pages_spilled_total", "pages_restored_total", "parks_total", "refunds_total",
            "prefetch_late_total", "paged_out_bytes")
LAYOUTS = {
    "flat": ({}, "float32"),
    "split": (dict(unified_step=False), "float32"),
    "bucketed": (dict(ragged_qlens=False), "float32"),
    "window": (dict(decode_window=4), "float32"),
    "async": (dict(async_scheduling=True), "float32"),
    "int8": ({}, "int8"),
}
rng = np.random.default_rng(0)
PROMPT = [int(t) for t in rng.integers(0, 256, size=48)]
PROMPTS = [[int(t) for t in rng.integers(0, 256, size=24)] for _ in range(2)]


def config(pkg, paging, num_blocks=128, horizon=8, window=8, cpu_chunks=512, kv="float32",
           **sched):
    return pkg.EngineConfig(
        model=pkg.tiny_model_config(max_model_len=256, sliding_window=window),
        cache=pkg.CacheConfig(page_size=4, num_blocks=num_blocks, dtype=kv),
        scheduler=pkg.SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=64, **sched),
        offload=pkg.OffloadConfig(enabled=True, cpu_chunks=cpu_chunks, decode_paging=paging,
                                  pager_horizon_tokens=horizon),
        seed=0,
    )


_PARAMS = {}


def engines(paging, **kw):
    """(JAX engine, port engine on its parameters), each with a recording
    event sink."""
    j = JaxEngine(config(jcfg, paging, **kw), event_sink=Recorder())
    if "p" not in _PARAMS:
        _PARAMS["p"] = params_from_jax(jax.tree.map(np.asarray, j.runner.params))
    t = LLMEngine(config(tcfg, paging, **kw), params=_PARAMS["p"], device="cpu",
                  event_sink=Recorder())
    return j, t


def run(eng, SP, prompts, max_tokens, sabotage=False):
    """Drive to completion; returns the streams. ``sabotage`` drops every
    parked page from the host tier after the first park, as a tier evicting
    under pressure before the restore would."""
    params = SP(temperature=0.0, max_tokens=max_tokens)
    rids = [eng.add_request(list(p), params) for p in prompts]
    out = {rid: [] for rid in rids}
    dropped = False
    for _ in range(400):
        if not eng.has_work():
            break
        if sabotage and not dropped and eng.pager.parks_total > 0:
            for req in eng.scheduler.waiting:
                if req.kv_fetch_pending:
                    for h in req.paged_out.values():
                        eng._host_cache.drop(h)
                    dropped = True
        for o in eng.step():
            out[o.request_id].extend(o.new_token_ids)
    assert not eng.has_work()
    return [out[r] for r in rids]


def counters(pager) -> dict:
    return {name: getattr(pager, name) for name in COUNTERS}


@pytest.fixture(scope="module")
def reference():
    """The streams of a JAX engine without the pager, on a pool that holds
    everything."""
    j = JaxEngine(config(jcfg, False, num_blocks=256, window=32, horizon=4))
    return run(j, JaxSP, PROMPTS, 40)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_park_restore_and_spill_equal_jax(layout, reference):
    """Two sequences on a 14-page pool: cold pages spill while they
    decode, page pressure parks a victim, its window comes back. Streams,
    counters, gauges and events equal JAX's, streams equal an untouched
    run's."""
    sched, kv = LAYOUTS[layout]
    j, t = engines(True, num_blocks=14, window=32, horizon=4, kv=kv, **sched)
    jout = run(j, JaxSP, PROMPTS, 40)
    tout = run(t, SamplingParams, PROMPTS, 40)
    assert tout == jout
    if kv == "float32":
        assert tout == reference
    assert counters(t.pager) == counters(j.pager)
    assert t.pager.parks_total > 0 and t.pager.pages_restored_total > 0
    assert t.pager.pages_spilled_total > 0 and t.pager.refunds_total == 0
    j._refresh_gauges()
    t._refresh_gauges()
    for name in ("kv_paged_out_bytes", "kv_pager_prefetch_late_total", "preemptions",
                 "offload_pages", "offload_saves", "offload_restores"):
        assert getattr(t.stats, name) == getattr(j.stats, name), name
    assert t._host_cache.stats() == j._host_cache.stats()
    assert t.allocator.event_sink.inner.events == j.allocator.event_sink.inner.events
    pager_lines = [[ln for ln in render(e.stats, "m").splitlines() if "pager" in ln or "paged_out" in ln]
                   for render, e in ((jax_render, j), (render_metrics, t))]
    assert pager_lines[1] == pager_lines[0] and len(pager_lines[1]) >= 4


def test_spill_keeps_the_stream_and_bounds_residency():
    """One long decode: pages spill while the context grows far past the
    window, the resident pages stay within window + horizon + the partial
    frontier + one chunk, and the stream equals the pager-off run's and
    JAX's."""
    j, t = engines(True, num_blocks=64, window=8, horizon=8)
    ref = LLMEngine(config(tcfg, False, num_blocks=64, window=8, horizon=8),
                    params=_PARAMS["p"], device="cpu")
    sp = SamplingParams(temperature=0.0, max_tokens=40)
    want = ref.generate([PROMPT], sp)
    jout = run(j, JaxSP, [PROMPT], 40)
    rid = t.add_request(PROMPT, sp)
    got, peak = [], 0
    while t.has_work():
        for o in t.step():
            got.extend(o.new_token_ids)
        for req in t.scheduler.running:
            if req.request_id == rid:
                peak = max(peak, len(req.block_ids) - len(req.paged_out))
    assert [got] == jout == list(want.values())
    assert counters(t.pager) == counters(j.pager)
    assert t.pager.pages_spilled_total > 0
    keep_pages = (8 + 8) // 4
    assert peak <= keep_pages + 3, peak
    assert (len(PROMPT) + 40) // 4 > keep_pages + 3


def test_host_tier_miss_refunds_to_recompute():
    """The parked pages vanish from the host tier before the restore: the
    victim refunds to a recompute from zero, with JAX's counters, and the
    streams do not change."""
    j, t = engines(True, num_blocks=14, window=32, horizon=4)
    jout = run(j, JaxSP, PROMPTS, 40, sabotage=True)
    tout = run(t, SamplingParams, PROMPTS, 40, sabotage=True)
    assert tout == jout
    assert t.pager.refunds_total > 0
    assert counters(t.pager) == counters(j.pager)


def test_fetch_pending_is_a_wait_not_a_fault():
    """While a parked request's window is not back, the scheduler admits
    nothing behind it; the run completes."""
    _, t = engines(True, num_blocks=14, window=32, horizon=4)
    sp = SamplingParams(temperature=0.0, max_tokens=40)
    for p in PROMPTS:
        t.add_request(list(p), sp)
    t.pager.pump = lambda waiting: None  # no restore: the head waits
    for _ in range(60):
        t.step()
    parked = [r for r in t.scheduler.waiting if r.kv_fetch_pending]
    assert parked and parked[0] is t.scheduler.waiting[0]
    assert not t.scheduler._schedule().prefills
    del t.pager.pump
    for _ in range(400):
        if not t.has_work():
            break
        t.step()
    assert not t.has_work() and t.pager.parks_total > 0


def test_decode_paging_requires_every_layer_to_slide():
    for pkg, kw in ((jcfg, {}), (tcfg, dict(device="cpu"))):
        with pytest.raises(ValueError, match="requires every layer to be sliding-window"):
            (JaxEngine if pkg is jcfg else LLMEngine)(config(pkg, True, window=0), **kw)
    # Without the offload tier there is no pager, as in JAX.
    cfg = config(tcfg, True, window=0)
    cfg.offload.enabled = False
    assert LLMEngine(cfg, device="cpu").pager is None


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_plain_attention_reads_recycled_pages_below_the_window_as_nothing(kv):
    """A spilled page's id stays in its row's table and may hold another
    sequence's bytes. The plain ``[B, Q]`` function (the bucketed step and
    the split engine's rows) and the flat one gather the whole table and
    mask: the output is bit for bit the same whatever those pages hold."""
    g = torch.Generator().manual_seed(3)
    L, P, K, page, D, window = 1, 24, 2, 4, 8, 8
    pool = torch.randn((L, P, K, page, 2 * D), generator=g)
    if kv == "int8":
        pool = (torch.randint(-127, 128, pool.shape, generator=g, dtype=torch.int8),
                torch.rand((*pool.shape[:4], 2), generator=g) + 0.5)
    table = torch.arange(1, 11, dtype=torch.int32)[None].repeat(2, 1)  # 10 pages a row
    stale = table.clone()
    stale[:, :5] = torch.tensor([20, 21, 22, 23, 0], dtype=torch.int32)  # below the window
    kv_len = torch.tensor([39, 40], dtype=torch.int32)
    for Q in (1, 3):
        q = torch.randn((2, Q, 4, D), generator=g)
        pos = (kv_len[:, None] - Q + torch.arange(Q)).int()
        outs = [ops.paged_attention_full(q, pool, 0, t, kv_len, pos, D**-0.5, None, window, None)
                for t in (table, stale)]
        assert torch.equal(outs[0], outs[1])
    # The flat form: each token its row's table.
    q = torch.randn((4, 1, 4, D), generator=g)
    rows = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    kvl = torch.tensor([38, 39, 39, 40], dtype=torch.int32)
    outs = [ops.paged_attention_full_flat(q, pool, 0, rows, t, kvl, D**-0.5, window, None)
            for t in (table, stale)]
    assert torch.equal(outs[0], outs[1])
