"""Tiered KV offload (``EngineConfig.offload``, ``kvtransfer/offload.py``) of
the port against the JAX package's, on the CPU.

The contract of ``tests/test_offload.py``: a prompt whose pages the device
cache evicted but a host tier kept gives the same tokens when its pages are
restored, and its prefill is served from the restored pages. Here the
host cache's LRU, cap, file spill and persistence are held to JAX's
``HostKVCache`` on the same operations; ``commit_hook`` fires on the
commits JAX's fires on; the runner's ``gather_pages`` and
``scatter_pages`` equal the JAX runner's on float32, bf16 and int8 pools
(the int8 pool dequantized to the model's dtype and requantized on the
f16 grid) and on MLA latent pools. Then the engines, on tiny, tiny-moe,
tiny-mla and the int8 pool: the same greedy and seeded requests through
the JAX offload engine, the port's offload engine (on its parameters) and
the port's engine without offload, with a device pool small enough that
the prompts' pages are evicted, a host tier small enough that some spill
to files: streams equal, restores served from host DRAM and from files,
the host tiers' counters and contents equal to JAX's (within the models'
f32 arithmetic: 1e-4, and for the int8 pool one int8 level of a row and
one f16 ulp of its scale; the port's async engine's host contents equal
its synchronous engine's bit for bit), the pool restored in place, the
``kv_offload`` series equal. Offload beside the sliding-window ring is
refused, as in JAX. Engines are built once for the module, and the JAX
engines share XLA's persistent compilation cache.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llmd_tpu.config as jcfg
import llmd_tpu.engine.kv_cache as jkv
import llmd_tpu_torch.config as tcfg
import llmd_tpu_torch.engine.kv_cache as tkv
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine import SamplingParams as JaxSP
from llmd_tpu.kvtransfer.offload import HostKVCache as JaxHostKVCache
from llmd_tpu.models.registry import get_model_config as jax_model_config
from llmd_tpu.serve.metrics import render_metrics as jax_render
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.engine.runner import pages_to_numpy
from llmd_tpu_torch.kvtransfer.offload import HostKVCache
from llmd_tpu_torch.models.llama import params_from_jax
from llmd_tpu_torch.models.registry import get_model_config
from llmd_tpu_torch.serve.metrics import render_metrics

from test_torch_spec import jax_compile_cache, one_thread  # noqa: F401 (module fixtures)


# --------------------------------------------------------------------- #
# the host cache against JAX's


def host_ops(cache_cls, fs_dir, phase: int):
    """A fixed run of puts and gets on a cache (``phase`` 1 also reopens
    the directory, as a restarted process would); returns what each get
    returned and the stats after each call."""
    rng = np.random.default_rng(1)
    pages = {bytes([i, 7]): rng.standard_normal((2, 2, 4, 8)).astype(np.float32)
             for i in range(8)}
    hc = cache_cls(max_pages=3, fs_dir=fs_dir, fs_max_pages=4)
    log = []
    keys = list(pages)
    for i, h in enumerate(keys):
        hc.put(h, pages[h])
        if i % 3 == 2:
            got = hc.get(keys[i - 2])  # touch: the oldest becomes the newest
            log.append(None if got is None else got.tolist())
        hc.put(h, pages[h])  # a repeat put only refreshes the page
        log.append((len(hc), hc.has(keys[0]), hc.stats()))
    for h in reversed(keys):
        page, tier = hc.get_tagged(h)
        log.append((tier, None if page is None else page.tolist(), hc.stats()))
    if phase and fs_dir is not None:
        if hasattr(hc, "close"):  # the port's writer thread finishes its files
            hc.close()
        again = cache_cls(max_pages=10, fs_dir=fs_dir)
        log.append(("reopened", again.stats(), [again.has(h) for h in keys],
                    [None if again.get(h) is None else again.get(h).tolist() for h in keys]))
        again.clear()
        log.append(("cleared", again.stats(), sorted(p.name for p in again.fs_dir.iterdir())))
    return log


@pytest.mark.parametrize("fs", [False, True], ids=["dram", "fs"])
def test_host_cache_is_jax_host_cache(tmp_path, fs):
    """LRU order, the cap, spills to files, loads back from them, the
    file tier's own cap, persistence across a reopen, and ``clear``."""
    logs = []
    for name, cls in (("jax", JaxHostKVCache), ("port", HostKVCache)):
        d = tmp_path / name
        logs.append(host_ops(cls, str(d) if fs else None, phase=1))
    assert logs[0] == logs[1]
    if fs:
        assert logs[1][-3][-1]["fs_spills"] > 0 and logs[1][-3][-1]["fs_loads"] > 0


def test_host_page_pool_slots_come_back(tmp_path):
    """The engine's host pages live in the pool's slabs: a page that leaves
    host DRAM (LRU eviction, whose spill writes its bits to a file; drop;
    clear) gives its slot back, and the next take reuses it; bf16 pages
    spill as ``uint16`` bits and load back as the same bits."""
    from llmd_tpu_torch.kvtransfer.offload import HostPagePool

    pool = HostPagePool((2, 1, 4, 8), torch.bfloat16, pin=False, slab_pages=4)
    hc = HostKVCache(max_pages=2, fs_dir=str(tmp_path))
    hc.release = pool.give
    pages = []
    for i in range(3):
        t = pool.take()
        t.copy_(torch.full(t.shape, 1.5 + i, dtype=torch.bfloat16))
        pages.append(t)
        assert hc.put(bytes([i]), t)
    assert not hc.put(bytes([2]), pages[2])  # a refresh stores nothing
    hc.drain()
    assert len(pool._slabs) == 1 and len(pool._free) == 2  # page 0 spilled: its slot is back
    back = hc.get(bytes([0]))
    assert back.dtype == np.uint16 and np.array_equal(back, pages_to_numpy(pages[0]))
    assert pool.take().data_ptr() == pages[0].data_ptr()
    hc.drop(bytes([1]))
    hc.clear()
    assert len(pool._free) == 3 and pool.bytes == 4 * 2 * 4 * 8 * 2


def test_a_spill_waits_for_its_file_off_the_caller(tmp_path, monkeypatch):
    """A page the LRU evicts is written by the writer thread: ``put``
    returns while its file is still being written, the page already counts
    as spilled, a load reads its bits from memory, and its slot comes back
    only once the file is whole (under its final name)."""
    from llmd_tpu_torch.kvtransfer import offload
    from llmd_tpu_torch.kvtransfer.offload import HostPagePool

    gate, real_save = threading.Event(), np.save
    monkeypatch.setattr(offload.np, "save", lambda f, a: (gate.wait(30), real_save(f, a)))
    pool = HostPagePool((2, 1, 4, 8), torch.bfloat16, pin=False, slab_pages=4)
    hc = HostKVCache(max_pages=1, fs_dir=str(tmp_path))
    hc.release = pool.give
    pages = []
    for i in range(2):
        t = pool.take()
        t.copy_(torch.full(t.shape, 2.5 + i, dtype=torch.bfloat16))
        pages.append(t)
        assert hc.put(bytes([i]), t)
    assert hc.stats() == {"pages": 1, "fs_pages": 1, "saves": 2, "restores": 0,
                          "fs_spills": 1, "fs_loads": 0}
    assert len(pool._free) == 2 and not list(tmp_path.glob("*.npy"))
    page, tier = hc.get_tagged(bytes([0]))
    assert tier == "fs" and np.array_equal(page, pages_to_numpy(pages[0]))
    gate.set()
    hc.close()
    assert len(pool._free) == 3
    assert [p.name for p in tmp_path.iterdir()] == [bytes([0]).hex() + ".npy"]
    assert np.array_equal(hc.get(bytes([0])), pages_to_numpy(pages[0]))
    assert hc.stats()["fs_loads"] == 2


def test_spills_under_thread_switches_keep_every_page(tmp_path):
    """The engine thread saves and loads while the writer spills and more
    probing threads than cores ask ``has`` and ``stats`` (the server's
    cache probe), the interpreter switching threads every microsecond:
    every page saved stays readable with its bits, from host DRAM, the
    writer's queue or its file; the counters add up; and after ``close``
    every slot of the pool is back but those host DRAM holds."""
    import os
    import sys

    from llmd_tpu_torch.kvtransfer.offload import HostPagePool

    pool = HostPagePool((2, 1, 4, 8), torch.float32, pin=False, slab_pages=8)
    hc = HostKVCache(max_pages=8, fs_dir=str(tmp_path), fs_max_pages=10_000)
    hc.release = pool.give
    n, keys = 300, [i.to_bytes(4, "little") for i in range(300)]
    stop, seen = threading.Event(), []

    def probe():
        last = 0
        while not stop.is_set():
            hc.has(keys[last % n])
            st = hc.stats()
            assert st["fs_spills"] >= last and st["pages"] <= 8
            last = st["fs_spills"]
        seen.append(last)

    probes = [threading.Thread(target=probe) for _ in range((os.cpu_count() or 1) + 1)]
    switch = sys.getswitchinterval()
    rng = np.random.default_rng(0)
    try:
        sys.setswitchinterval(1e-6)
        for t in probes:
            t.start()
        for i, h in enumerate(keys):
            slot = pool.take()
            slot.fill_(float(i))
            assert hc.put(h, slot)
            j = int(rng.integers(i + 1))
            page = hc.get(keys[j])
            got = page.numpy() if isinstance(page, torch.Tensor) else page
            assert np.array_equal(got, np.full(slot.shape, float(j), np.float32)), (i, j)
    finally:
        stop.set()
        for t in probes:
            t.join(timeout=30)
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in probes) and len(seen) == len(probes)
    hc.close()
    st = hc.stats()
    assert st["saves"] == n and st["fs_spills"] == st["fs_pages"] == n - 8 and st["pages"] == 8
    assert len(list(tmp_path.glob("*.npy"))) == n - 8 and not list(tmp_path.glob("*.tmp"))
    assert len(pool._free) == len(pool._slabs) * 8 - 8


def test_commit_hook_fires_where_jax_fires():
    """Every commit that registers content calls the hook, a repeat commit
    of the same page too; a commit of content another page holds does
    not."""
    calls = {"jax": [], "port": []}
    allocs = {}
    for name, mod in (("jax", jkv), ("port", tkv)):
        a = mod.PageAllocator(num_pages=6, page_size=2)
        a.commit_hook = lambda pid, h, log=calls[name]: log.append((pid, h))
        allocs[name] = a
    for name, a in allocs.items():
        ids = a.allocate(4)
        for pid, h in ((ids[0], b"a"), (ids[1], b"b"), (ids[0], b"a"), (ids[2], b"a"),
                       (ids[3], b"c")):
            a.commit_page(pid, h, [1, 2], None)
        a.free(ids)
        a.allocate(6)  # evicts everything
        ids = a.allocate(0)
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 4


# --------------------------------------------------------------------- #
# the page legs against the JAX runner's

RUNNERS = {
    "f32": (dict(), "float32"),
    "bf16": (dict(dtype="bfloat16"), "bfloat16"),
    "int8-f32": (dict(), "int8"),
    "int8-bf16": (dict(dtype="bfloat16"), "int8"),
    "mla-bf16": (dict(name="tiny-mla", dtype="bfloat16"), "bfloat16"),
}


def runner_pair(kind):
    """A JAX runner and the port's on one config, their pools filled with
    the same seeded values (an int8 pool's scales on the f16 grid)."""
    model, kv_dtype = RUNNERS[kind]
    mla = model.pop("name", None)
    cache = dict(page_size=4, num_blocks=12, dtype=kv_dtype)
    jm = jax_model_config(mla, **model) if mla else jcfg.tiny_model_config(**model)
    tm = get_model_config(mla, **model) if mla else tcfg.tiny_model_config(**model)
    j = JaxEngine(jcfg.EngineConfig(model=jm, cache=jcfg.CacheConfig(**cache),
                                    parallel=jcfg.ParallelConfig())).runner
    params = params_from_jax(jax.tree.map(np.asarray, j.params))
    p = LLMEngine(tcfg.EngineConfig(model=tm, cache=tcfg.CacheConfig(**cache)),
                  params=params, device="cpu").runner
    rng = np.random.default_rng(5)
    if kv_dtype == "int8":
        data = rng.integers(-127, 128, size=p.kv_cache[0].shape).astype(np.int8)
        scales = rng.uniform(0.004, 0.02, size=p.kv_cache[1].shape).astype(np.float16).astype(np.float32)
        j.kv_cache = (jnp.asarray(data), jnp.asarray(scales))
        p.kv_cache[0].copy_(torch.from_numpy(data))
        p.kv_cache[1].copy_(torch.from_numpy(scales))
    else:
        vals = rng.standard_normal(p.kv_cache.shape).astype(np.float32)
        j.kv_cache = jnp.asarray(vals, dtype=j.kv_cache.dtype)
        p.kv_cache.copy_(torch.from_numpy(vals).to(p.kv_cache.dtype))
    return j, p


def bits(a) -> np.ndarray:
    """An array's bits, bf16 (``ml_dtypes``'s or the port's ``uint16``)
    as ``uint16``."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def pool_bits(pool) -> list[np.ndarray]:
    """A pool's arrays (an int8 pool's data and scales), bf16 as bits."""
    parts = pool if isinstance(pool, tuple) else (pool,)
    out = []
    for t in parts:
        if isinstance(t, torch.Tensor):
            out.append(t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16
                       else t.numpy())
        else:
            out.append(bits(t))
    return out


@pytest.mark.parametrize("kind", list(RUNNERS))
def test_page_legs_are_jax_runners(kind):
    j, p = runner_pair(kind)
    ids = [7, 2, 11, 2, 5]
    got, want = p.gather_pages(ids), j.gather_pages(ids)
    assert got.shape == want.shape and got.shape[1] == len(ids)
    np.testing.assert_array_equal(got, bits(want))
    assert got.dtype == (np.uint16 if "bf16" in kind else np.float32)
    # Scatter a fresh bundle (JAX's dtype, which the port reads too) into
    # other pages: the pools must then be equal byte for byte, an int8
    # pool's data and scales included (requantized on the f16 grid), and
    # the port's pool tensors stay where they were.
    rng = np.random.default_rng(9)
    shape = (want.shape[0], 3, *want.shape[2:])
    bundle = np.asarray(jnp.asarray(rng.standard_normal(shape), dtype=want.dtype))
    ptrs = [t.data_ptr() for t in (p.kv_cache if isinstance(p.kv_cache, tuple) else (p.kv_cache,))]
    j.scatter_pages([1, 9, 4], bundle)
    p.scatter_pages([1, 9, 4], bundle)
    for a, b in zip(pool_bits(p.kv_cache), pool_bits(j.kv_cache)):
        np.testing.assert_array_equal(a, b)
    assert ptrs == [t.data_ptr() for t in (p.kv_cache if isinstance(p.kv_cache, tuple)
                                           else (p.kv_cache,))]
    # The port's own bundle form (bf16 as bits) scatters the same bytes.
    back = p.gather_pages([1, 9, 4])
    np.testing.assert_array_equal(back, bits(j.gather_pages([1, 9, 4])))
    p.scatter_pages([3, 6, 8], back)
    j.scatter_pages([3, 6, 8], np.asarray(j.gather_pages([1, 9, 4])))
    for a, b in zip(pool_bits(p.kv_cache), pool_bits(j.kv_cache)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- #
# the engines

MODELS = ("tiny", "tiny-moe", "tiny-mla", "tiny-int8")
PAGE, BLOCKS, HOST_PAGES = 4, 24, 36
# Two prompts to restore (A from the file tier, B from host DRAM) and junk
# prompts that push them out of the device pool (24 pages; a junk request
# takes 8) and A out of host DRAM (36 pages; a junk request commits 7).
PROMPT_A = [1, 5, 9, 13, 2, 8, 4, 4, 4, 4, 6, 6, 6, 6, 11, 7, 3, 2]
PROMPT_B = [3, 3, 7, 1, 9, 9, 2, 2, 5, 8, 8, 1, 4, 4, 2, 6, 7]
SAMPLING = {"greedy": dict(temperature=0.0, max_tokens=6),
            "seeded": dict(temperature=0.9, max_tokens=6, seed=99)}


def junk(i: int, shift: int) -> list[int]:
    return [int(t) for t in np.random.default_rng(100 * shift + i).integers(20, 250, size=26)]


def build(model: str, tmp):
    """(JAX offload engine, port offload engine, port async offload engine,
    port engine without offload), the port's on the JAX engine's
    parameters; each offload engine with a file tier of its own."""
    name, kv = ("tiny", "int8") if model == "tiny-int8" else (model, "float32")
    jm, tm = jax_model_config(name), get_model_config(name)
    cache = dict(page_size=PAGE, num_blocks=BLOCKS, dtype=kv)
    sched = dict(max_num_seqs=4, max_num_batched_tokens=32)

    def offload(mod, tag):
        return mod.OffloadConfig(cpu_chunks=HOST_PAGES, fs_dir=str(tmp / f"{model}-{tag}"))

    j = JaxEngine(jcfg.EngineConfig(
        model=jm, cache=jcfg.CacheConfig(**cache), scheduler=jcfg.SchedulerConfig(**sched),
        parallel=jcfg.ParallelConfig(), offload=offload(jcfg, "jax")))
    params = params_from_jax(jax.tree.map(np.asarray, j.runner.params))

    def port(tag, async_scheduling=False):
        return LLMEngine(tcfg.EngineConfig(
            model=tm, cache=tcfg.CacheConfig(**cache),
            scheduler=tcfg.SchedulerConfig(**sched, async_scheduling=async_scheduling),
            offload=offload(tcfg, tag) if tag else None), params=params, device="cpu")

    return j, port("sync"), port("async", True), port(None)


@pytest.fixture(scope="module")
def quads(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("offload")
    cache = {}

    def get(model):
        if model not in cache:
            cache[model] = build(model, tmp)
        return cache[model]

    return get


def gen(eng, SP, prompt, sp) -> list[int]:
    return next(iter(eng.generate([list(prompt)], SP(**sp)).values()))


def host_state(eng):
    """The host tiers' counters and their keys in LRU order."""
    hc = eng._host_cache
    return hc.stats(), list(hc._pages), list(hc._fs_lru)


def host_page(eng, h) -> np.ndarray:
    """A host-DRAM page as numpy (the port keeps host tensors)."""
    page = eng._host_cache._pages[h]
    return np.asarray(page, dtype=np.float32) if isinstance(page, np.ndarray) else pages_to_numpy(page)


def assert_within_a_level(got, want):
    """Dequantized int8 pages of two models whose f32 K|V rows differ in
    the last bits: each value within one int8 level of its row half
    (amax / 127, where a rounding boundary fell between the two) and one
    f16 ulp of its row's scale (where the f16-rounded scales differ)."""
    D = want.shape[-1] // 2
    level = np.concatenate([np.abs(want[..., :D]).max(-1, keepdims=True).repeat(D, -1),
                            np.abs(want[..., D:]).max(-1, keepdims=True).repeat(D, -1)], -1) / 127
    assert np.all(np.abs(got - want) <= level * (1 + 2.0**-9) + np.abs(want) * 2.0**-10)


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("model", MODELS)
def test_restored_streams_equal_jax_and_no_offload(quads, model, sampling):
    j, p, pa, plain = quads(model)
    sp = SAMPLING[sampling]
    shift = 1 + list(SAMPLING).index(sampling)
    a = [t + shift for t in PROMPT_A]
    b = [t + shift for t in PROMPT_B]
    engines = ((j, JaxSP), (p, SamplingParams), (pa, SamplingParams), (plain, SamplingParams))

    def all_gen(prompt):
        outs = [gen(e, SP, prompt, sp) for e, SP in engines]
        assert outs[1:] == outs[:1] * 3, prompt
        return outs[0]

    first_a = all_gen(a)
    for i in range(4):
        all_gen(junk(i, shift))
    first_b = all_gen(b)
    for i in range(4, 8):
        all_gen(junk(i, shift))
    hashes = tkv.page_hashes_for_tokens(a, PAGE) + tkv.page_hashes_for_tokens(b, PAGE)
    for e, _ in engines[:3]:
        assert not any(e.allocator.has_cached(h) for h in hashes)  # gone from the device
    assert p.cached_prefix_pages(a) == j.cached_prefix_pages(a) == len(a) // PAGE
    before = p._host_cache.stats()
    assert all_gen(a) == first_a and all_gen(b) == first_b
    after = p._host_cache.stats()
    # Every full page of both prompts came back: A's from the file tier,
    # B's from host DRAM.
    assert after["restores"] - before["restores"] == len(hashes)
    assert after["fs_loads"] - before["fs_loads"] == len(a) // PAGE
    jstate, pstate, astate = host_state(j), host_state(p), host_state(pa)
    assert pstate == astate
    assert pstate[0] == jstate[0] and pstate[1:] == jstate[1:]
    for h in pstate[1]:
        got = host_page(p, h)
        np.testing.assert_array_equal(got, host_page(pa, h))
        want = host_page(j, h)
        if model == "tiny-int8":
            assert_within_a_level(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for key in ("offload_pages", "offload_fs_pages", "offload_saves", "offload_restores",
                "prefix_hit_ratio", "preemptions"):
        assert getattr(p.stats, key) == getattr(j.stats, key), key
    assert pa.stats.offload_saves == p.stats.offload_saves
    mine = [ln for ln in render_metrics(p.stats, "tiny").splitlines() if "offload" in ln or "recompute_avoided" in ln]
    assert mine == [ln for ln in jax_render(j.stats, "tiny").splitlines()
                    if "offload" in ln or "recompute_avoided" in ln]
    assert p.allocator.num_free_pages == pa.allocator.num_free_pages == j.allocator.num_free_pages


def test_a_new_engine_restores_from_the_file_tier(tmp_path):
    """The file tier outlives its engine: a new engine over the directory
    of one that spilled a prompt's pages restores them from files and
    emits the first engine's tokens."""
    def engine():
        return LLMEngine(tcfg.EngineConfig(
            model=tcfg.tiny_model_config(), cache=tcfg.CacheConfig(
                page_size=PAGE, num_blocks=BLOCKS, dtype="float32"),
            scheduler=tcfg.SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=32),
            offload=tcfg.OffloadConfig(cpu_chunks=4, fs_dir=str(tmp_path))), device="cpu")

    sp = SAMPLING["greedy"]
    first = engine()
    want = gen(first, SamplingParams, PROMPT_A, sp)
    gen(first, SamplingParams, junk(0, 0), sp)  # spills PROMPT_A's pages
    spilled = first._host_cache.stats()["fs_pages"]
    assert spilled >= len(PROMPT_A) // PAGE
    first.close()
    fresh = engine()
    assert fresh._host_cache.stats()["fs_pages"] == spilled
    assert fresh.cached_prefix_pages(PROMPT_A) == len(PROMPT_A) // PAGE
    assert gen(fresh, SamplingParams, PROMPT_A, sp) == want
    st = fresh._host_cache.stats()
    assert st["fs_loads"] == st["restores"] == len(PROMPT_A) // PAGE
    assert fresh.stats.offload_restores == st["restores"]


def test_offload_refused_beside_the_ring():
    kw = dict(model=tcfg.tiny_model_config(sliding_window=16), cache=tcfg.CacheConfig(
        page_size=4, num_blocks=64, dtype="float32", swa_ring=True),
        scheduler=tcfg.SchedulerConfig(max_num_seqs=4, max_num_batched_tokens=32))
    assert tcfg.swa_ring_spec(kw["model"], kw["cache"], kw["scheduler"]) is not None
    with pytest.raises(ValueError, match="kv_swa_ring does not compose with tiered KV offload"):
        LLMEngine(tcfg.EngineConfig(**kw, offload=tcfg.OffloadConfig()), device="cpu")
    LLMEngine(tcfg.EngineConfig(**kw, offload=tcfg.OffloadConfig(enabled=False)), device="cpu")


@pytest.mark.parametrize("kw,later", [
    (dict(decode_paging=True), "the pager"),
])
def test_later_tiers_are_refused_by_name(kw, later):
    """A later tier (``later``) was refused by name until it was ported;
    since the decode pager its switch is a field with JAX's default that
    takes JAX's values."""
    for name, value in kw.items():
        assert getattr(tcfg.OffloadConfig(), name) == getattr(jcfg.OffloadConfig(), name)
        assert getattr(tcfg.OffloadConfig(**kw), name) == value
        assert getattr(jcfg.OffloadConfig(**kw), name) == value


@pytest.mark.parametrize("name,value", [
    ("store_master_url", "http://store:1"), ("store_segment_bytes", 1 << 22),
    ("store_data_port", 9200), ("publish_policy", "evict-hot"), ("publish_min_hits", 3),
])
def test_store_tier_knobs_are_jax_knobs(name, value):
    """The store tier's fields (ported since the cross-slice store) have
    JAX's defaults and take JAX's values; as in JAX, the configuration
    checks none of them (an unknown publish policy fails where the engine
    builds its federation, ``test_torch_kvstore.py``)."""
    assert getattr(tcfg.OffloadConfig(), name) == getattr(jcfg.OffloadConfig(), name)
    assert getattr(tcfg.OffloadConfig(**{name: value}), name) == value
    assert getattr(jcfg.OffloadConfig(**{name: value}), name) == value


@pytest.mark.parametrize("name", ["pager_horizon_tokens"])
def test_later_tier_knobs_are_unknown(name):
    """A later tier's knob was no field of the port's config until its tier
    was ported; since the decode pager it has JAX's default and takes
    JAX's values."""
    value = getattr(jcfg.OffloadConfig(), name)
    assert getattr(tcfg.OffloadConfig(), name) == value
    assert getattr(tcfg.OffloadConfig(**{name: value + 64}), name) == value + 64
    assert getattr(jcfg.OffloadConfig(**{name: value + 64}), name) == value + 64


def test_async_save_gathers_before_the_next_step_writes():
    """A request finishes in step N and its last page is committed there;
    the staged step N+1 is rolled back whole, and the step scheduled in its
    place admits a waiting request into every page of the pool, that one
    included. The async engine gathers N's pages before it dispatches that
    step, so its host tier holds the finished request's page, bit for bit
    the synchronous engine's (and JAX's synchronous engine's within the
    models' arithmetic). JAX's async engine gathers after the dispatch and
    saves the new request's bytes under that page's hash (ROADMAP.md
    queue 3), so the port is held to the synchronous engines here."""
    def kw(mod, async_scheduling):
        return dict(model=mod.tiny_model_config(), cache=mod.CacheConfig(
            page_size=4, num_blocks=8, dtype="float32"), scheduler=mod.SchedulerConfig(
            max_num_seqs=4, max_num_batched_tokens=64, async_scheduling=async_scheduling),
            offload=mod.OffloadConfig(cpu_chunks=100))

    j = JaxEngine(jcfg.EngineConfig(**kw(jcfg, False), parallel=jcfg.ParallelConfig()))
    params = params_from_jax(jax.tree.map(np.asarray, j.runner.params))
    sync, async_ = (LLMEngine(tcfg.EngineConfig(**kw(tcfg, a)), params=params, device="cpu")
                    for a in (False, True))
    # A: 14 prompt tokens, 3 out (5 pages; its 4th page commits in its last
    # step). B: 30 prompt tokens, all 8 pages: it waits until A finishes.
    a, b = list(range(1, 15)), list(range(40, 70))
    streams = []
    for eng, SP in ((j, JaxSP), (sync, SamplingParams), (async_, SamplingParams)):
        eng.add_request(a, SP(temperature=0.0, max_tokens=3, ignore_eos=True))
        eng.add_request(b, SP(temperature=0.0, max_tokens=2, ignore_eos=True))
        out: dict = {}
        while eng.has_work():
            for o in eng.step():
                out.setdefault(o.request_id, []).extend(o.new_token_ids)
        streams.append(list(out.values()))
    assert streams[1] == streams[2] == streams[0]
    assert async_.stats.async_rollbacks_total > 0
    assert async_.scheduler.num_preemptions == sync.scheduler.num_preemptions == 0
    keys = list(sync._host_cache._pages)
    assert list(async_._host_cache._pages) == keys == list(j._host_cache._pages)
    for h in keys:
        np.testing.assert_array_equal(host_page(async_, h), host_page(sync, h))
        np.testing.assert_allclose(host_page(async_, h), host_page(j, h), atol=1e-4, rtol=0)
