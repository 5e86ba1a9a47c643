"""The port's LLMEngine against the JAX LLMEngine: identical streams.

Both engines are built from the same configuration on tiny f32 models; the
port loads the JAX engine's own parameters (``engine.runner.params`` ->
numpy -> ``params_from_jax``) and runs on the CPU. The cases are those
``tests/test_ragged_step.py`` pins for the JAX flat step: a mixed batch,
a chunked prefill, recompute preemption and a prefix-cache hit, plus a
stop token inside a fused decode window. Every step layout of the port
(the flat step, the split engine, the split engine with fused decode
windows, the bucketed unified step) is held to the JAX engine in the same
layout and to the port's flat step. Greedy streams are equal because both
argmaxes return the first maximum; sampled streams because the port
reproduces JAX's threefry noise and draws its seeds in JAX's order.
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

import llmd_tpu.config as jcfg
import llmd_tpu_torch.config as tcfg
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine import SamplingParams as JaxSP
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu.models.registry import get_model_config as jax_model_config
from llmd_tpu_torch.models import registry
from llmd_tpu_torch.models.llama import params_from_jax
from llmd_tpu_torch.models.registry import get_model_config

from test_torch_spec import jax_compile_cache, one_thread  # noqa: F401 (module fixtures)

PROMPTS = [
    [1, 5, 9, 13, 2, 8],
    [3, 3, 7, 1],
    [1, 5, 9, 13, 2, 8, 4, 4, 4, 4, 6, 6, 6, 6, 11],
]


# SchedulerConfig switches of each step layout.
LAYOUTS = {
    "flat": {},
    "split": dict(unified_step=False),
    "window": dict(unified_step=False, decode_window=4),
    "bucketed": dict(ragged_qlens=False),
}
OTHER_LAYOUTS = ["split", "window", "bucketed"]


def engines(num_blocks=64, page=4, max_batched=32, max_seqs=8, model="tiny",
            kv_dtype="float32", **sched):
    """The JAX engine and the port's on its parameters. ``model`` is a
    registry name or a dict of ``tiny_model_config`` kwargs."""
    kw = dict(
        cache=dict(page_size=page, num_blocks=num_blocks, dtype=kv_dtype),
        scheduler=dict(max_num_seqs=max_seqs, max_num_batched_tokens=max_batched, **sched),
    )
    if isinstance(model, dict):
        jmodel, tmodel = jcfg.tiny_model_config(**model), tcfg.tiny_model_config(**model)
    else:
        jmodel, tmodel = jax_model_config(model), get_model_config(model)
    jax_engine = JaxEngine(jcfg.EngineConfig(
        model=jmodel,
        cache=jcfg.CacheConfig(**kw["cache"]),
        scheduler=jcfg.SchedulerConfig(**kw["scheduler"]),
        parallel=jcfg.ParallelConfig(tensor_parallel_size=1),
    ))
    params = params_from_jax(jax.tree.map(np.asarray, jax_engine.runner.params))
    port = LLMEngine(
        tcfg.EngineConfig(
            model=tmodel,
            cache=tcfg.CacheConfig(**kw["cache"]),
            scheduler=tcfg.SchedulerConfig(**kw["scheduler"]),
        ),
        params=params,
        device="cpu",
    )
    return jax_engine, port


def streams(engine, prompts, sp_cls, **sp):
    return list(engine.generate(prompts, sp_cls(**sp)).values())


def test_greedy_mixed_batch():
    j, p = engines()
    sp = dict(temperature=0.0, max_tokens=8)
    assert streams(p, PROMPTS, SamplingParams, **sp) == streams(j, PROMPTS, JaxSP, **sp)


def test_greedy_chunked_prefill():
    long_prompt = [int(x) for x in np.random.default_rng(0).integers(0, 256, size=60)]
    j, p = engines(max_batched=16)
    sp = dict(temperature=0.0, max_tokens=8)
    got = streams(p, [long_prompt], SamplingParams, **sp)
    assert got == streams(j, [long_prompt], JaxSP, **sp)
    # 60 prompt tokens at 16 per step: the prefill took 4 chunks.
    assert p.stats.engine_steps_total == 4 + 7


def test_greedy_preemption():
    """A tight page pool forces recompute-preemption mid-run."""
    prompts = [list(x) for x in PROMPTS] + [[9, 9, 2, 4, 4, 1, 7]]
    j, p = engines(num_blocks=14)
    sp = dict(temperature=0.0, max_tokens=12, ignore_eos=True)
    assert streams(p, prompts, SamplingParams, **sp) == streams(j, prompts, JaxSP, **sp)
    assert p.scheduler.num_preemptions == j.scheduler.num_preemptions > 0


def test_greedy_prefix_cache_hit():
    prompt = [5, 5, 1, 2, 3, 4, 8, 8, 6, 6, 2, 2]
    j, p = engines()
    sp = dict(temperature=0.0, max_tokens=8)
    for _ in range(2):  # the second run starts from the cached prefix
        assert streams(p, [prompt], SamplingParams, **sp) == streams(j, [prompt], JaxSP, **sp)
    assert p.allocator.hit_ratio() == j.allocator.hit_ratio() > 0


def port_engine(params, num_blocks=64, page=4, max_batched=32, max_seqs=8, **sched):
    return LLMEngine(
        tcfg.EngineConfig(
            model=tcfg.tiny_model_config(),
            cache=tcfg.CacheConfig(page_size=page, num_blocks=num_blocks, dtype="float32"),
            scheduler=tcfg.SchedulerConfig(
                max_num_seqs=max_seqs, max_num_batched_tokens=max_batched, **sched
            ),
        ),
        params=params,
        device="cpu",
    )


# name -> (engine sizes, prompts, sampling): the cases every layout runs.
CASES = {
    "mixed": ({}, PROMPTS, dict(temperature=0.0, max_tokens=8)),
    "chunked": (
        dict(max_batched=16),
        [[int(x) for x in np.random.default_rng(0).integers(0, 256, size=60)]],
        dict(temperature=0.0, max_tokens=8),
    ),
    "preemption": (
        dict(num_blocks=14),
        [list(x) for x in PROMPTS] + [[9, 9, 2, 4, 4, 1, 7]],
        dict(temperature=0.0, max_tokens=12, ignore_eos=True),
    ),
    # A 16-token budget staggers the prompts: later prefill chunks run
    # beside earlier rows' decodes (the mixed steps of the unified program).
    "staggered": (
        dict(max_batched=16),
        PROMPTS + [[int(x) for x in np.random.default_rng(3).integers(0, 256, size=40)]],
        dict(temperature=0.0, max_tokens=8, ignore_eos=True),
    ),
    # A 100-token chunk beside a 6-token one: two Q buckets in one step,
    # and in the bucketed unified step sub-rows of 64 + 36 tokens.
    "subrows": (
        dict(max_batched=128),
        [[int(x) for x in np.random.default_rng(4).integers(0, 256, size=100)], PROMPTS[0]],
        dict(temperature=0.0, max_tokens=8, ignore_eos=True),
    ),
    # max_tokens = 11 ends every row inside a window of 4 (1 + 4 + 4 + 2).
    "length_inside_window": ({}, PROMPTS, dict(temperature=0.0, max_tokens=11, ignore_eos=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("layout", OTHER_LAYOUTS)
def test_layout_matches_jax_and_the_flat_step(layout, case):
    sizes, prompts, sp = CASES[case]
    j, p = engines(**sizes, **LAYOUTS[layout])
    got = streams(p, prompts, SamplingParams, **sp)
    assert got == streams(j, prompts, JaxSP, **sp)
    flat = port_engine(p.runner.params, **sizes)
    assert got == streams(flat, prompts, SamplingParams, **sp)
    assert p.scheduler.num_preemptions == j.scheduler.num_preemptions
    if case == "preemption":
        assert p.scheduler.num_preemptions > 0
    # The layout ran the programs it names.
    st = p.stats
    assert st.engine_steps_total == j.stats.engine_steps_total
    assert st.step_dispatches_total == j.stats.step_dispatches_total
    assert st.decode_dispatches_total == j.stats.decode_dispatches_total
    assert st.unified_steps_total == j.stats.unified_steps_total
    if layout != "bucketed":
        assert st.unified_steps_total == 0
    elif case in ("staggered", "subrows"):
        assert st.unified_steps_total > 0


@pytest.mark.parametrize("layout", OTHER_LAYOUTS)
def test_layout_prefix_cache_hit(layout):
    prompt = [5, 5, 1, 2, 3, 4, 8, 8, 6, 6, 2, 2]
    j, p = engines(**LAYOUTS[layout])
    flat = port_engine(p.runner.params)
    sp = dict(temperature=0.0, max_tokens=8)
    for _ in range(2):  # the second run starts from the cached prefix
        got = streams(p, [prompt], SamplingParams, **sp)
        assert got == streams(j, [prompt], JaxSP, **sp)
        assert got == streams(flat, [prompt], SamplingParams, **sp)
    assert p.allocator.hit_ratio() == j.allocator.hit_ratio() > 0


@pytest.mark.parametrize("layout", OTHER_LAYOUTS)
def test_layout_stop_token_inside_a_window(layout):
    """A stop token that falls inside a fused window ends the row there:
    the window's later tokens are discarded, in every layout alike."""
    j, p = engines(**LAYOUTS[layout])
    flat = port_engine(p.runner.params)
    free = streams(flat, PROMPTS, SamplingParams, temperature=0.0, max_tokens=12, ignore_eos=True)
    # Output index 6 of the first prompt: the first token comes from the
    # prefill, windows of 4 cover indices 1-4 and 5-8.
    stop = free[0][6]
    sp = dict(temperature=0.0, max_tokens=12, stop_token_ids=(stop,))
    got = streams(p, PROMPTS, SamplingParams, **sp)
    assert got == streams(j, PROMPTS, JaxSP, **sp)
    assert got == streams(flat, PROMPTS, SamplingParams, **sp)
    assert got[0] == free[0][: free[0].index(stop) + 1] and len(got[0]) <= 7


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_seeded_sampling_matches_jax(layout):
    """temperature 0.8 with a request seed: the port's threefry noise and
    its per-(seed, output index) seeds give the JAX engine's stream."""
    j, p = engines(**LAYOUTS[layout])
    sp = dict(temperature=0.8, max_tokens=10, seed=7, ignore_eos=True)
    got = streams(p, PROMPTS, SamplingParams, **sp)
    assert got == streams(j, PROMPTS, JaxSP, **sp)
    greedy = streams(port_engine(p.runner.params), PROMPTS, SamplingParams,
                     temperature=0.0, max_tokens=10, ignore_eos=True)
    assert got != greedy, "the noise never changed a token"


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_unseeded_sampling_matches_jax(layout):
    """Without a request seed the rows draw from the engine's seed stream,
    which the port advances in JAX's dispatch order and block sizes."""
    j, p = engines(**LAYOUTS[layout])
    sp = dict(temperature=0.9, top_k=20, top_p=0.95, max_tokens=10, ignore_eos=True)
    assert streams(p, PROMPTS, SamplingParams, **sp) == streams(j, PROMPTS, JaxSP, **sp)


HOST_READS = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")


@contextlib.contextmanager
def counting_host_reads():
    """Count calls of the tensor methods that read a value back to the
    host, for as long as the context is open."""
    calls = []
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def counted(name):
        def method(self, *args, **kwargs):
            calls.append(name)
            return saved[name](self, *args, **kwargs)

        return method

    for name in HOST_READS:
        setattr(torch.Tensor, name, counted(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


@pytest.mark.parametrize("model", ["tiny", "tiny-moe", "tiny-mla", "tiny-swa"])
def test_decode_window_loop_reads_nothing_back(model):
    """The K iterations of a fused window are enqueued without one host
    read: the tokens go round on the device until ``wait_step``. The MoE
    layers count their groups on the device and the plain grouped matmul
    loops over the static expert count, so they read nothing either."""
    _, p = engines(model=model, **LAYOUTS["window"])
    windows = []
    orig = p.runner.dispatch_staged_decode

    def guarded(staged):
        with counting_host_reads() as calls:
            pending = orig(staged)
        windows.append((staged.k, list(calls)))
        return pending

    p.runner.dispatch_staged_decode = guarded
    sps = [SamplingParams(temperature=t, max_tokens=9, seed=3, ignore_eos=True)
           for t in (0.0, 0.8, 0.0)]
    p.generate(PROMPTS, sps)
    assert [k for k, _ in windows] == [4, 4]
    assert all(calls == [] for _, calls in windows)


def test_top_k_one_sampling_matches_jax():
    """Sampled rows through temperature, the top-k mask and the noise:
    with top_k = 1 only the argmax survives, so the streams must equal
    JAX's whatever the noise bits."""
    j, p = engines()
    sp = dict(temperature=0.8, top_k=1, max_tokens=8, seed=5)
    assert streams(p, PROMPTS, SamplingParams, **sp) == streams(j, PROMPTS, JaxSP, **sp)


def test_abort_frees_the_requests_pages():
    _, p = engines()
    keep = p.add_request(PROMPTS[0], SamplingParams(temperature=0.0, max_tokens=6))
    drop = p.add_request(PROMPTS[2], SamplingParams(temperature=0.0, max_tokens=6))
    p.step()
    free_before = len(p.allocator._free)
    held = len(next(r for r in p.scheduler.running if r.request_id == drop).block_ids)
    assert p.abort_request(drop) and not p.abort_request("no-such-request")
    assert len(p.allocator._free) == free_before + held
    out = {}
    while p.has_work():
        for o in p.step():
            out.setdefault(o.request_id, []).extend(o.new_token_ids)
    assert set(out) == {keep} and len(out[keep]) == 5


def test_one_readback_per_step():
    _, p = engines()
    calls = []
    orig = p.runner.wait_step

    def counting(prefill, decode, unified):
        assert prefill is None and decode is None
        calls.append(unified.packed.shape)
        return orig(prefill, decode, unified)

    p.runner.wait_step = counting
    p.generate(PROMPTS, SamplingParams(temperature=0.0, max_tokens=4))
    assert len(calls) == p.stats.engine_steps_total
    assert all(shape == (p.runner.flat_rows, 2) for shape in calls)
    # The stream pads only to the 16-token granule.
    assert p.runner.padded_tokens_total < 16 * p.stats.engine_steps_total


@pytest.mark.parametrize("layout", OTHER_LAYOUTS)
def test_one_device_to_host_copy_per_step(layout):
    """Whatever a step dispatches (prefill groups of several Q buckets, a
    decode window, the unified program), it is read back in one copy."""
    _, p = engines(**LAYOUTS[layout])
    prompts = PROMPTS + [[int(x) for x in np.random.default_rng(1).integers(0, 256, size=25)]]
    with counting_host_reads() as calls:
        p.generate(prompts, SamplingParams(temperature=0.0, max_tokens=9, ignore_eos=True))
    assert calls.count("cpu") == p.stats.engine_steps_total
    assert set(calls) <= {"cpu", "numpy"}
    if layout != "bucketed":
        # The first step prefilled four prompts in more than one group.
        assert p.stats.step_dispatches_total > p.stats.engine_steps_total


def test_a_window_never_runs_past_max_model_len():
    """K is capped by the room left to max_model_len, so no row's window
    writes past its last page."""
    _, p = engines(**LAYOUTS["window"])
    prompt = [int(x) for x in np.random.default_rng(2).integers(0, 256, size=121)]
    (got,) = streams(p, [prompt], SamplingParams, temperature=0.0, max_tokens=50, ignore_eos=True)
    assert len(prompt) + len(got) == 128  # max_model_len of the tiny model
    flat = port_engine(p.runner.params)
    assert [got] == streams(flat, [prompt], SamplingParams, temperature=0.0,
                            max_tokens=50, ignore_eos=True)


def test_seeded_sampling_is_reproducible_in_the_port():
    sps = [SamplingParams(temperature=0.9, max_tokens=8, seed=41 + i) for i in range(3)]
    _, a = engines()
    _, b = engines()
    assert list(a.generate(PROMPTS, sps).values()) == list(b.generate(PROMPTS, sps).values())


def test_entry_points_default_to_cuda():
    """Without a GPU, an engine built without device="cpu" raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tcfg.EngineConfig(model=tcfg.tiny_model_config(),
                            cache=tcfg.CacheConfig(num_blocks=8, dtype="float32"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(cfg)
    from llmd_tpu_torch.engine.runner import ModelRunner

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRunner(cfg)


def test_add_request_validates_prompt():
    _, p = engines()
    with pytest.raises(ValueError, match="empty"):
        p.add_request([])
    with pytest.raises(ValueError, match="token ids"):
        p.add_request([1, 2, 256])
    with pytest.raises(ValueError, match="max_model_len"):
        p.add_request([1] * 128)


# MoE and MLA models in the layouts their JAX engine runs: tiny-moe in all
# four; tiny-mla has no flat step (MLA keeps the bucketed layout, as in
# JAX), so its default engine runs the bucketed unified step.
MOE_MLA_LAYOUTS = [("tiny-moe", name) for name in sorted(LAYOUTS)] + [
    ("tiny-mla", "default"), ("tiny-mla", "split"), ("tiny-mla", "window"),
]


@pytest.mark.parametrize("model,layout", MOE_MLA_LAYOUTS)
def test_moe_and_mla_streams_match_jax(model, layout):
    """Greedy and seeded streams equal the JAX engine's; a 16-token budget
    staggers the prompts so later chunks run beside earlier decodes; the
    second pass over one prompt starts from a prefix-cache hit."""
    j, p = engines(model=model, max_batched=16, **LAYOUTS.get(layout, {}))
    prompts = CASES["staggered"][1]
    for sp in (dict(temperature=0.0, max_tokens=8, ignore_eos=True),
               dict(temperature=0.8, max_tokens=8, seed=7, ignore_eos=True)):
        assert streams(p, prompts, SamplingParams, **sp) == streams(j, prompts, JaxSP, **sp)
    prompt = [5, 5, 1, 2, 3, 4, 8, 8, 6, 6, 2, 2]
    for _ in range(2):
        sp = dict(temperature=0.0, max_tokens=6)
        assert streams(p, [prompt], SamplingParams, **sp) == streams(j, [prompt], JaxSP, **sp)
    assert p.allocator.hit_ratio() == j.allocator.hit_ratio() > 0
    st = p.stats
    assert st.engine_steps_total == j.stats.engine_steps_total
    assert st.step_dispatches_total == j.stats.step_dispatches_total
    assert st.decode_dispatches_total == j.stats.decode_dispatches_total
    assert st.unified_steps_total == j.stats.unified_steps_total
    assert p.runner.flat == (model == "tiny-moe" and layout == "flat")
    if model == "tiny-mla":
        assert tuple(p.runner.kv_cache.shape[2:]) == (1, 4, 128)  # one latent row per token
        if layout == "default":
            assert st.unified_steps_total > 0


@pytest.mark.parametrize("name", sorted(registry._REGISTRY))
def test_registry_entry_matches_jax(name):
    """Every entry of the port's registry is the JAX entry, field for field
    (over the port's fields), and derives its defaults alike."""
    port, ref = get_model_config(name), jax_model_config(name)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    over = dict(intermediate_size=96, hidden_size=256)
    port, ref = get_model_config(name, **over), jax_model_config(name, **over)
    assert (port.head_dim, port.moe_intermediate_size) == (ref.head_dim, ref.moe_intermediate_size)


def test_gpt_oss_expert_fields_raise():
    """The gpt-oss expert fields are ported (the JAX values and defaults);
    what the JAX config refuses with them raises alike: a sliding window on
    an MLA model, and layer_types of the wrong length."""
    for field, value in (("moe_activation", "swiglu_oss"), ("router_logit_bias", True),
                         ("swiglu_limit", 5.0)):
        port, ref = tcfg.ModelConfig(**{field: value}), jcfg.ModelConfig(**{field: value})
        assert getattr(port, field) == getattr(ref, field) == value
    for bad in (dict(sliding_window=64, kv_lora_rank=32),
                dict(layer_types=("full_attention",), num_layers=2)):
        with pytest.raises(ValueError):
            jcfg.ModelConfig(**bad)
        with pytest.raises(ValueError):
            tcfg.ModelConfig(**bad)


def long_prompts(window):
    """Prompts around and well past ``window`` tokens, staggered by a
    16-token budget so that later chunks run beside earlier decodes."""
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, size=n).tolist()
            for n in (window + 9, 5, min(2 * window + 3, 100), window - 1)]


def layout_streams_match(j, p, prompts):
    """Greedy and seeded streams equal the JAX engine's, and so do the
    engines' step counters."""
    for sp in (dict(temperature=0.0, max_tokens=10, ignore_eos=True),
               dict(temperature=0.8, max_tokens=10, seed=7, ignore_eos=True)):
        assert streams(p, prompts, SamplingParams, **sp) == streams(j, prompts, JaxSP, **sp)
    for name in ("engine_steps_total", "step_dispatches_total", "decode_dispatches_total",
                 "unified_steps_total"):
        assert getattr(p.stats, name) == getattr(j.stats, name), name
