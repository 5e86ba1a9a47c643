"""The port's LLMEngine against the JAX LLMEngine: identical greedy streams.

Both engines are built from the same configuration on tiny f32 models; the
port loads the JAX engine's own parameters (``engine.runner.params`` ->
numpy -> ``params_from_jax``) and runs on the CPU. The cases are those
``tests/test_ragged_step.py`` pins for the JAX flat step: a mixed batch,
a chunked prefill, recompute preemption and a prefix-cache hit.
"""

import jax
import numpy as np
import pytest
import torch

import llmd_tpu.config as jcfg
import llmd_tpu_torch.config as tcfg
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine import SamplingParams as JaxSP
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.models.llama import params_from_jax

PROMPTS = [
    [1, 5, 9, 13, 2, 8],
    [3, 3, 7, 1],
    [1, 5, 9, 13, 2, 8, 4, 4, 4, 4, 6, 6, 6, 6, 11],
]


def engines(num_blocks=64, page=4, max_batched=32, max_seqs=8):
    kw = dict(
        cache=dict(page_size=page, num_blocks=num_blocks, dtype="float32"),
        scheduler=dict(max_num_seqs=max_seqs, max_num_batched_tokens=max_batched),
    )
    jax_engine = JaxEngine(jcfg.EngineConfig(
        model=jcfg.tiny_model_config(),
        cache=jcfg.CacheConfig(**kw["cache"]),
        scheduler=jcfg.SchedulerConfig(**kw["scheduler"]),
        parallel=jcfg.ParallelConfig(tensor_parallel_size=1),
    ))
    params = params_from_jax(jax.tree.map(np.asarray, jax_engine.runner.params))
    port = LLMEngine(
        tcfg.EngineConfig(
            model=tcfg.tiny_model_config(),
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

    def counting(pending):
        calls.append(pending.packed.shape)
        return orig(pending)

    p.runner.wait_step = counting
    p.generate(PROMPTS, SamplingParams(temperature=0.0, max_tokens=4))
    assert len(calls) == p.stats.engine_steps_total
    assert all(shape == (p.runner.flat_rows, 2) for shape in calls)
    # The stream pads only to the 16-token granule.
    assert p.runner.padded_tokens_total < 16 * p.stats.engine_steps_total


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
