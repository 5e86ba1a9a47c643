"""Speculative decoding of the port against the JAX package's beyond
``test_torch_spec.py``'s tiny float model: tiny-swa (at a window of 16) in
its ring, the int8 pool and int8 weights, each in a few layouts, windows
and both pipelines (the
streams token for token against the JAX speculative engine and the port's
engine without it, the speculative counters equal to the JAX scheduler's,
drafts accepted, pools empty, the prefix index holding accepted tokens
only); and the server: a ``--speculative-ngram`` JAX server's ``/metrics``
page and the port's alike after the same requests. MLA is in
``test_torch_spec_mla.py``. Files of their own, so that a parallel run
spreads the spec files over four workers.
"""

import pytest

import test_torch_serve_surface as surface
from test_torch_spec import (  # noqa: F401 (fixtures)
    jax_compile_cache,
    one_thread,
    run_case,
    trios,
)

# (model, layout, window, async, build options)
CASES = [
    ("tiny-swa16", "flat", 4, True, dict(ring=True)),
    ("tiny-swa16", "split", 2, False, dict(ring=True)),
    ("tiny", "flat", 1, True, dict(kv="int8")),
    ("tiny", "split", 4, False, dict(kv="int8")),
    ("tiny", "flat", 4, False, dict(quantization="int8")),
]


def case_name(case) -> str:
    model, layout, window, async_mode, opts = case
    extra = "-".join(f"{k}-{v}" if v is not True else k for k, v in opts.items())
    return "-".join(filter(None, (model, layout, f"w{window}", "async" if async_mode else "sync",
                                  extra)))


def models_case(trios, case):
    model, layout, window, async_mode, opts = case
    p = run_case(trios(model=model, layout=layout, window=window, async_mode=async_mode, **opts))
    if window > 1:
        assert p.scheduler.spec_window_iters > 0
    if opts.get("ring"):
        assert p.runner.kv_swa is not None
        spec = p.runner.swa
        # the ring covers a verify window's provisional writes
        assert spec.chunk_tokens >= 5 * p.config.scheduler.spec_window


@pytest.mark.parametrize("case", CASES, ids=[case_name(c) for c in CASES])
def test_streams_and_counters_match_jax(trios, case):
    models_case(trios, case)


@pytest.fixture
def anyio_backend():
    return "asyncio"


@pytest.mark.anyio
async def test_spec_server_metrics_match_jax():
    """A JAX server and the port's, both with ``--speculative-ngram`` and a
    verify window of 2: after the same completions (periodic prompts, so
    drafts fire) their ``/metrics`` pages are equal but the host-time
    series, and drafts were accepted."""
    sched = dict(speculative_ngram=True, decode_window=2)
    p = await surface.start_pair(*surface.engine_pair(sched=sched))
    try:
        for prompt in ([5, 9, 13, 17] * 6, [40, 41, 40, 41, 42] * 3):
            await p.post("/v1/completions", {"prompt": prompt, **surface.greedy(max_tokens=40)})
        await p.together("/v1/completions",
                         {"prompt": [7, 8, 9] * 5, "n": 3, **surface.greedy(max_tokens=30)}, 3)
        jtext, ttext = await p.get_text("/metrics")
        tm = surface.metric_pages_agree(jtext, ttext)
        assert tm["llmd:spec_accepted_tokens_total"] > 0
        assert tm["llmd:spec_proposed_tokens_total"] >= tm["llmd:spec_accepted_tokens_total"]
    finally:
        for c in p.clients:
            await c.close()
