"""Speculative decoding of the port against the JAX package's on MLA
(tiny-mla: latent pool, MoE, a shared expert): its default engine, the
bucketed unified step (mixed steps verify their drafting rows there,
decode-only steps run the one-shot verify program), and the split engine,
synchronous and async, at verify windows 1 and 4, held as
``test_torch_spec.py`` holds the tiny model (streams token for token
against the JAX speculative engine and the port's engine without it,
counters equal to the JAX scheduler's, drafts accepted, pools empty). A
file of its own so that a parallel run spreads the spec files over four
workers.
"""

import pytest

from test_torch_spec import jax_compile_cache, one_thread, trios  # noqa: F401 (fixtures)
from test_torch_spec_models import case_name, models_case

CASES = [
    ("tiny-mla", "default", 1, False, {}),
    ("tiny-mla", "default", 4, True, {}),
    ("tiny-mla", "split", 4, False, {}),
]


@pytest.mark.parametrize("case", CASES, ids=[case_name(c) for c in CASES])
def test_streams_and_counters_match_jax(trios, case):
    models_case(trios, case)
