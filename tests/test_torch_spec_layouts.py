"""Speculative decoding of the port against the JAX package's on the
bucketed unified step (``ragged_qlens=False``) and the split engine
(``unified_step=False``), synchronous and async, at verify windows 1 and 4:
``test_torch_spec.py``'s engine cases (streams token for token against the
JAX speculative engine and the port's engine without it, the speculative
counters equal to the JAX scheduler's, drafts accepted, pools empty, the
prefix index holding accepted tokens only) on the tiny model. A file of its
own so that a parallel run spreads the spec files over four workers.
"""

import pytest

from test_torch_spec import (  # noqa: F401 (fixtures)
    case_id,
    jax_compile_cache,
    one_thread,
    streams_and_counters_case,
    trios,
)

CASES = [(lay, w, a) for lay in ("bucketed", "split") for w in (1, 4) for a in (False, True)]


@pytest.mark.parametrize("layout,window,async_mode", CASES, ids=[case_id(*c) for c in CASES])
def test_streams_and_counters_match_jax(trios, layout, window, async_mode):
    streams_and_counters_case(trios, layout, window, async_mode)
