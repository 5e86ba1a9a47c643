"""Async stepping of the port against the JAX engine's and the port's
synchronous engine, on the models beyond ``test_torch_async.py``'s tiny
(whose engines and checks it shares: ``trios``, ``mixed_sampling_case``):
MoE, MLA on its bucketed unified step, tiny-swa in its ring and the tiny
gpt-oss configuration, each on a prompt chunked over a 16-token budget
beside two short ones, greedy, seeded and unseeded at once. A file of its own so that a parallel run
spreads the two files over two workers.
"""

import pytest

from test_torch_async import mixed_sampling_case, one_thread, trios  # noqa: F401 (fixtures)

# (model, layout, ring): the flat step on tiny-moe; the bucketed unified
# step, MLA's default, on tiny-mla; tiny-swa in its ring on the flat step
# and in windows; the tiny gpt-oss configuration (tiny's three layouts are
# in test_torch_async.py).
MATRIX = [("tiny-moe", "flat", False), ("tiny-mla", "default", False),
          ("tiny-swa", "flat", True), ("tiny-swa", "window", True), ("tiny-oss", "flat", False)]


@pytest.mark.parametrize("model,layout,ring", MATRIX,
                         ids=[f"{m}-{lay}{'-ring' if r else ''}" for m, lay, r in MATRIX])
def test_async_models_match_jax_and_sync(trios, model, layout, ring):
    mixed_sampling_case(trios, model, layout, ring)
