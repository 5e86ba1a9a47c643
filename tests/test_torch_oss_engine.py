"""The port's LLMEngine against the JAX LLMEngine on windowed models with
sinks: identical greedy and seeded streams in every step layout.

tiny-swa (window 64) and gpt-oss in miniature (``tests/test_torch_model.py``
``TINY_OSS``: window 8, sinks, biases, yarn rope, biased clamped-SwiGLU
experts), with prompts around and well past their windows, so that sliding
layers skip pages. Both engines run the same tiny f32 configuration on the
CPU, the port on the JAX engine's parameters (``test_torch_engine.engines``).
A file of its own, beside ``test_torch_engine.py``, so that a parallel run
of the tests spreads the two files' engine compiles over two workers.
"""

import pytest

from test_torch_engine import LAYOUTS, engines, layout_streams_match, long_prompts
from test_torch_model import TINY_OSS

WINDOWED = {"tiny-oss": TINY_OSS, "tiny-swa": "tiny-swa"}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("model", sorted(WINDOWED))
def test_window_and_sink_streams_match_jax(model, layout):
    """tiny-swa and the tiny gpt-oss configuration with prompts longer than
    their windows, in every step layout."""
    cfg = WINDOWED[model]
    window = 8 if model == "tiny-oss" else 64
    j, p = engines(model=cfg, max_batched=16, num_blocks=96, **LAYOUTS[layout])
    assert p.runner.cfg.layer_windows == (window, 0)
    layout_streams_match(j, p, long_prompts(window))
