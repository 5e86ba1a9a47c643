"""The port's OpenAI server over a tiny CPU engine.

``/v1/completions`` (streamed and not) must carry the tokens the port's
``LLMEngine`` generates for the same greedy request: a twin engine with
the same seeded weights runs the request directly, and its tokens,
detokenized, must equal the served text. ``/health``, ``/ready`` and
``/v1/models`` answer, and ``python -m llmd_tpu_torch.serve`` builds its
engine configuration from its flags.
"""

import json

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from llmd_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig, tiny_model_config
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.serve import __main__ as serve_main
from llmd_tpu_torch.serve.api import Detokenizer, build_app
from llmd_tpu_torch.serve.async_engine import AsyncEngine
from llmd_tpu_torch.serve.tokenizer import ByteTokenizer

pytestmark = pytest.mark.anyio

MAX_LEN = 128
PROMPT = [5, 60, 7, 200, 9, 31, 4]


@pytest.fixture
def anyio_backend():
    return "asyncio"


def make_engine() -> LLMEngine:
    cfg = EngineConfig(
        model=tiny_model_config(vocab_size=512, max_model_len=MAX_LEN),
        cache=CacheConfig(page_size=4, num_blocks=64, dtype="float32"),
        scheduler=SchedulerConfig(max_num_seqs=8, max_num_batched_tokens=32),
        seed=3,
    )
    return LLMEngine(cfg, device="cpu")


def expected(prompt, max_tokens):
    """The twin engine's greedy tokens for the request, and their text."""
    sp = SamplingParams(temperature=0.0, max_tokens=max_tokens, ignore_eos=True)
    (tokens,) = make_engine().generate([prompt], sp).values()
    detok = Detokenizer(ByteTokenizer(), [])
    detok.feed(tokens, final=True)
    return tokens, detok.emitted


@pytest.fixture
async def client():
    app = build_app(AsyncEngine(make_engine()), ByteTokenizer(), "tiny", MAX_LEN)
    c = TestClient(TestServer(app))
    await c.start_server()
    yield c
    await c.close()


async def test_health_ready_models(client):
    r = await client.get("/health")
    assert r.status == 200 and (await r.json())["status"] == "ok"
    r = await client.get("/ready")
    assert r.status == 200 and (await r.json())["status"] == "ready"
    data = await (await client.get("/v1/models")).json()
    assert data["data"][0]["id"] == "tiny"
    assert data["data"][0]["max_model_len"] == MAX_LEN


async def test_completion_carries_the_engines_tokens(client):
    tokens, text = expected(PROMPT, 10)
    r = await client.post("/v1/completions", json={
        "prompt": PROMPT, "max_tokens": 10, "temperature": 0.0, "ignore_eos": True,
    })
    data = await r.json()
    assert r.status == 200, data
    assert data["object"] == "text_completion"
    assert data["choices"][0]["text"] == text
    assert data["choices"][0]["finish_reason"] == "length"
    assert data["usage"] == {
        "prompt_tokens": len(PROMPT), "completion_tokens": len(tokens),
        "total_tokens": len(PROMPT) + len(tokens),
    }


async def test_streamed_completion_carries_the_engines_tokens(client):
    prompt = ByteTokenizer().encode("stream me")
    tokens, text = expected(prompt, 8)
    r = await client.post("/v1/completions", json={
        "prompt": "stream me", "max_tokens": 8, "temperature": 0.0,
        "ignore_eos": True, "stream": True,
    })
    assert r.status == 200
    assert r.headers["Content-Type"].startswith("text/event-stream")
    frames, done = [], False
    async for raw in r.content:
        line = raw.decode().strip()
        if line == "data: [DONE]":
            done = True
        elif line.startswith("data: "):
            frames.append(json.loads(line[len("data: "):]))
    assert done and frames
    assert "".join(f["choices"][0]["text"] for f in frames) == text
    assert frames[-1]["choices"][0]["finish_reason"] == "length"
    assert frames[-1]["usage"]["completion_tokens"] == len(tokens) == 8
    assert frames[-1]["usage"]["prompt_tokens"] == len(prompt)


async def test_invalid_requests_are_refused(client):
    r = await client.post("/v1/completions", json={"prompt": [1] * MAX_LEN})
    assert r.status == 400
    r = await client.post("/v1/completions", data=b"{not json")
    assert r.status == 400
    r = await client.post("/v1/completions", json={"prompt": [1, 2, 600], "max_tokens": 2})
    assert r.status == 400  # token id outside the vocabulary


def test_cli_builds_the_engine_configuration():
    args = serve_main.build_parser().parse_args([
        "--model", "llama-3-8b", "--num-blocks", "300", "--max-num-seqs", "16",
        "--max-num-batched-tokens", "512", "--seed", "7", "--dtype", "float16",
        "--port", "8123", "--host", "127.0.0.1",
    ])
    cfg = serve_main.make_engine_config(args)
    assert (cfg.model.name, cfg.model.num_layers, cfg.model.dtype) == ("llama-3-8b", 32, "float16")
    assert cfg.cache.num_blocks == 300 and cfg.cache.dtype == "float16"
    assert (cfg.scheduler.max_num_seqs, cfg.scheduler.max_num_batched_tokens) == (16, 512)
    assert cfg.seed == 7 and args.device == "cuda"


def test_cli_defaults_to_the_gpu():
    """Without a GPU, the server refuses to start unless --device cpu."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main.main(["--model", "tiny", "--num-blocks", "8"])
