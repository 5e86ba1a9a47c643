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


async def test_windowed_split_server_streams_each_token_in_order():
    """``--device cpu --no-unified-step --decode-window 4``: the engine
    delivers up to 4 tokens a step; the stream carries one chunk per token,
    in order, and its text equals the unstreamed completion's and the
    flat engine's."""
    args = serve_main.build_parser().parse_args([
        "--model", "tiny", "--device", "cpu", "--num-blocks", "64", "--seed", "3",
        "--dtype", "float32", "--max-num-seqs", "8", "--max-num-batched-tokens", "32",
        "--no-unified-step", "--decode-window", "4",
    ])
    cfg = serve_main.make_engine_config(args)
    assert (cfg.scheduler.unified_step, cfg.scheduler.decode_window) == (False, 4)
    engine = LLMEngine(cfg, device=args.device)
    windows = []
    dispatch = engine.runner.dispatch_staged_decode
    engine.runner.dispatch_staged_decode = lambda st: (windows.append(st.k), dispatch(st))[1]
    app = build_app(AsyncEngine(engine), ByteTokenizer(), "tiny", cfg.model.max_model_len)
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        body = {"prompt": PROMPT, "max_tokens": 11, "temperature": 0.0, "ignore_eos": True}
        plain = await (await client.post("/v1/completions", json=body)).json()
        r = await client.post("/v1/completions", json={**body, "stream": True})
        assert r.status == 200
        frames = []
        async for raw in r.content:
            line = raw.decode().strip()
            if line.startswith("data: {"):
                frames.append(json.loads(line[len("data: "):]))
    finally:
        await client.close()
    # 1 token from the prefill, then windows of 4, 4 and 4 (2 kept), twice.
    assert windows == [4, 4, 4] * 2
    token_frames, final = frames[:-1], frames[-1]
    assert len(token_frames) == 11 == final["usage"]["completion_tokens"]
    assert final["choices"][0]["finish_reason"] == "length"
    streamed = "".join(f["choices"][0]["text"] for f in frames)
    assert streamed == plain["choices"][0]["text"]
    # The flat engine with the same seeded weights gives the same tokens.
    flat_cfg = serve_main.make_engine_config(serve_main.build_parser().parse_args([
        "--model", "tiny", "--device", "cpu", "--num-blocks", "64", "--seed", "3",
        "--dtype", "float32", "--max-num-seqs", "8", "--max-num-batched-tokens", "32",
    ]))
    assert flat_cfg.scheduler.unified_step and flat_cfg.scheduler.ragged_qlens
    sp = SamplingParams(temperature=0.0, max_tokens=11, ignore_eos=True)
    (tokens,) = LLMEngine(flat_cfg, device="cpu").generate([PROMPT], sp).values()
    detok = Detokenizer(ByteTokenizer(), [])
    detok.feed(tokens, final=True)
    assert detok.emitted == streamed


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
    # The step-layout flags carry the JAX CLI's names and defaults.
    sched = cfg.scheduler
    assert (sched.decode_window, sched.unified_step, sched.ragged_qlens) == (1, True, True)
    args = serve_main.build_parser().parse_args(
        ["--decode-window", "8", "--no-unified-step", "--no-ragged-qlens"])
    sched = serve_main.make_engine_config(args).scheduler
    assert (sched.decode_window, sched.unified_step, sched.ragged_qlens) == (8, False, False)


def test_cli_defaults_to_the_gpu():
    """Without a GPU, the server refuses to start unless --device cpu."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main.main(["--model", "tiny", "--num-blocks", "8"])


async def test_int8_pool_server_answers_a_completion():
    """``--device cpu --kv-cache-dtype int8``: the server's engine keeps its
    KV in the int8 pool, and its completion carries the tokens a twin
    engine on the same flags generates directly."""
    argv = ["--model", "tiny", "--device", "cpu", "--num-blocks", "64", "--seed", "3",
            "--dtype", "float32", "--max-num-seqs", "8", "--max-num-batched-tokens", "32",
            "--kv-cache-dtype", "int8"]
    cfg = serve_main.make_engine_config(serve_main.build_parser().parse_args(argv))
    assert cfg.cache.quantized and cfg.model.dtype == "float32"
    engine = LLMEngine(cfg, device="cpu")
    data, scales = engine.runner.kv_cache
    assert data.dtype == torch.int8 and scales.shape[-1] == 2
    app = build_app(AsyncEngine(engine), ByteTokenizer(), "tiny", cfg.model.max_model_len)
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.post("/v1/completions", json={
            "prompt": PROMPT, "max_tokens": 8, "temperature": 0.0, "ignore_eos": True})
        data_json = await r.json()
    finally:
        await client.close()
    assert r.status == 200 and data_json["usage"]["completion_tokens"] == 8
    sp = SamplingParams(temperature=0.0, max_tokens=8, ignore_eos=True)
    (tokens,) = LLMEngine(cfg, device="cpu").generate([PROMPT], sp).values()
    detok = Detokenizer(ByteTokenizer(), [])
    detok.feed(tokens, final=True)
    assert data_json["choices"][0]["text"] == detok.emitted
    # The default pool holds the weights' dtype; gpt-oss-20b is served by name.
    args = serve_main.build_parser().parse_args(["--model", "gpt-oss-20b"])
    cfg = serve_main.make_engine_config(args)
    assert cfg.cache.dtype == cfg.model.dtype == "bfloat16" and not cfg.cache.quantized
    assert cfg.model.layer_windows[:2] == (128, 0) and cfg.model.attention_sinks
