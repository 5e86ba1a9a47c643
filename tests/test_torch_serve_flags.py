"""The port's server flags, HF tokenizer and watchdog against the JAX
server's, on the CPU.

The same argv (the Helm chart's model-server arguments, the registry
defaults, an HF model directory) gives both servers' ``make_engine_config``
the same fields; the port serves a tiny transformers checkpoint saved with
an HF tokenizer (built with ``tokenizers``) from ``--model <dir>`` and
answers transformers' greedy text under ``--served-model-name``; the port's
``load_tokenizer`` equals the JAX one on that tokenizer (ids, decode, chat
template, special ids, vocabulary), with and without a chat template; and
``LLMD_STEP_WATCHDOG_S`` arms both servers' watchdogs alike. The chart's
argv with tracing on parses as the JAX server parses it, ``main`` installs
the tracer its flags name; the chart's decode tier with the KV events and
the store tier's flags give JAX's configuration, and the chart's values of
later items (a TP size above 1, the dense and ep MoE backends) are refused
by name. About 12 s serial.
"""

import dataclasses
import json
import os
import sys

import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

os.environ.setdefault("USE_TF", "0")  # transformers: skip the TensorFlow import
import transformers  # noqa: E402
from tokenizers import Tokenizer, models, pre_tokenizers, processors  # noqa: E402

import llmd_tpu.serve.__main__ as jserve  # noqa: E402
from llmd_tpu.serve.async_engine import AsyncEngine as JaxAsyncEngine  # noqa: E402
from llmd_tpu.serve.tokenizer import load_tokenizer as jax_load_tokenizer  # noqa: E402
from llmd_tpu_torch.serve import __main__ as serve  # noqa: E402
from llmd_tpu_torch.serve.async_engine import AsyncEngine  # noqa: E402
from llmd_tpu_torch.serve.tokenizer import (  # noqa: E402
    ByteTokenizer,
    HFTokenizerWrapper,
    load_tokenizer,
)

import test_torch_serve_surface as surface  # noqa: E402

pytestmark = pytest.mark.anyio

# The chart's model-server arguments that the port takes
# (deploy/charts/llmd-tpu/templates/modelserver.yaml), and the geometry
# flags beside them.
CHART = ["--served-model-name", "llama", "--max-model-len", "4096", "--port", "8200"]
GEOMETRY = ["--block-size", "32", "--num-gpu-blocks-override", "300",
            "--no-enable-prefix-caching", "--tokenizer", "byte", "--weights-path", "/w"]


@pytest.fixture(scope="module")
def anyio_backend():
    return "asyncio"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: faster on these tiny models than many, above
    all while test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_config_dir(tmp_path):
    d = tmp_path / "hf-qwen3"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "architectures": ["Qwen3ForCausalLM"], "vocab_size": 1000, "hidden_size": 96,
        "intermediate_size": 256, "num_hidden_layers": 3, "num_attention_heads": 6,
        "num_key_value_heads": 2, "head_dim": 24, "rope_theta": 1e6,
        "max_position_embeddings": 4096, "torch_dtype": "bfloat16",
    }))
    return str(d)


def assert_same_fields(port, ref, where=""):
    """Every field of the port's dataclass equals the JAX one's."""
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(got):
            assert_same_fields(got, want, f"{where}{f.name}.")
        else:
            assert got == want, f"{where}{f.name}: {got!r} != {want!r}"


@pytest.mark.parametrize("argv", [
    ["--model", "llama-3-8b"],
    ["--model", "llama-3-8b", *CHART],
    ["--model", "qwen3-32b", *CHART, *GEOMETRY],
    ["--model", "gpt-oss-20b", "--kv-swa-ring", "--max-num-batched-tokens", "512"],
    ["--model", "deepseek-v2-lite", "--no-unified-step", "--decode-window", "4", "--seed", "3"],
    ["--model", "HF_DIR", *CHART],
    ["--model", "HF_DIR", "--tokenizer", "/tok", *GEOMETRY[:-2]],
    ["--model", "llama-3-8b", *CHART, "--quantization=int8"],
    ["--model", "HF_DIR", "--quantization", "int8"],
    ["--model", "llama-3-8b", *CHART, "--async-scheduling"],
    ["--model", "llama-3-8b", *CHART, "--speculative-ngram", "--spec-ngram-k", "3",
     "--spec-ngram-min-match", "3", "--spec-verify-window", "2"],
    ["--model", "gpt-oss-20b", "--kv-swa-ring", "--speculative-ngram"],
    ["--model", "llama-3-8b", *CHART, "--no-batch-backfill", "--batch-max-seqs", "3",
     "--batch-kv-watermark", "0.5"],
    ["--model", "llama-3-8b", *CHART, "--batch-backfill", "--batch-max-seqs=0"],
    # The tiered-prefix-cache guide's flags
    # (deploy/guides/tiered-prefix-cache/kustomization.yaml).
    ["--model", "llama-3-8b", *CHART, "--kv-offload-chunks=25000",
     "--kv-offload-fs-dir=/cache/kv-fs"],
    ["--model", "llama-3-8b", "--kv-offload-chunks", "64"],
    ["--model", "llama-3-8b", "--kv-offload-chunks", "0", "--kv-offload-fs-dir", "/x"],
    # The P/D guide's tiers (deploy/charts/llmd-tpu/templates/modelserver.yaml).
    ["--model", "llama-3-8b", *CHART,
     '--kv-transfer-config={"kv_connector":"TPUConnector","kv_role":"kv_consumer"}',
     "--advertised-address=10.0.0.7:8200", "--decode-window", "8"],
    ["--model", "llama-3-8b", *CHART,
     '--kv-transfer-config={"kv_connector":"TPUConnector","kv_role":"kv_producer"}',
     "--advertised-address", "10.0.0.8:8200"],
    ["--model", "deepseek-v2-lite", "--kv-transfer-config",
     '{"kv_role": "kv_both", "transfer_port": 0, "transfer_dtype": "adaptive", '
     '"stream_groups": 1}'],
    ["--model", "llama-3-8b", "--kv-transfer-config", '{"kv_role": "kv_producer", '
     '"transfer_dtype": "int8", "stream_groups": 8, "transfer_port": 9200}'],
    # The chart's whole decode tier (deploy/charts/llmd-tpu/values.yaml),
    # with the events and the store guide's flags
    # (deploy/guides/tiered-prefix-cache-store/kustomization.yaml).
    ["--model", "llama-3-8b", *CHART, "--tensor-parallel-size=1",
     "--advertised-address=10.0.0.7:8200", "--kv-events-endpoint=tcp://0.0.0.0:5556",
     '--kv-transfer-config={"kv_connector":"TPUConnector","kv_role":"kv_consumer"}',
     "--max-num-seqs=64", "--max-num-batched-tokens=8192", "--decode-window=8",
     "--moe-backend=grouped", "--kv-offload-chunks=25000",
     "--kv-store-master-url=http://llmd-kvstore-master:50051",
     "--kv-store-segment-bytes=8589934592", "--kv-store-data-port=9200"],
    ["--model", "deepseek-v2-lite", "--kv-events-endpoint", "tcp://*:0", "--kv-offload-chunks",
     "64", "--kv-store-master-url", "http://store:1", "--kv-publish-policy", "evict-hot",
     "--kv-publish-min-hits", "3", "--kv-store-data-port", "0"],
], ids=["registry-defaults", "chart", "chart-geometry", "ring", "layout", "hf-dir-chart",
        "hf-dir-tokenizer", "int8", "hf-dir-int8", "async", "spec", "spec-ring",
        "batch-flags", "batch-defaults", "offload-guide", "offload-dram", "offload-off",
        "pd-decode", "pd-prefill", "pd-both", "pd-wire", "chart-decode-tier-store",
        "store-evict-hot"])
def test_same_argv_same_engine_config(tmp_path, argv):
    """Both parsers take the argv, and both ``make_engine_config``s give the
    same model, cache, scheduler, seed, weights and tokenizer; the port's
    extra fields keep their defaults. 8,192 is the registry models'
    ``max_model_len``, the checkpoint's ``max_position_embeddings`` a
    directory's; 2,048 pages, pages of 16 and a 2,048-token budget."""
    argv = [hf_config_dir(tmp_path) if a == "HF_DIR" else a for a in argv]
    port_args, jax_args = serve.build_parser().parse_args(argv), jserve.build_parser().parse_args(argv)
    port, ref = serve.make_engine_config(port_args), jserve.make_engine_config(jax_args)
    assert_same_fields(port, ref)
    hf_dir = argv[1].endswith("hf-qwen3")
    assert port.model.max_model_len == (4096 if "--max-model-len" in argv or hf_dir else 8192)
    assert (port_args.served_model_name or port_args.model) == (
        jax_args.served_model_name or jax_args.model)


def test_batch_and_offload_defaults():
    """JAX's defaults: the batch tier on, no cap, watermark 0.85; offload
    off until ``--kv-offload-chunks`` names a page budget."""
    cfg = serve.make_engine_config(serve.build_parser().parse_args([]))
    s = cfg.scheduler
    assert (s.batch_backfill, s.batch_max_seqs, s.batch_kv_watermark) == (True, 0, 0.85)
    assert cfg.offload is None
    cfg = serve.make_engine_config(serve.build_parser().parse_args(
        ["--kv-offload-chunks=25000", "--kv-offload-fs-dir=/cache/kv-fs"]))
    assert (cfg.offload.enabled, cfg.offload.cpu_chunks, cfg.offload.fs_dir) == (
        True, 25000, "/cache/kv-fs")


def test_server_refuses_offload_beside_the_ring(monkeypatch):
    """``--kv-swa-ring`` with ``--kv-offload-chunks`` on a sliding model is
    refused at engine build, as the JAX server refuses it."""
    monkeypatch.setattr(web, "run_app", lambda app, **kw: None)
    with pytest.raises(ValueError, match="kv_swa_ring does not compose with tiered KV offload"):
        serve.main(["--model", "tiny-swa", "--device", "cpu", "--num-blocks", "64",
                    "--skip-warmup", "--kv-swa-ring", "--max-num-batched-tokens", "32",
                    "--kv-offload-chunks", "16"])


def test_defaults_and_aliases():
    args = serve.build_parser().parse_args([])
    cfg = serve.make_engine_config(args)
    assert (cfg.model.name, cfg.model.max_model_len) == ("tiny-llama", 8192)
    assert (cfg.cache.page_size, cfg.cache.num_blocks, cfg.cache.enable_prefix_caching) == (16, 2048, True)
    assert cfg.scheduler.max_num_batched_tokens == 2048
    assert cfg.weights_path is None and cfg.tokenizer_path is None
    assert args.served_model_name is None and args.step_watchdog_s is None
    # --num-blocks is the port's name for --num-gpu-blocks-override.
    for flag in ("--num-blocks", "--num-gpu-blocks-override"):
        assert serve.make_engine_config(serve.build_parser().parse_args([flag, "96"])).cache.num_blocks == 96
    # The pool holds the weights' dtype: the kernels take one dtype for q,
    # k, v and the pool. The JAX server's default is bfloat16 whatever the
    # weights; the two differ only for f32 models such as tiny.
    jcfg = jserve.make_engine_config(jserve.build_parser().parse_args(["--model", "tiny"]))
    assert (cfg.cache.dtype, jcfg.cache.dtype) == ("float32", "bfloat16")
    # The chart's default render parses (one card, the grouped experts);
    # every other TP size and MoE backend is refused by name.
    cfg = serve.make_engine_config(serve.build_parser().parse_args(
        ["--tensor-parallel-size=1", "--moe-backend=grouped", "--kv-events-endpoint=tcp://x:1"]))
    assert (cfg.parallel.tensor_parallel_size, cfg.parallel.moe_backend) == (1, "grouped")
    assert cfg.kv_events_endpoint == "tcp://x:1"
    for flag, item in (("--tensor-parallel-size=2", "item 10"), ("--moe-backend=dense", "item 9"),
                       ("--moe-backend=ep", "items 9 and 10")):
        with pytest.raises(ValueError, match=item):
            serve.make_engine_config(serve.build_parser().parse_args([flag]))


def make_tokenizer(d, template: bool):
    """A word-level HF tokenizer over 64 words, built with ``tokenizers``
    and saved to ``d``; a chat template if ``template``."""
    words = ["<pad>", "<s>", "</s>", "<unk>"] + [f"w{i}" for i in range(56)] + [
        "hello", "world", "user", "assistant"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(single="<s> $A", special_tokens=[("<s>", 1)])
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<s>", eos_token="</s>", pad_token="<pad>",
        unk_token="<unk>")
    if template:
        fast.chat_template = (
            "{% for m in messages %}{{ m['role'] }} {{ m['content'] }} {% endfor %}"
            "{% if add_generation_prompt %}assistant{% endif %}")
    fast.save_pretrained(d)
    return str(d)


@pytest.mark.parametrize("template", [True, False], ids=["template", "no-template"])
def test_hf_tokenizer_matches_jax(tmp_path, template):
    d = make_tokenizer(tmp_path / "tok", template)
    port, ref = load_tokenizer(d), jax_load_tokenizer(d)
    assert isinstance(port, HFTokenizerWrapper)
    for name in ("pad_token_id", "bos_token_id", "eos_token_id", "vocab_size"):
        assert getattr(port, name) == getattr(ref, name), name
    assert (port.bos_token_id, port.eos_token_id, port.vocab_size) == (1, 2, 64)
    for text in ("hello world w3", "w1 w55 nope", ""):
        for special in (True, False):
            assert port.encode(text, special) == ref.encode(text, special)
        ids = port.encode(text)
        for skip in (True, False):
            assert port.decode(ids, skip) == ref.decode(ids, skip)
    messages = [{"role": "user", "content": "hello w1"}]
    for tokenize in (False, True):
        assert port.apply_chat_template(messages, True, tokenize) == ref.apply_chat_template(
            messages, True, tokenize)
    if not template:  # the reference's fallback: the byte tokenizer's text
        assert port.apply_chat_template(messages) == ByteTokenizer().apply_chat_template(messages)


def test_load_tokenizer_byte_and_missing_transformers(monkeypatch, tmp_path):
    assert isinstance(load_tokenizer(None), ByteTokenizer)
    assert isinstance(load_tokenizer("byte"), ByteTokenizer)
    d = make_tokenizer(tmp_path / "tok", True)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        load_tokenizer(d)


async def test_server_from_an_hf_directory(tmp_path, monkeypatch):
    """``--model <dir> --served-model-name``: the architecture, weights and
    tokenizer come from the directory; /v1/models reports the served name
    and the checkpoint's length; a completion is transformers' greedy
    continuation of the tokenized prompt, as text."""
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=96,
        rope_theta=10000.0, tie_word_embeddings=False)).eval()
    d = tmp_path / "ckpt"
    model.save_pretrained(d, safe_serialization=True)
    make_tokenizer(d, True)
    apps = []
    monkeypatch.setattr(web, "run_app", lambda app, **kw: apps.append(app))
    serve.main(["--model", str(d), "--served-model-name", "tiny-hf", "--device", "cpu",
                "--num-gpu-blocks-override", "64", "--max-num-seqs", "4", "--skip-warmup"])
    prompt = "hello world w7 w9 w11"
    ids = load_tokenizer(str(d)).encode(prompt)
    with torch.no_grad():
        out = model.generate(torch.tensor([ids]), max_new_tokens=8, do_sample=False, pad_token_id=0)
    want = load_tokenizer(str(d)).decode(out[0, len(ids):].tolist())
    client = TestClient(TestServer(apps[0]))
    await client.start_server()
    try:
        (entry,) = (await (await client.get("/v1/models")).json())["data"]
        assert (entry["id"], entry["max_model_len"]) == ("tiny-hf", 96)
        r = await client.post("/v1/completions", json={
            "model": "tiny-hf", "prompt": prompt, "max_tokens": 8, "temperature": 0.0,
            "ignore_eos": True})
        body = await r.json()
    finally:
        await client.close()
    assert r.status == 200, body
    assert body["choices"][0]["text"] == want and body["usage"]["prompt_tokens"] == len(ids)


@pytest.mark.parametrize("env, want", [("0.2", 0.2), ("", 0.0), ("soon", 0.0), (None, 0.0)])
def test_watchdog_env_arms_both_servers_alike(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("LLMD_STEP_WATCHDOG_S", raising=False)
    else:
        monkeypatch.setenv("LLMD_STEP_WATCHDOG_S", env)
    assert AsyncEngine(None).watchdog_s == JaxAsyncEngine(None).watchdog_s == want
    # An explicit budget (the port's --step-watchdog-s) wins over the env.
    assert AsyncEngine(None, watchdog_s=1.5).watchdog_s == JaxAsyncEngine(None, watchdog_s=1.5).watchdog_s


async def test_env_armed_watchdog_trips_a_stall(monkeypatch):
    monkeypatch.setenv("LLMD_STEP_WATCHDOG_S", "0.2")
    eng = surface.port_engine()
    await surface.watchdog_trips(eng, AsyncEngine(eng))


# The chart's arguments with tracing.enabled (modelserver.yaml:15-18).
TRACING = ["--otlp-traces-endpoint=http://otel-collector:4318", "--trace-sample-ratio=0.25"]


@pytest.mark.parametrize("argv", [
    ["--model", "llama-3-8b", *CHART, *TRACING],
    ["--model", "llama-3-8b", "--trace-file", "/tmp/spans.jsonl"],
    ["--model", "llama-3-8b"],
], ids=["chart-tracing", "trace-file", "off"])
def test_tracing_flags_parse_as_the_jax_servers(argv):
    """The chart's argv with tracing on parses, and both parsers give the
    same tracing arguments and engine configuration."""
    port_args, jax_args = serve.build_parser().parse_args(argv), jserve.build_parser().parse_args(argv)
    for name in ("otlp_traces_endpoint", "trace_file", "trace_sample_ratio"):
        assert getattr(port_args, name) == getattr(jax_args, name)
    assert port_args.trace_sample_ratio == (0.25 if TRACING[1] in argv else 0.1)
    assert_same_fields(serve.make_engine_config(port_args), jserve.make_engine_config(jax_args))


@pytest.mark.parametrize("flags,exporter", [
    (TRACING, "OtlpHttpExporter"),
    (["--trace-file", "SPANS"], "FileExporter"),
    ([], None),
], ids=["otlp", "file", "off"])
def test_server_configures_tracing_from_its_flags(monkeypatch, tmp_path, flags, exporter):
    """``main`` installs the ``llmd-engine`` tracer under the reference's
    condition (an OTLP endpoint or a trace file), at the flag's ratio."""
    from llmd_tpu_torch.obs import tracing

    monkeypatch.setattr(web, "run_app", lambda app, **kw: None)
    flags = [str(tmp_path / "spans.jsonl") if f == "SPANS" else f for f in flags]
    try:
        serve.main(["--model", "tiny", "--device", "cpu", "--num-blocks", "16", "--dtype",
                    "float32", "--skip-warmup", *flags])
        tracer = tracing.get_tracer()
        if exporter is None:
            assert tracer is tracing.NOOP_TRACER
        else:
            assert type(tracer.exporter).__name__ == exporter
            assert tracer.service_name == "llmd-engine"
            assert tracer.sample_ratio == (0.25 if flags == TRACING else 0.1)
    finally:
        tracing.reset_tracing()


def test_chart_flags_of_later_items_are_still_refused():
    """The chart's values of later items parse as JAX's parser takes them
    and are refused by name when the configuration is built; JAX's
    builds them."""
    for flag, item in (("--tensor-parallel-size=2", "tensor parallelism"),
                       ("--moe-backend=dense", "dense one-hot combine"),
                       ("--moe-backend=ep", "all-to-all expert dispatch")):
        argv = ["--model", "tiny", flag]
        with pytest.raises(ValueError, match=item):
            serve.make_engine_config(serve.build_parser().parse_args(argv))
        jax_args = jserve.build_parser().parse_args(argv)
        assert jserve.make_engine_config(jax_args).parallel.moe_backend == jax_args.moe_backend
