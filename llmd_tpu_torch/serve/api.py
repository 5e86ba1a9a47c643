"""OpenAI-compatible HTTP API over the port's engine (aiohttp).

Routes: ``/v1/completions`` (streamed and not), ``/v1/models``,
``/health`` and ``/ready`` — the completion subset of
``llmd_tpu/serve/api.py``.
"""

from __future__ import annotations

import asyncio
import json
import time

import pydantic
from aiohttp import web

from llmd_tpu_torch.engine.request import SamplingParams
from llmd_tpu_torch.serve import protocol as P
from llmd_tpu_torch.serve.async_engine import AsyncEngine, EngineError, RequestFailed

ENGINE_KEY = web.AppKey("engine", AsyncEngine)
TOK_KEY = web.AppKey("tokenizer", object)
MODEL_KEY = web.AppKey("model", str)
MAXLEN_KEY = web.AppKey("max_model_len", int)


class Detokenizer:
    """Incremental detokenization with stop-string scanning.

    Decodes the full output each call and diffs against the previously
    emitted text so multi-byte characters stream correctly. While stop
    strings are configured, the longest possible stop-string prefix is
    held back so a stop match never retracts emitted text; the held-back
    tail is flushed with ``feed([], final=True)``.
    """

    def __init__(self, tokenizer, stops: list[str]) -> None:
        self.tok = tokenizer
        self.stops = stops
        self._holdback = max((len(s) for s in stops), default=1) - 1
        self.ids: list[int] = []
        self.emitted = ""
        self.stopped = False

    def feed(self, new_ids: list[int], final: bool = False) -> str:
        """Returns the text delta to emit; sets .stopped on a stop match."""
        self.ids.extend(new_ids)
        text = self.tok.decode(self.ids)
        if text.endswith("�"):
            # Incomplete UTF-8 sequence: hold back until it completes.
            text = text[: text.rfind("�")]
        if len(text) < len(self.emitted):
            return ""
        idx = min(
            (i for i in (text.find(s) for s in self.stops) if i != -1), default=-1
        )
        if idx != -1:
            self.stopped = True
            text = text[:idx]
            final = True
        if final or not self.stops:
            limit = len(text)
        else:
            limit = max(len(self.emitted), len(text) - self._holdback)
        delta = text[len(self.emitted) : limit]
        self.emitted = text[:limit]
        return delta


def _tokenize_prompt(tokenizer, prompt) -> list[int]:
    if isinstance(prompt, str):
        return tokenizer.encode(prompt)
    if isinstance(prompt, list) and prompt:
        if isinstance(prompt[0], int):
            return list(prompt)
        if len(prompt) != 1:
            raise ValueError("batched prompts unsupported; send one request per prompt")
        if isinstance(prompt[0], str):
            return tokenizer.encode(prompt[0])
        if isinstance(prompt[0], list):
            return list(prompt[0])
    raise ValueError("invalid or empty prompt")


def _error(status: int, message: str) -> web.Response:
    return web.json_response(P.error_body(message, code=status), status=status)


def _sse(data: dict) -> bytes:
    return b"data: " + json.dumps(data, separators=(",", ":")).encode() + b"\n\n"


async def handle_health(request: web.Request) -> web.Response:
    return web.json_response({"status": "ok"})


async def handle_ready(request: web.Request) -> web.Response:
    if request.app[ENGINE_KEY].ready:
        return web.json_response({"status": "ready"})
    return web.json_response({"status": "not-ready"}, status=503)


async def handle_models(request: web.Request) -> web.Response:
    return web.json_response({
        "object": "list",
        "data": [{
            "id": request.app[MODEL_KEY],
            "object": "model",
            "created": int(time.time()),
            "owned_by": "llmd-tpu-torch",
            "max_model_len": request.app[MAXLEN_KEY],
        }],
    })


async def _stream_response(
    request: web.Request, engine: AsyncEngine, rid: str, model: str,
    prompt_ids: list[int], sampling: SamplingParams, detok: Detokenizer,
    priority: int,
) -> web.StreamResponse:
    resp = web.StreamResponse(
        headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "x-request-id": rid,
        }
    )
    await resp.prepare(request)
    finish = None
    n_out = cached = 0
    try:
        async for out in engine.generate(rid, prompt_ids, sampling, priority):
            n_out = out.num_output_tokens
            cached = out.num_cached_tokens
            # A fused decode window delivers up to K tokens at once: each
            # goes out as its own chunk, in order. An empty delta (held
            # back for UTF-8 or a stop string) still tells the client that
            # a token exists.
            for i, token in enumerate(out.new_token_ids):
                last = out.finished and i == len(out.new_token_ids) - 1
                delta = detok.feed([token], final=last)
                if detok.stopped:
                    engine.abort(rid)
                    finish = "stop"
                elif last:
                    finish = out.finish_reason.value if out.finish_reason else None
                await resp.write(_sse(P.completion_chunk(rid, model, delta, None)))
                if detok.stopped or last:
                    break
            if detok.stopped or out.finished:
                break
    except (RequestFailed, EngineError) as e:
        code = 400 if isinstance(e, RequestFailed) else 500
        await resp.write(_sse(P.error_body(str(e), code=code)))
        await resp.write(b"data: [DONE]\n\n")
        return resp
    final = P.completion_chunk(rid, model, "", finish)
    final["usage"] = P.usage_dict(len(prompt_ids), n_out, cached)
    await resp.write(_sse(final))
    await resp.write(b"data: [DONE]\n\n")
    await resp.write_eof()
    return resp


async def handle_completions(request: web.Request) -> web.StreamResponse:
    engine = request.app[ENGINE_KEY]
    tokenizer = request.app[TOK_KEY]
    model = request.app[MODEL_KEY]
    max_len = request.app[MAXLEN_KEY]
    try:
        body = await request.json()
    except json.JSONDecodeError as e:
        return _error(400, f"invalid JSON: {e}")
    try:
        req = P.CompletionRequest(**body)
        prompt_ids = _tokenize_prompt(tokenizer, req.prompt)
    except (ValueError, TypeError, pydantic.ValidationError) as e:
        return _error(400, str(e))
    if len(prompt_ids) >= max_len:
        return _error(400, f"prompt length {len(prompt_ids)} >= max_model_len {max_len}")
    budget = max_len - len(prompt_ids)
    max_tokens = min(req.max_tokens, budget)
    sampling = P.to_sampling(req, getattr(tokenizer, "eos_token_id", None), max_tokens)
    rid = request.headers.get("x-request-id") or P.request_id("cmpl")
    detok = Detokenizer(tokenizer, P.stop_strings(req.stop))
    if req.stream:
        return await _stream_response(
            request, engine, rid, model, prompt_ids, sampling, detok, req.priority
        )
    finish = None
    final = None
    try:
        async for out in engine.generate(rid, prompt_ids, sampling, req.priority):
            detok.feed(out.new_token_ids, final=out.finished)
            final = out
            if detok.stopped:
                engine.abort(rid)
                finish = "stop"
                break
            if out.finished:
                finish = out.finish_reason.value if out.finish_reason else None
    except RequestFailed as e:
        return _error(400, str(e))
    except EngineError as e:
        return web.json_response(
            P.error_body(str(e), etype="internal_error", code=500), status=500
        )
    usage = P.usage_dict(
        len(prompt_ids),
        final.num_output_tokens if final else 0,
        final.num_cached_tokens if final else 0,
    )
    return web.json_response(
        P.completion_response(rid, model, detok.emitted, finish, usage),
        headers={"x-request-id": rid},
    )


def build_app(
    engine: AsyncEngine, tokenizer, model_name: str, max_model_len: int
) -> web.Application:
    app = web.Application()
    app[ENGINE_KEY] = engine
    app[TOK_KEY] = tokenizer
    app[MODEL_KEY] = model_name
    app[MAXLEN_KEY] = max_model_len
    app.add_routes([
        web.get("/health", handle_health),
        web.get("/ready", handle_ready),
        web.get("/v1/models", handle_models),
        web.post("/v1/completions", handle_completions),
    ])

    async def _run_engine(app: web.Application):
        engine.start(asyncio.get_running_loop())
        yield
        engine.stop()

    app.cleanup_ctx.append(_run_engine)
    return app
