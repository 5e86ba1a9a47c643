"""OpenAI-compatible HTTP API over the port's engine (aiohttp).

The surface llm-d's router drives (the JAX package's
``llmd_tpu/serve/api.py``):

  POST /v1/completions, /v1/chat/completions   (streamed and not, n in [1, 16])
  GET  /v1/models, /health, /ready
  GET  /metrics                                 (the router's scrape)
  POST /tokenize, /v1/completions/render, /v1/chat/completions/render
  POST /v1/cache/probe                          (the P/D sidecar's question)
  POST /admin/pause, /admin/resume, /admin/drain; GET /admin/status

Not ported yet: ``/v1/responses``, ``/v1/embeddings``, the
``/vllm.Generation`` routes, the LoRA load routes, the request deadline and
priority headers, and the multimodal encoder parts.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hmac
import json
import os
import time

import pydantic
from aiohttp import web

from llmd_tpu_torch.engine.request import RequestOutput, SamplingParams
from llmd_tpu_torch.serve import protocol as P
from llmd_tpu_torch.serve.async_engine import AsyncEngine, EngineError, RequestFailed
from llmd_tpu_torch.serve.metrics import render_metrics

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


def _chat_prompt_ids(tokenizer, messages: list) -> list[int]:
    """messages: ChatMessage models or plain dicts."""
    msgs = [m.model_dump() if isinstance(m, P.ChatMessage) else m for m in messages]
    return list(tokenizer.apply_chat_template(msgs, add_generation_prompt=True, tokenize=True))


def _error(status: int, message: str) -> web.Response:
    return web.json_response(P.error_body(message, code=status), status=status)


def _error_status(e: BaseException) -> int:
    return 400 if isinstance(e, RequestFailed) else 500


def _sse(data: dict) -> bytes:
    return b"data: " + json.dumps(data, separators=(",", ":")).encode() + b"\n\n"


def _finish_reason(out: RequestOutput) -> str | None:
    return out.finish_reason.value if out.finish_reason else None


async def handle_health(request: web.Request) -> web.Response:
    # Liveness, but a watchdog-stalled engine is dead for serving: 503, so
    # the platform restarts or ejects the pod instead of routing into it.
    engine = request.app[ENGINE_KEY]
    if engine.stalled:
        return web.json_response(
            {"status": "stalled", "watchdog_s": engine.watchdog_s}, status=503
        )
    return web.json_response({"status": "ok"})


async def handle_ready(request: web.Request) -> web.Response:
    """Readiness, the gateway's routing gate: 503 with its reasons while
    paused, draining or stalled."""
    engine = request.app[ENGINE_KEY]
    if engine.ready:
        return web.json_response({"status": "ready"})
    return web.json_response(
        {
            "status": "not-ready",
            "draining": engine.draining,
            "paused": engine.paused,
            "stalled": engine.stalled,
        },
        status=503,
    )


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


async def handle_metrics(request: web.Request) -> web.Response:
    return web.Response(
        text=render_metrics(request.app[ENGINE_KEY].stats, request.app[MODEL_KEY]),
        content_type="text/plain",
    )


async def handle_tokenize(request: web.Request) -> web.Response:
    tokenizer = request.app[TOK_KEY]
    try:
        body = await request.json()
        if "messages" in body:
            ids = _chat_prompt_ids(tokenizer, [P.ChatMessage(**m) for m in body["messages"]])
        else:
            ids = _tokenize_prompt(tokenizer, body.get("prompt", ""))
    except (json.JSONDecodeError, ValueError, TypeError, AttributeError,
            pydantic.ValidationError) as e:
        return _error(400, str(e))
    return web.json_response({"tokens": ids, "count": len(ids)})


async def handle_cache_probe(request: web.Request) -> web.Response:
    """How many leading full pages of this prompt are cached here: the P/D
    sidecar asks before a transfer, so the producer skips pages the
    decode side holds. Takes a completion's ``prompt`` or a chat's
    ``messages``."""
    engine = request.app[ENGINE_KEY].engine
    tokenizer = request.app[TOK_KEY]
    try:
        body = await request.json()
    except json.JSONDecodeError as e:
        return _error(400, f"invalid JSON: {e}")
    try:
        if body.get("messages") is not None:
            ids = _chat_prompt_ids(tokenizer, body["messages"])
        elif body.get("prompt") is not None:
            ids = _tokenize_prompt(tokenizer, body["prompt"])
        else:
            return _error(400, "prompt or messages is required")
    except (ValueError, TypeError, AttributeError) as e:
        return _error(400, str(e))
    page = engine.allocator.page_size
    return web.json_response({
        "cached_full_pages": engine.cached_prefix_pages(ids),
        "page_size": page,
        "num_full_pages": len(ids) // page,
    })


async def handle_completions_render(request: web.Request) -> web.Response:
    """The token ids the engine would see for a completion request."""
    try:
        req = P.CompletionRequest(**await request.json())
        ids = _tokenize_prompt(request.app[TOK_KEY], req.prompt)
    except (ValueError, TypeError) as e:
        return _error(400, str(e))
    return web.json_response({"prompt_token_ids": ids, "model": req.model})


async def handle_chat_render(request: web.Request) -> web.Response:
    """The token ids the engine would see for a chat request."""
    try:
        req = P.ChatCompletionRequest(**await request.json())
        ids = _chat_prompt_ids(request.app[TOK_KEY], req.messages)
    except (ValueError, TypeError) as e:
        return _error(400, str(e))
    return web.json_response({"prompt_token_ids": ids, "model": req.model})


def _choice_sampling(sampling: SamplingParams, i: int) -> SamplingParams:
    """Choice i of an n > 1 request draws from seed + i when seeded."""
    if sampling.seed is None:
        return sampling
    return dataclasses.replace(sampling, seed=sampling.seed + i)


def _delta_chunk(chat: bool, rid: str, model: str, text: str, index: int = 0) -> dict:
    if chat:
        return P.chat_chunk(rid, model, {"content": text}, None, index=index)
    return P.completion_chunk(rid, model, text, None, index=index)


def _final_chunk(chat: bool, rid: str, model: str, finish: str | None, index: int = 0) -> dict:
    if chat:
        return P.chat_chunk(rid, model, {}, finish, index=index)
    return P.completion_chunk(rid, model, "", finish, index=index)


async def _open_stream(request: web.Request, rid: str) -> web.StreamResponse:
    resp = web.StreamResponse(
        headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "x-request-id": rid,
        }
    )
    await resp.prepare(request)
    return resp


async def _token_deltas(engine: AsyncEngine, rid: str, prompt_ids: list[int],
                        sampling: SamplingParams, detok: Detokenizer, priority: int):
    """Yields (text delta, finish reason or None, last output) per token.

    A fused decode window delivers up to K tokens at once: each is its own
    delta, in order. An empty delta (held back for UTF-8 or a stop string)
    still tells a streaming client that a token exists. A stop string
    aborts the request and finishes the stream with "stop"."""
    async for out in engine.generate(rid, prompt_ids, sampling, priority):
        for i, token in enumerate(out.new_token_ids):
            last = out.finished and i == len(out.new_token_ids) - 1
            delta = detok.feed([token], final=last)
            if detok.stopped:
                engine.abort(rid)
                yield delta, "stop", out
                return
            yield delta, _finish_reason(out) if last else None, out
            if last:
                return
        if out.finished:
            return


async def _stream_response(
    request: web.Request, engine: AsyncEngine, rid: str, model: str,
    prompt_ids: list[int], sampling: SamplingParams, detok: Detokenizer,
    priority: int, chat: bool,
) -> web.StreamResponse:
    resp = await _open_stream(request, rid)
    if chat:
        await resp.write(_sse(P.chat_chunk(rid, model, {"role": "assistant"}, None)))
    finish = None
    n_out = cached = 0
    try:
        async for delta, finish, out in _token_deltas(
            engine, rid, prompt_ids, sampling, detok, priority
        ):
            n_out, cached = out.num_output_tokens, out.num_cached_tokens
            await resp.write(_sse(_delta_chunk(chat, rid, model, delta)))
    except (RequestFailed, EngineError) as e:
        # The stream is committed: a terminal error frame, not a hang.
        await resp.write(_sse(P.error_body(str(e), code=_error_status(e))))
        await resp.write(b"data: [DONE]\n\n")
        return resp
    except (asyncio.CancelledError, ConnectionResetError):
        engine.abort(rid)
        raise
    final = _final_chunk(chat, rid, model, finish)
    final["usage"] = P.usage_dict(len(prompt_ids), n_out, cached)
    await resp.write(_sse(final))
    await resp.write(b"data: [DONE]\n\n")
    await resp.write_eof()
    return resp


async def _stream_response_multi(
    request: web.Request, engine: AsyncEngine, rid: str, model: str,
    prompt_ids: list[int], sampling: SamplingParams, tokenizer, stops: list[str],
    n: int, priority: int, chat: bool,
) -> web.StreamResponse:
    """SSE with n > 1: one engine stream per choice, their chunks
    interleaved on the response with their choice index."""
    resp = await _open_stream(request, rid)
    if chat:
        for i in range(n):
            await resp.write(_sse(P.chat_chunk(rid, model, {"role": "assistant"}, None, index=i)))
    queue: asyncio.Queue = asyncio.Queue()
    totals = {"out": 0, "cached": 0}

    async def pump(i: int) -> None:
        detok = Detokenizer(tokenizer, stops)
        try:
            finish = out = None
            async for delta, finish, out in _token_deltas(
                engine, f"{rid}-{i}", prompt_ids, _choice_sampling(sampling, i),
                detok, priority,
            ):
                await queue.put(("delta", i, delta))
            if out is not None:
                totals["out"] += out.num_output_tokens
                totals["cached"] = max(totals["cached"], out.num_cached_tokens)
            await queue.put(("finish", i, finish))
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # Every failure ends as a terminal item, or the consumer below
            # waits for it forever.
            await queue.put(("error", i, e))

    tasks = [asyncio.ensure_future(pump(i)) for i in range(n)]
    done = 0
    try:
        while done < n:
            kind, i, payload = await queue.get()
            if kind == "error":
                await resp.write(_sse(P.error_body(str(payload), code=_error_status(payload))))
                await resp.write(b"data: [DONE]\n\n")
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                return resp
            if kind == "delta":
                chunk = _delta_chunk(chat, rid, model, payload, index=i)
            else:
                done += 1
                chunk = _final_chunk(chat, rid, model, payload, index=i)
            await resp.write(_sse(chunk))
    except (asyncio.CancelledError, ConnectionResetError):
        for i in range(n):
            engine.abort(f"{rid}-{i}")
        for t in tasks:
            t.cancel()
        raise
    await resp.write(_sse({
        "id": rid,
        "object": "chat.completion.chunk" if chat else "text_completion",
        "model": model,
        "choices": [],
        "usage": P.usage_dict(len(prompt_ids), totals["out"], totals["cached"]),
    }))
    await resp.write(b"data: [DONE]\n\n")
    await resp.write_eof()
    return resp


async def _collect(engine: AsyncEngine, rid: str, prompt_ids: list[int],
                   sampling: SamplingParams, detok: Detokenizer, priority: int):
    """Run to completion; returns (text, finish reason, last output)."""
    finish = None
    final: RequestOutput | None = None
    async for out in engine.generate(rid, prompt_ids, sampling, priority):
        detok.feed(out.new_token_ids, final=out.finished)
        final = out
        if detok.stopped:
            engine.abort(rid)
            finish = "stop"
            break
        if out.finished:
            finish = _finish_reason(out)
    return detok.emitted, finish, final


async def _handle_generate(request: web.Request, chat: bool) -> web.StreamResponse:
    """One generate path for /v1/completions and /v1/chat/completions."""
    engine = request.app[ENGINE_KEY]
    tokenizer = request.app[TOK_KEY]
    model = request.app[MODEL_KEY]
    max_len = request.app[MAXLEN_KEY]
    try:
        body = await request.json()
    except json.JSONDecodeError as e:
        return _error(400, f"invalid JSON: {e}")
    try:
        if chat:
            req = P.ChatCompletionRequest(**body)
            prompt_ids = _chat_prompt_ids(tokenizer, req.messages)
            req_max = req.max_completion_tokens or req.max_tokens
        else:
            req = P.CompletionRequest(**body)
            prompt_ids = _tokenize_prompt(tokenizer, req.prompt)
            req_max = req.max_tokens
    except (ValueError, TypeError, AttributeError, pydantic.ValidationError) as e:
        return _error(400, str(e))
    if req.n < 1 or req.n > 16:
        return _error(400, "n must be in [1, 16]")
    if len(prompt_ids) >= max_len:
        return _error(400, f"prompt length {len(prompt_ids)} >= max_model_len {max_len}")
    budget = max_len - len(prompt_ids)
    max_tokens = min(req_max if req_max is not None else budget, budget)
    sampling = P.to_sampling(req, getattr(tokenizer, "eos_token_id", None), max_tokens)
    rid = request.headers.get("x-request-id") or P.request_id("chatcmpl" if chat else "cmpl")
    stops = P.stop_strings(req.stop)
    if req.stream:
        if req.n > 1:
            return await _stream_response_multi(
                request, engine, rid, model, prompt_ids, sampling, tokenizer,
                stops, req.n, req.priority, chat,
            )
        return await _stream_response(
            request, engine, rid, model, prompt_ids, sampling,
            Detokenizer(tokenizer, stops), req.priority, chat,
        )
    try:
        if req.n == 1:
            choices = [await _collect(engine, rid, prompt_ids, sampling,
                                      Detokenizer(tokenizer, stops), req.priority)]
        else:
            # n samples share the prompt (and its cached prefix).
            tasks = [
                asyncio.ensure_future(_collect(
                    engine, f"{rid}-{i}", prompt_ids, _choice_sampling(sampling, i),
                    Detokenizer(tokenizer, stops), req.priority,
                ))
                for i in range(req.n)
            ]
            try:
                choices = list(await asyncio.gather(*tasks))
            except BaseException:
                # First failure: cancel the siblings (which aborts their
                # requests) and drain their exceptions.
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                raise
    except RequestFailed as e:
        return _error(400, str(e))
    except EngineError as e:
        return web.json_response(
            P.error_body(str(e), etype="internal_error", code=500), status=500
        )
    text, finish, final = choices[0]
    usage = P.usage_dict(
        len(prompt_ids),
        sum(f.num_output_tokens for _, _, f in choices if f),
        final.num_cached_tokens if final else 0,
    )
    make_response = P.chat_response if chat else P.completion_response
    resp = make_response(rid, model, text, finish, usage)
    if req.n > 1:
        tmpl = resp["choices"][0]
        resp["choices"] = [
            {
                **tmpl,
                "index": i,
                **({"message": {"role": "assistant", "content": txt}} if chat
                   else {"text": txt}),
                "finish_reason": fin,
            }
            for i, (txt, fin, _) in enumerate(choices)
        ]
    return web.json_response(resp, headers={"x-request-id": rid})


async def handle_completions(request: web.Request) -> web.StreamResponse:
    return await _handle_generate(request, chat=False)


async def handle_chat(request: web.Request) -> web.StreamResponse:
    return await _handle_generate(request, chat=True)


# The engine-coordination surface the resilience operator calls around
# recovery actions. Pausing halts serving, so it is not client-callable:
# with LLMD_ADMIN_TOKEN set a request needs that token (``x-admin-token``
# or a bearer token); without it only loopback peers are served.


def _admin_denied(request: web.Request) -> web.Response | None:
    token = os.environ.get("LLMD_ADMIN_TOKEN", "")
    if token.startswith("REPLACE-ME"):
        # A committed recipe's placeholder is public: worse than no token.
        return _error(403, "placeholder admin token; set a real secret")
    if token:
        given = request.headers.get("x-admin-token", "")
        auth = request.headers.get("authorization", "")
        if auth.lower().startswith("bearer "):
            given = given or auth[7:]
        if hmac.compare_digest(given, token):
            return None
        return _error(403, "admin token required")
    peer = request.transport.get_extra_info("peername") if request.transport else None
    host = peer[0] if isinstance(peer, (tuple, list)) and peer else ""
    if host in ("127.0.0.1", "::1", "::ffff:127.0.0.1"):
        return None
    return _error(403, "admin surface is loopback-only without LLMD_ADMIN_TOKEN")


async def handle_admin_pause(request: web.Request) -> web.Response:
    denied = _admin_denied(request)
    if denied is not None:
        return denied
    request.app[ENGINE_KEY].pause()
    return web.json_response({"paused": True})


async def handle_admin_resume(request: web.Request) -> web.Response:
    denied = _admin_denied(request)
    if denied is not None:
        return denied
    request.app[ENGINE_KEY].resume()
    return web.json_response({"paused": False})


async def handle_admin_drain(request: web.Request) -> web.Response:
    denied = _admin_denied(request)
    if denied is not None:
        return denied
    try:
        timeout_s = float(request.query.get("timeout", 60.0))
    except ValueError:
        return _error(400, "timeout must be a number")
    drained = await request.app[ENGINE_KEY].drain(timeout_s)
    return web.json_response({"drained": drained}, status=200 if drained else 504)


async def handle_admin_status(request: web.Request) -> web.Response:
    denied = _admin_denied(request)
    if denied is not None:
        return denied
    engine = request.app[ENGINE_KEY]
    return web.json_response({
        "paused": engine.paused,
        "running": engine.stats.num_running,
        "waiting": engine.stats.num_waiting,
    })


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
        web.get("/metrics", handle_metrics),
        web.post("/tokenize", handle_tokenize),
        web.post("/v1/completions", handle_completions),
        web.post("/v1/chat/completions", handle_chat),
        web.post("/v1/completions/render", handle_completions_render),
        web.post("/v1/chat/completions/render", handle_chat_render),
        web.post("/v1/cache/probe", handle_cache_probe),
        web.post("/admin/pause", handle_admin_pause),
        web.post("/admin/resume", handle_admin_resume),
        web.post("/admin/drain", handle_admin_drain),
        web.get("/admin/status", handle_admin_status),
    ])

    async def _run_engine(app: web.Application):
        engine.start(asyncio.get_running_loop())
        yield
        engine.stop()

    app.cleanup_ctx.append(_run_engine)
    return app
