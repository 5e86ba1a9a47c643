"""OpenAI-compatible HTTP API over the port's engine (aiohttp).

The surface llm-d's router, the P/D sidecar and the RL loop drive (the JAX
package's ``llmd_tpu/serve/api.py``):

  POST /v1/completions, /v1/chat/completions   (streamed and not, n in [1, 16])
  POST /vllm.Generation/Generate                (JSON-transcoded, token in and out)
  POST /v1/responses; GET, DELETE /v1/responses/{id}
  POST /v1/conversations; GET /v1/conversations/{id};
  POST, GET /v1/conversations/{id}/items        (``serve/responses.py``)
  GET  /v1/models, /health, /ready
  GET  /metrics                                 (the router's scrape)
  POST /tokenize, /v1/completions/render, /v1/chat/completions/render
  POST /v1/cache/probe                          (the P/D sidecar's question)
  POST /v1/load_lora_adapter, /v1/unload_lora_adapter  (the paged adapter pool)
  POST /admin/pause, /admin/resume, /admin/drain; GET /admin/status

The generate routes take the router's failover resume (``resume_token_ids``
with ``x-llmd-stream-tokens`` and ``x-llmd-resume``), the request deadline
(``x-request-deadline-s``, else ``LLMD_REQUEST_DEADLINE_S``), the batch
tier's ``x-llmd-priority: batch`` header (``_effective_priority``) and
P/D's ``kv_transfer_params`` (completions, chat and Generate: read from
the body, handed to the engine, and a producer's returned on the
unstreamed answer), and continue the caller's ``traceparent`` in an
``engine.generate`` span. A LoRA adapter serves under its own model id
(``_resolve_lora``): the server's fixed name -> slot map
(``--lora-adapters``), or the engine's registry on a paged adapter pool
(``--lora-pool-slots``); with adapters, any other id but the base model's
is a 404.

Not ported yet: ``/v1/embeddings`` and ``/vllm.Generation/Embed``, and the
multimodal encoder parts.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hmac
import json
import os
import re
import time

import pydantic
from aiohttp import web

from llmd_tpu_torch import faults
from llmd_tpu_torch.engine.request import PriorityClass, RequestOutput, SamplingParams
from llmd_tpu_torch.obs.tracing import get_tracer
from llmd_tpu_torch.serve import protocol as P
from llmd_tpu_torch.serve.async_engine import (
    AsyncEngine,
    DeadlineExceeded,
    EngineError,
    RequestFailed,
)
from llmd_tpu_torch.serve.metrics import render_metrics
from llmd_tpu_torch.serve.responses import STORE_KEY, ResponsesStore, make_handlers

ENGINE_KEY = web.AppKey("engine", AsyncEngine)
TOK_KEY = web.AppKey("tokenizer", object)
MODEL_KEY = web.AppKey("model", str)
MAXLEN_KEY = web.AppKey("max_model_len", int)
LORA_KEY = web.AppKey("lora_adapters", dict)

# The router's failover headers (the JAX package's ``llmd_tpu/epp/types.py``
# names): with HDR_STREAM_TOKENS set, every streamed delta frame carries
# its raw ``token_ids``, the history the router replays as
# ``resume_token_ids`` when this stream dies; HDR_RESUME marks such a
# replay leg, which continues an open client stream (no role preamble).
HDR_STREAM_TOKENS = "x-llmd-stream-tokens"
HDR_RESUME = "x-llmd-resume"
# The batch processor's header: "batch" puts a request in the batch tier.
HDR_PRIORITY = "x-llmd-priority"


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
    """An engine exception's HTTP status, for bodies and terminal frames."""
    if isinstance(e, RequestFailed):
        return 400
    if isinstance(e, DeadlineExceeded):
        return 504
    return 500


def _engine_error(e: EngineError) -> web.Response:
    """An unstreamed request's engine failure: 504 ``timeout_error`` for a
    passed deadline, else 500 ``internal_error``."""
    if isinstance(e, DeadlineExceeded):
        return web.json_response(P.error_body(str(e), etype="timeout_error", code=504), status=504)
    return web.json_response(P.error_body(str(e), etype="internal_error", code=500), status=500)


def _request_deadline_s(request: web.Request) -> float | None:
    """The request's deadline in seconds: ``x-request-deadline-s``, else
    ``LLMD_REQUEST_DEADLINE_S``. A malformed or non-positive value means no
    deadline, the reference's rule: a bad header must not refuse a request
    the engine could serve."""
    raw = request.headers.get("x-request-deadline-s") or os.environ.get(
        "LLMD_REQUEST_DEADLINE_S", "")
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if v > 0 else None


def _effective_priority(request: web.Request, body_priority: int) -> int:
    """The request's priority with the batch header folded in (JAX
    ``serve/api.py:264``): ``x-llmd-priority: batch`` clamps it to
    ``PriorityClass.BATCH`` at most, whatever the body says, so a batch
    job cannot enter the interactive band by leaving the body field out;
    another header value leaves the body's integer."""
    if request.headers.get(HDR_PRIORITY, "").strip().lower() == "batch":
        return min(int(body_priority), int(PriorityClass.BATCH))
    return int(body_priority)


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


class UnknownModelError(Exception):
    pass


def _adapter_registry(request: web.Request):
    """The engine's adapter registry on a paged adapter pool, else None."""
    engine = request.app.get(ENGINE_KEY)
    return getattr(getattr(engine, "engine", None), "adapter_registry", None)


def _resolve_lora(request: web.Request, model: str) -> tuple[int, str]:
    """A model id as (adapter slot, adapter name) (JAX ``_resolve_lora``).
    With adapters, an id that is neither the base model nor an adapter
    raises ``UnknownModelError`` (a misspelt adapter must not be served as
    the base model). On a paged pool the engine owns the name -> slot map,
    so the slot is 0 and the name alone goes to ``add_request``."""
    adapters = request.app.get(LORA_KEY) or {}
    if model in adapters:
        return adapters[model], model
    registry = _adapter_registry(request)
    if registry is not None and model and registry.has(model):
        return 0, model
    known = bool(adapters) or (registry is not None and len(registry))
    if known and model and model != request.app[MODEL_KEY]:
        raise UnknownModelError(model)
    return 0, ""


async def handle_models(request: web.Request) -> web.Response:
    entry = {"object": "model", "created": int(time.time()), "owned_by": "llmd-tpu-torch",
             "max_model_len": request.app[MAXLEN_KEY]}
    data = [{"id": request.app[MODEL_KEY], **entry}]
    # Adapters serve under their own ids (vLLM's convention): a paged
    # pool's registry, or the fixed map.
    registry = _adapter_registry(request)
    names = registry.names() if registry is not None else list(request.app.get(LORA_KEY) or {})
    data += [{"id": name, **entry, "parent": request.app[MODEL_KEY]} for name in names]
    return web.json_response({"object": "list", "data": data})


async def handle_metrics(request: web.Request) -> web.Response:
    return web.Response(
        text=render_metrics(request.app[ENGINE_KEY].stats, request.app[MODEL_KEY],
                            request.app.get(LORA_KEY)),
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
                        sampling: SamplingParams, detok: Detokenizer, priority: int,
                        deadline_s: float | None = None, resume_output_tokens: int = 0,
                        kv_transfer_params: dict | None = None,
                        lora: tuple[int, str] = (0, "")):
    """Yields (token, text delta, finish reason or None, last output) per
    token; ``lora`` is the request's (adapter slot, adapter name).

    A fused decode window delivers up to K tokens at once: each is its own
    delta, in order. An empty delta (held back for UTF-8 or a stop string)
    still tells a streaming client that a token exists. A stop string
    aborts the request and finishes the stream with "stop"."""
    async for out in engine.generate(rid, prompt_ids, sampling, priority, deadline_s,
                                     resume_output_tokens, kv_transfer_params, *lora):
        for i, token in enumerate(out.new_token_ids):
            last = out.finished and i == len(out.new_token_ids) - 1
            delta = detok.feed([token], final=last)
            if detok.stopped:
                engine.abort(rid)
                yield token, delta, "stop", out
                return
            yield token, delta, _finish_reason(out) if last else None, out
            if last:
                return
        if out.finished:
            return


def _cut(request: web.Request, engine: AsyncEngine, rid: str) -> bool:
    """The ``serve.stream.cut`` fault site, after a frame: the replica dies
    mid-stream. Its transport is severed without a terminator, which is what
    a crashed engine looks like to the router's read loop."""
    if not faults.fires("serve.stream.cut", rid):
        return False
    engine.abort(rid)
    if request.transport is not None:
        request.transport.close()
    return True


async def _stream_response(
    request: web.Request, engine: AsyncEngine, rid: str, model: str,
    prompt_ids: list[int], sampling: SamplingParams, detok: Detokenizer,
    priority: int, chat: bool, span, deadline_s: float | None = None,
    resume_output_tokens: int = 0, stream_token_ids: bool = False,
    resume_leg: bool = False, kv_transfer_params: dict | None = None,
    lora: tuple[int, str] = (0, ""),
) -> web.StreamResponse:
    resp = await _open_stream(request, rid)
    if chat and not resume_leg:
        # A resume leg continues the client stream the first leg opened, even
        # with an empty history (that leg died between the role preamble and
        # its first token): the preamble went out with the first leg.
        await resp.write(_sse(P.chat_chunk(rid, model, {"role": "assistant"}, None)))
    finish = None
    n_out, cached = resume_output_tokens, 0
    try:
        async for token, delta, finish, out in _token_deltas(
            engine, rid, prompt_ids, sampling, detok, priority, deadline_s,
            resume_output_tokens, kv_transfer_params, lora,
        ):
            n_out, cached = out.num_output_tokens, out.num_cached_tokens
            chunk = _delta_chunk(chat, rid, model, delta)
            if stream_token_ids:
                # The router's resume history; it strips the field before
                # the client sees the frame.
                chunk["token_ids"] = [token]
            await resp.write(_sse(chunk))
            if _cut(request, engine, rid):
                return resp
    except (RequestFailed, EngineError) as e:
        # The stream is committed: a terminal error frame (504 deadline,
        # 500 engine, 400 client), not a hang.
        await resp.write(_sse(P.error_body(str(e), code=_error_status(e))))
        await resp.write(b"data: [DONE]\n\n")
        return resp
    except (asyncio.CancelledError, ConnectionResetError):
        engine.abort(rid)
        raise
    span.set("gen_ai.usage.completion_tokens", n_out)
    span.set("llm_d.cache.hit_tokens", cached)
    final = _final_chunk(chat, rid, model, finish)
    final["usage"] = P.usage_dict(len(prompt_ids) - resume_output_tokens, n_out, cached)
    await resp.write(_sse(final))
    await resp.write(b"data: [DONE]\n\n")
    await resp.write_eof()
    return resp


async def _stream_response_multi(
    request: web.Request, engine: AsyncEngine, rid: str, model: str,
    prompt_ids: list[int], sampling: SamplingParams, tokenizer, stops: list[str],
    n: int, priority: int, chat: bool, span, deadline_s: float | None = None,
    kv_transfer_params: dict | None = None, lora: tuple[int, str] = (0, ""),
) -> web.StreamResponse:
    """SSE with n > 1: one engine stream per choice, their chunks
    interleaved on the response with their choice index; only choice 0
    carries the P/D transfer."""
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
            async for _, delta, finish, out in _token_deltas(
                engine, f"{rid}-{i}", prompt_ids, _choice_sampling(sampling, i),
                detok, priority, deadline_s, 0, kv_transfer_params if i == 0 else None, lora,
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
    span.set("gen_ai.usage.completion_tokens", totals["out"])
    span.set("llm_d.cache.hit_tokens", totals["cached"])
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
                   sampling: SamplingParams, detok: Detokenizer, priority: int,
                   deadline_s: float | None = None, resume_output_tokens: int = 0,
                   kv_transfer_params: dict | None = None, lora: tuple[int, str] = (0, "")):
    """Run to completion; returns (text, finish reason, last output)."""
    finish = None
    final: RequestOutput | None = None
    async for out in engine.generate(rid, prompt_ids, sampling, priority, deadline_s,
                                     resume_output_tokens, kv_transfer_params, *lora):
        detok.feed(out.new_token_ids, final=out.finished)
        final = out
        if detok.stopped:
            engine.abort(rid)
            finish = "stop"
            break
        if out.finished:
            finish = _finish_reason(out)
    return detok.emitted, finish, final


def _validate_resume(resume_ids, max_tokens: int, n: int = 1) -> str | None:
    """None if a resume history is admissible, else the 400 message; the
    caller counts ``stream_resume_failures_total`` on a refusal."""
    if n != 1:
        return "resume_token_ids requires n == 1"
    if not (isinstance(resume_ids, list)
            and all(isinstance(t, int) and 0 <= t for t in resume_ids)):
        return "resume_token_ids must be non-negative token ids"
    if len(resume_ids) > max_tokens:
        return (f"resume history of {len(resume_ids)} tokens exceeds the "
                f"request's max_tokens {max_tokens}")
    return None


def _resume_finished(prompt_len: int, resume_ids: list[int], sampling: SamplingParams,
                     max_len: int) -> str | None:
    """The finish reason the delivered history already reached (the dead
    replica sent the last token, and its finish frame was lost), checked
    in the engine's order: stop token, then length."""
    if not sampling.ignore_eos and resume_ids and resume_ids[-1] in sampling.stop_token_ids:
        return "stop"
    if len(resume_ids) >= sampling.max_tokens:
        return "length"
    if prompt_len + len(resume_ids) >= max_len:
        return "length"
    return None


async def _finish_only_stream(request: web.Request, rid: str, model: str, chat: bool,
                              finish: str, usage: dict) -> web.StreamResponse:
    """A resume leg with nothing left to generate: only the terminal frame,
    usage and [DONE] were lost with the dead replica, so only they are
    sent, and the stitched stream equals an uninterrupted one."""
    resp = await _open_stream(request, rid)
    final = _final_chunk(chat, rid, model, finish)
    final["usage"] = usage
    await resp.write(_sse(final))
    await resp.write(b"data: [DONE]\n\n")
    await resp.write_eof()
    return resp


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
    priority = _effective_priority(request, req.priority)
    rid = request.headers.get("x-request-id") or P.request_id("chatcmpl" if chat else "cmpl")
    stops = P.stop_strings(req.stop)
    # Failover resume: the delivered history becomes committed prefix, and
    # the response carries only the continuation, from the next output
    # position (the same bytes as an uncut stream, greedy or seeded).
    resume_ids = list(req.resume_token_ids or [])
    if resume_ids:
        reject = _validate_resume(resume_ids, max_tokens, req.n)
        if reject is not None:
            engine.stats.stream_resume_failures_total += 1
            return _error(400, reject)
    try:
        lora = _resolve_lora(request, req.model)
    except UnknownModelError:
        return _error(404, f"model {req.model!r} not found")
    if lora[1]:
        model = lora[1]  # the answer names the adapter asked for
    detok = Detokenizer(tokenizer, stops)
    # The server's span continues the caller's (the router's) traceparent.
    span = get_tracer().start_span(
        "engine.generate", traceparent=request.headers.get("traceparent"),
        kind="SPAN_KIND_SERVER",
    )
    span.set("gen_ai.request.model", model)
    span.set("gen_ai.usage.prompt_tokens", len(prompt_ids))
    span.set("llm_d.request.streaming", bool(req.stream))
    deadline_s = _request_deadline_s(request)
    kvp = req.kv_transfer_params
    stream_token_ids = request.headers.get(HDR_STREAM_TOKENS, "") == "1"
    resume_leg = bool(resume_ids) or request.headers.get(HDR_RESUME, "") == "1"
    engine_prompt_ids = prompt_ids
    resume_text_base = 0
    if resume_ids:
        span.set("llm_d.resume.tokens", len(resume_ids))
        fin = _resume_finished(len(prompt_ids), resume_ids, sampling, max_len)
        # A fresh detokenizer fed the history emits the first leg's text
        # exactly, so the deltas continue mid-character and mid-holdback.
        detok.feed(resume_ids, final=fin is not None)
        if fin is None and detok.stopped:
            fin = "stop"  # the history ends on a stop string
        resume_text_base = len(detok.emitted)
        if fin is not None:
            span.end()
            usage = P.usage_dict(len(prompt_ids), len(resume_ids))
            if req.stream:
                return await _finish_only_stream(request, rid, model, chat, fin, usage)
            make_response = P.chat_response if chat else P.completion_response
            return web.json_response(make_response(rid, model, "", fin, usage),
                                     headers={"x-request-id": rid})
        engine_prompt_ids = prompt_ids + resume_ids
    if req.stream:
        try:
            if req.n > 1:
                return await _stream_response_multi(
                    request, engine, rid, model, prompt_ids, sampling, tokenizer,
                    stops, req.n, priority, chat, span, deadline_s, kvp, lora,
                )
            return await _stream_response(
                request, engine, rid, model, engine_prompt_ids, sampling, detok,
                priority, chat, span, deadline_s, len(resume_ids),
                stream_token_ids, resume_leg, kvp, lora,
            )
        except BaseException as e:
            span.error(str(e))
            raise
        finally:
            span.end()
    try:
        if req.n == 1:
            choices = [await _collect(engine, rid, engine_prompt_ids, sampling, detok,
                                      priority, deadline_s, len(resume_ids), kvp, lora)]
        else:
            # n samples share the prompt (and its cached prefix); only
            # choice 0 carries the P/D transfer.
            tasks = [
                asyncio.ensure_future(_collect(
                    engine, f"{rid}-{i}", prompt_ids, _choice_sampling(sampling, i),
                    Detokenizer(tokenizer, stops), priority, deadline_s, 0,
                    kvp if i == 0 else None, lora,
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
        span.error(str(e))
        span.end()
        return _error(400, str(e))
    except EngineError as e:
        span.error(str(e))
        span.end()
        return _engine_error(e)
    except BaseException as e:
        # Cancelled on a client disconnect: the span still ends.
        span.error(str(e) or type(e).__name__)
        span.end()
        raise
    text, finish, final = choices[0]
    # The body carries only the continuation: the client holds the
    # history's text.
    text = text[resume_text_base:]
    completion_tokens = sum(f.num_output_tokens for _, _, f in choices if f)
    cached = final.num_cached_tokens if final else 0
    span.set("gen_ai.usage.completion_tokens", completion_tokens)
    span.set("llm_d.cache.hit_tokens", cached)
    span.end()
    usage = P.usage_dict(len(prompt_ids), completion_tokens, cached)
    make_response = P.chat_response if chat else P.completion_response
    resp = make_response(rid, model, text, finish, usage,
                         final.kv_transfer_params if final else None)
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


def _grpc_sampling(sp: dict, eos: int | None, budget: int) -> tuple[SamplingParams, int]:
    """A Generate body's ``sampling_params`` as the engine's, and its
    integer ``priority``; raises TypeError or ValueError on a bad value."""
    stops = [int(t) for t in (sp.get("stop_token_ids") or [])]
    if eos is not None and not sp.get("ignore_eos", False):
        stops.append(int(eos))
    req_max = sp.get("max_tokens")
    max_tokens = budget if req_max is None else min(int(req_max), budget)
    seed = sp.get("seed")
    sampling = SamplingParams(
        max_tokens=max_tokens,
        temperature=float(sp.get("temperature", 1.0)),
        top_k=int(sp.get("top_k", 0) or 0),
        top_p=float(sp.get("top_p", 1.0)),
        stop_token_ids=tuple(stops),
        ignore_eos=bool(sp.get("ignore_eos", False)),
        seed=None if seed is None else int(seed),
    )
    return sampling, int(sp.get("priority", 0) or 0)


def _grpc_usage(ids: list[int], n_resume: int, final: RequestOutput | None) -> dict:
    """A Generate reply's usage; ``ids`` is the engine's prompt (the
    request's and the resume history), so the history counts as output."""
    return P.usage_dict(len(ids) - n_resume,
                        final.num_output_tokens if final else n_resume,
                        final.num_cached_tokens if final else 0)


async def handle_grpc_generate(request: web.Request) -> web.StreamResponse:
    """vLLM gRPC Generate, JSON-transcoded: token ids in and out, never
    detokenized (clients own the tokenizer). Streamed, one SSE frame of
    ``{"token_ids": [...]}`` an engine output, then a frame with
    ``finish_reason`` and ``usage``. ``model`` names an adapter or the base
    model (``_resolve_lora``); with no adapters the base model serves any
    name, as on the JAX server."""
    engine = request.app[ENGINE_KEY]
    max_len = request.app[MAXLEN_KEY]
    model = request.app[MODEL_KEY]
    try:
        body = await request.json()
    except json.JSONDecodeError as e:
        return _error(400, f"invalid JSON: {e}")
    if not isinstance(body, dict):
        return _error(400, "request body must be a JSON object")
    ids = body.get("prompt_token_ids") or body.get("token_ids") or []
    if not isinstance(ids, list) or not all(isinstance(t, int) for t in ids):
        return _error(400, "prompt_token_ids must be a list of ints")
    if not ids:
        return _error(400, "empty prompt_token_ids")
    if len(ids) >= max_len:
        return _error(400, f"prompt length {len(ids)} >= max_model_len {max_len}")
    sp = body.get("sampling_params") or {}
    if not isinstance(sp, dict):
        return _error(400, "sampling_params must be an object")
    try:
        sampling, priority = _grpc_sampling(
            sp, getattr(request.app[TOK_KEY], "eos_token_id", None), max_len - len(ids))
    except (TypeError, ValueError) as e:
        return _error(400, f"invalid sampling_params: {e}")
    if sampling.max_tokens < 0:
        return _error(400, "max_tokens must be >= 0")
    priority = _effective_priority(request, priority)
    rid = request.headers.get("x-request-id") or P.request_id("grpcgen")
    kvp = body.get("kv_transfer_params")
    deadline_s = _request_deadline_s(request)
    stream = bool(body.get("stream", False))
    try:
        lora = _resolve_lora(request, str(body.get("model") or ""))
    except UnknownModelError as e:
        return _error(404, f"model {e.args[0]!r} not found")
    resume_ids = body.get("resume_token_ids") or []
    if resume_ids:
        reject = _validate_resume(resume_ids, sampling.max_tokens)
        if reject is not None:
            engine.stats.stream_resume_failures_total += 1
            return _error(400, reject)
        fin = _resume_finished(len(ids), resume_ids, sampling, max_len)
        if fin is not None:
            usage = P.usage_dict(len(ids), len(resume_ids))
            if not stream:
                return web.json_response(
                    {"id": rid, "model": model, "token_ids": [], "finish_reason": fin,
                     "usage": usage, "kv_transfer_params": None},
                    headers={"x-request-id": rid})
            resp = await _open_stream(request, rid)
            await resp.write(_sse({"finish_reason": fin, "usage": usage}))
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
            return resp
        ids = ids + resume_ids
    n_resume = len(resume_ids)
    final = None
    if stream:
        resp = await _open_stream(request, rid)
        try:
            async for out in engine.generate(rid, ids, sampling, priority, deadline_s, n_resume, kvp,
                                         *lora):
                final = out
                if out.new_token_ids:
                    await resp.write(_sse({"token_ids": list(out.new_token_ids)}))
                    if _cut(request, engine, rid):
                        return resp
        except (RequestFailed, EngineError) as e:
            await resp.write(_sse(P.error_body(str(e), code=_error_status(e))))
            await resp.write(b"data: [DONE]\n\n")
            return resp
        except (asyncio.CancelledError, ConnectionResetError):
            engine.abort(rid)
            raise
        await resp.write(_sse({"finish_reason": _finish_reason(final) if final else None,
                               "usage": _grpc_usage(ids, n_resume, final)}))
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp
    out_ids: list[int] = []
    try:
        async for out in engine.generate(rid, ids, sampling, priority, deadline_s, n_resume, kvp,
                                         *lora):
            final = out
            out_ids.extend(out.new_token_ids)
    except RequestFailed as e:
        return _error(400, str(e))
    except EngineError as e:
        return _engine_error(e)
    return web.json_response(
        {
            "id": rid,
            "model": model,
            "token_ids": out_ids,
            "finish_reason": _finish_reason(final) if final else None,
            "usage": _grpc_usage(ids, n_resume, final),
            "kv_transfer_params": final.kv_transfer_params if final else None,
        },
        headers={"x-request-id": rid})


# The vLLM dynamic-LoRA routes (JAX ``api.py:1342-1420``): registration is
# unbounded, the paged pool bounds residency; a failed fetch is a counted
# 400, never a wedged batch.
_LORA_NAME_RE = re.compile(r"[A-Za-z0-9._:/-]+")


async def handle_load_lora_adapter(request: web.Request) -> web.Response:
    engine: AsyncEngine = request.app[ENGINE_KEY]
    if _adapter_registry(request) is None:
        return _error(400, "dynamic adapter serving is disabled (start the server with "
                           "--lora-pool-slots)")
    try:
        body = await request.json()
    except json.JSONDecodeError as e:
        return _error(400, f"invalid JSON: {e}")
    if not isinstance(body, dict):
        return _error(400, "request body must be a JSON object")
    name = str(body.get("lora_name") or "")
    source = str(body.get("lora_path") or body.get("lora_url") or body.get("source") or "")
    if not name or not _LORA_NAME_RE.fullmatch(name):
        # Names go into Prometheus label values and model ids.
        return _error(400, f"invalid lora_name {name!r}: use letters, digits, ._:/-")
    if name == request.app[MODEL_KEY]:
        return _error(400, f"lora_name {name!r} shadows the base model id")
    if not source:
        return _error(400, "lora_path (or lora_url / source) is required")
    from llmd_tpu_torch.lora import AdapterFetchError

    try:
        await engine.load_adapter(name, source)
    except (AdapterFetchError, ValueError, RuntimeError) as e:
        return _error(400, str(e))
    return web.json_response({
        "status": "ok", "message": f"Success: LoRA adapter '{name}' added successfully",
        "lora_name": name,
    })


async def handle_unload_lora_adapter(request: web.Request) -> web.Response:
    engine: AsyncEngine = request.app[ENGINE_KEY]
    if _adapter_registry(request) is None:
        return _error(400, "dynamic adapter serving is disabled")
    try:
        body = await request.json()
    except json.JSONDecodeError as e:
        return _error(400, f"invalid JSON: {e}")
    if not isinstance(body, dict):
        return _error(400, "request body must be a JSON object")
    name = str(body.get("lora_name") or "")
    if not name:
        return _error(400, "lora_name is required")
    try:
        await engine.unload_adapter(name)
    except KeyError as e:
        return _error(404, str(e.args[0]) if e.args else name)
    except RuntimeError as e:  # rows in flight reference it: retry later
        return _error(409, str(e))
    return web.json_response({
        "status": "ok", "message": f"Success: LoRA adapter '{name}' removed successfully",
        "lora_name": name,
    })


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
    engine: AsyncEngine, tokenizer, model_name: str, max_model_len: int,
    lora_adapters: dict[str, int] | None = None,
) -> web.Application:
    """The server's app; ``lora_adapters`` is the fixed adapter name ->
    slot map (``--lora-adapters`` without a pool)."""
    app = web.Application()
    app[ENGINE_KEY] = engine
    app[TOK_KEY] = tokenizer
    app[MODEL_KEY] = model_name
    app[MAXLEN_KEY] = max_model_len
    app[LORA_KEY] = dict(lora_adapters or {})
    app[STORE_KEY] = ResponsesStore()
    app.add_routes([
        web.get("/health", handle_health),
        web.get("/ready", handle_ready),
        web.get("/v1/models", handle_models),
        web.get("/metrics", handle_metrics),
        web.post("/tokenize", handle_tokenize),
        web.post("/v1/completions", handle_completions),
        web.post("/v1/chat/completions", handle_chat),
        web.post("/vllm.Generation/Generate", handle_grpc_generate),
        web.post("/v1/completions/render", handle_completions_render),
        web.post("/v1/chat/completions/render", handle_chat_render),
        web.post("/v1/cache/probe", handle_cache_probe),
        web.post("/v1/load_lora_adapter", handle_load_lora_adapter),
        web.post("/v1/unload_lora_adapter", handle_unload_lora_adapter),
        *make_handlers(ENGINE_KEY, TOK_KEY, MODEL_KEY, MAXLEN_KEY),
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
