"""OpenAI Responses and Conversations API at the engine.

The port's copy of ``llmd_tpu/serve/responses.py``: the router parses
``/v1/responses`` and ``/v1/conversations`` bodies for routing, and these
handlers make the paths servable, so a routed request never gets a 404.

  POST   /v1/responses                  create (streamed or not; ``store``,
                                        ``previous_response_id`` and
                                        ``conversation`` chain turns)
  GET    /v1/responses/{id}             retrieve a stored response
  DELETE /v1/responses/{id}
  POST   /v1/conversations              create a conversation
  GET    /v1/conversations/{id}
  POST   /v1/conversations/{id}/items   append items
  GET    /v1/conversations/{id}/items

State is in memory, LRU-bounded per server (``MAX_STORED`` responses and as
many conversations). Streaming sends the typed Responses SSE events:
``response.created``, ``response.output_text.delta`` and
``response.completed`` (``response.failed`` on an engine error).
"""

from __future__ import annotations

import asyncio
import collections
import json
import time
import uuid

from aiohttp import web

from llmd_tpu_torch.engine.request import SamplingParams
from llmd_tpu_torch.serve import protocol as P
from llmd_tpu_torch.serve.async_engine import AsyncEngine, EngineError, RequestFailed

STORE_KEY = web.AppKey("responses_store", object)
MAX_STORED = 1024


class ResponsesStore:
    """LRU-bounded response + conversation state."""

    def __init__(self, max_items: int = MAX_STORED) -> None:
        self.responses: collections.OrderedDict[str, dict] = collections.OrderedDict()
        # cid -> {"items": [...], "created_at": int, "metadata": dict}
        self.conversations: collections.OrderedDict[str, dict] = collections.OrderedDict()
        self.max_items = max_items

    def put_response(self, resp: dict, history: list[dict]) -> None:
        self.responses[resp["id"]] = {"response": resp, "history": history}
        self.responses.move_to_end(resp["id"])
        while len(self.responses) > self.max_items:
            self.responses.popitem(last=False)

    def get_response(self, rid: str) -> dict | None:
        entry = self.responses.get(rid)
        if entry is not None:
            self.responses.move_to_end(rid)
        return entry

    def new_conversation(self, metadata: dict | None) -> dict:
        cid = f"conv_{uuid.uuid4().hex}"
        self.conversations[cid] = {
            "items": [],
            "created_at": int(time.time()),
            "metadata": metadata or {},
        }
        while len(self.conversations) > self.max_items:
            self.conversations.popitem(last=False)
        return self.conversation_object(cid)

    def conversation_object(self, cid: str) -> dict:
        entry = self.conversations[cid]
        return {
            "id": cid,
            "object": "conversation",
            "created_at": entry["created_at"],
            "metadata": entry["metadata"],
        }


def _input_to_messages(inp) -> list[dict]:
    """Responses `input` (string or item list) -> chat messages."""
    if isinstance(inp, str):
        return [{"role": "user", "content": inp}]
    msgs: list[dict] = []
    for item in inp or []:
        if not isinstance(item, dict):
            continue
        itype = item.get("type", "message")
        if itype != "message":
            continue  # tool calls etc.: not executable by a bare engine
        content = item.get("content")
        if isinstance(content, list):
            content = "".join(
                part.get("text", "")
                for part in content
                if isinstance(part, dict)
                and part.get("type") in ("input_text", "output_text", "text")
            )
        msgs.append({"role": item.get("role", "user"), "content": content or ""})
    return msgs


def _response_object(
    rid: str, model: str, text: str, usage: dict, status: str = "completed"
) -> dict:
    return {
        "id": rid,
        "object": "response",
        "created_at": int(time.time()),
        "status": status,
        "model": model,
        "output": [
            {
                "type": "message",
                "id": f"msg_{uuid.uuid4().hex}",
                "status": status,
                "role": "assistant",
                "content": [
                    {"type": "output_text", "text": text, "annotations": []}
                ],
            }
        ],
        "usage": usage,
    }


def _responses_usage(prompt_tokens: int, output_tokens: int) -> dict:
    return {
        "input_tokens": prompt_tokens,
        "output_tokens": output_tokens,
        "total_tokens": prompt_tokens + output_tokens,
    }


def _event(name: str, data: dict) -> bytes:
    return (
        b"event: " + name.encode()
        + b"\ndata: " + json.dumps(data, separators=(",", ":")).encode()
        + b"\n\n"
    )


def make_handlers(engine_key, tok_key, model_key, maxlen_key):
    """Route handlers bound to the api module's app keys."""

    def _err(status: int, message: str) -> web.Response:
        return web.json_response(P.error_body(message, code=status), status=status)

    async def create_response(request: web.Request) -> web.StreamResponse:
        engine: AsyncEngine = request.app[engine_key]
        tokenizer = request.app[tok_key]
        model = request.app[model_key]
        max_len = request.app[maxlen_key]
        store: ResponsesStore = request.app[STORE_KEY]
        try:
            body = await request.json()
        except json.JSONDecodeError as e:
            return _err(400, f"invalid JSON: {e}")

        # ``context`` is the chainable conversation state (input/output
        # items only). ``instructions`` are per-request and NOT carried
        # over via previous_response_id (OpenAI Responses semantics): they
        # join the prompt below but never the stored history.
        context: list[dict] = []
        instructions = body.get("instructions")
        conv_id = body.get("conversation")
        if isinstance(conv_id, dict):
            conv_id = conv_id.get("id")
        prev = body.get("previous_response_id")
        if conv_id and prev:
            # Both sources would duplicate prior turns in the prompt;
            # OpenAI rejects the combination the same way.
            return _err(
                400,
                "previous_response_id and conversation are mutually exclusive",
            )
        if conv_id:
            conv = store.conversations.get(conv_id)
            if conv is None:
                return _err(404, f"conversation {conv_id!r} not found")
            context.extend(conv["items"])
        if prev:
            entry = store.get_response(prev)
            if entry is None:
                return _err(404, f"previous response {prev!r} not found")
            context.extend(entry["history"])
        new_msgs = _input_to_messages(body.get("input"))
        if not new_msgs and not context:
            return _err(400, "input is required")
        context.extend(new_msgs)
        messages = (
            [{"role": "system", "content": instructions}] if instructions else []
        ) + context

        # Imported here: api.py imports this module for its routes.
        from llmd_tpu_torch.serve.api import Detokenizer, _chat_prompt_ids

        prompt_ids = _chat_prompt_ids(tokenizer, messages)
        if len(prompt_ids) >= max_len:
            return _err(
                400, f"input length {len(prompt_ids)} >= max_model_len {max_len}"
            )
        budget = max_len - len(prompt_ids)
        req_max = body.get("max_output_tokens")
        if req_max is not None and (
            not isinstance(req_max, int)
            or isinstance(req_max, bool)
            or req_max < 1
        ):
            return _err(400, "max_output_tokens must be a positive integer")
        max_tokens = min(req_max if req_max is not None else budget, budget)
        eos = getattr(tokenizer, "eos_token_id", None)
        sampling = SamplingParams(
            temperature=float(body.get("temperature", 1.0)),
            top_p=float(body.get("top_p", 1.0)),
            max_tokens=max_tokens,
            seed=body.get("seed"),
            stop_token_ids=(int(eos),) if eos is not None else (),
        )
        rid = f"resp_{uuid.uuid4().hex}"
        detok = Detokenizer(tokenizer, [])
        stream = bool(body.get("stream"))

        def remember(resp_obj: dict, text: str) -> None:
            if body.get("store", True):
                store.put_response(
                    resp_obj,
                    context + [{"role": "assistant", "content": text}],
                )
            if conv_id is not None and conv_id in store.conversations:
                # Append only THIS request's turns: prepended context from
                # previous_response_id (or instructions) is per-request and
                # must not leak into the conversation's stored items.
                store.conversations[conv_id]["items"].extend(
                    new_msgs + [{"role": "assistant", "content": text}]
                )

        if not stream:
            text = ""
            n_out = 0
            try:
                async for out in engine.generate(rid, prompt_ids, sampling):
                    text += detok.feed(out.new_token_ids, final=out.finished)
                    n_out = out.num_output_tokens
            except RequestFailed as e:
                return _err(400, str(e))
            except EngineError as e:
                return web.json_response(
                    P.error_body(str(e), etype="internal_error", code=500),
                    status=500,
                )
            except (asyncio.CancelledError, ConnectionResetError):
                # Client gone: free the batch slot + KV pages (same abort
                # contract as the completions/chat handlers).
                engine.abort(rid)
                raise
            resp_obj = _response_object(
                rid, model, text, _responses_usage(len(prompt_ids), n_out)
            )
            remember(resp_obj, text)
            return web.json_response(resp_obj)

        sse = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "x-request-id": rid,
            }
        )
        await sse.prepare(request)
        created = _response_object(
            rid, model, "", _responses_usage(len(prompt_ids), 0), "in_progress"
        )
        created["output"] = []
        await sse.write(_event("response.created", {"response": created}))
        text = ""
        n_out = 0
        try:
            async for out in engine.generate(rid, prompt_ids, sampling):
                delta = detok.feed(out.new_token_ids, final=out.finished)
                n_out = out.num_output_tokens
                if delta:
                    text += delta
                    await sse.write(_event(
                        "response.output_text.delta",
                        {"delta": delta, "output_index": 0},
                    ))
        except (RequestFailed, EngineError) as e:
            await sse.write(_event(
                "response.failed",
                {"response": {"id": rid, "status": "failed",
                              "error": {"message": str(e)}}},
            ))
            await sse.write_eof()
            return sse
        except (asyncio.CancelledError, ConnectionResetError):
            engine.abort(rid)
            raise
        resp_obj = _response_object(
            rid, model, text, _responses_usage(len(prompt_ids), n_out)
        )
        remember(resp_obj, text)
        await sse.write(_event("response.completed", {"response": resp_obj}))
        await sse.write_eof()
        return sse

    async def get_response(request: web.Request) -> web.Response:
        store: ResponsesStore = request.app[STORE_KEY]
        entry = store.get_response(request.match_info["rid"])
        if entry is None:
            return _err(404, "response not found")
        return web.json_response(entry["response"])

    async def delete_response(request: web.Request) -> web.Response:
        store: ResponsesStore = request.app[STORE_KEY]
        rid = request.match_info["rid"]
        if store.responses.pop(rid, None) is None:
            return _err(404, "response not found")
        return web.json_response({"id": rid, "object": "response", "deleted": True})

    async def create_conversation(request: web.Request) -> web.Response:
        store: ResponsesStore = request.app[STORE_KEY]
        try:
            body = await request.json() if request.can_read_body else {}
        except json.JSONDecodeError:
            body = {}
        conv = store.new_conversation(body.get("metadata"))
        for item in _input_to_messages(body.get("items")):
            store.conversations[conv["id"]]["items"].append(item)
        return web.json_response(conv)

    async def get_conversation(request: web.Request) -> web.Response:
        store: ResponsesStore = request.app[STORE_KEY]
        cid = request.match_info["cid"]
        if cid not in store.conversations:
            return _err(404, "conversation not found")
        return web.json_response(store.conversation_object(cid))

    async def add_items(request: web.Request) -> web.Response:
        store: ResponsesStore = request.app[STORE_KEY]
        cid = request.match_info["cid"]
        if cid not in store.conversations:
            return _err(404, "conversation not found")
        try:
            body = await request.json()
        except json.JSONDecodeError as e:
            return _err(400, f"invalid JSON: {e}")
        items = _input_to_messages(body.get("items"))
        store.conversations[cid]["items"].extend(items)
        return web.json_response({
            "object": "list",
            "data": [
                {"type": "message", **m}
                for m in store.conversations[cid]["items"]
            ],
        })

    async def list_items(request: web.Request) -> web.Response:
        store: ResponsesStore = request.app[STORE_KEY]
        cid = request.match_info["cid"]
        if cid not in store.conversations:
            return _err(404, "conversation not found")
        return web.json_response({
            "object": "list",
            "data": [
                {"type": "message", **m}
                for m in store.conversations[cid]["items"]
            ],
        })

    return [
        web.post("/v1/responses", create_response),
        web.get("/v1/responses/{rid}", get_response),
        web.delete("/v1/responses/{rid}", delete_response),
        web.post("/v1/conversations", create_conversation),
        web.get("/v1/conversations/{cid}", get_conversation),
        web.post("/v1/conversations/{cid}/items", add_items),
        web.get("/v1/conversations/{cid}/items", list_items),
    ]
