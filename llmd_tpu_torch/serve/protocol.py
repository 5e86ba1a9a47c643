"""OpenAI-compatible API schema: completions and chat completions.

The JAX package's schema (``llmd_tpu/serve/protocol.py``) without
``kv_transfer_params`` and ``resume_token_ids`` (P/D transfer and stream
resume are not ported yet).
"""

from __future__ import annotations

import time
import uuid
from typing import Union

import pydantic

from llmd_tpu_torch.engine.request import SamplingParams


class _Base(pydantic.BaseModel):
    model_config = pydantic.ConfigDict(extra="allow")


class CompletionRequest(_Base):
    model: str = ""
    prompt: Union[str, list[str], list[int], list[list[int]]] = ""
    max_tokens: int = 16
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    n: int = 1
    stream: bool = False
    stop: Union[str, list[str], None] = None
    seed: int | None = None
    logprobs: int | None = None
    ignore_eos: bool = False
    priority: int = 0
    stop_token_ids: list[int] | None = None


class ChatMessage(_Base):
    role: str = "user"
    content: Union[str, list[dict], None] = ""


class ChatCompletionRequest(_Base):
    model: str = ""
    messages: list[ChatMessage] = pydantic.Field(default_factory=list)
    max_tokens: int | None = None
    max_completion_tokens: int | None = None
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    n: int = 1
    stream: bool = False
    stop: Union[str, list[str], None] = None
    seed: int | None = None
    logprobs: bool = False
    ignore_eos: bool = False
    priority: int = 0
    stop_token_ids: list[int] | None = None


def stop_strings(stop: Union[str, list[str], None]) -> list[str]:
    if stop is None:
        return []
    if isinstance(stop, str):
        return [stop]
    return [s for s in stop if isinstance(s, str)]


def to_sampling(
    req: Union[CompletionRequest, ChatCompletionRequest],
    eos_token_id: int | None,
    max_tokens: int,
) -> SamplingParams:
    stops: list[int] = list(req.stop_token_ids or [])
    if eos_token_id is not None:
        stops.append(int(eos_token_id))
    return SamplingParams(
        max_tokens=max_tokens,
        temperature=req.temperature,
        top_k=req.top_k,
        top_p=req.top_p,
        stop_token_ids=tuple(stops),
        ignore_eos=req.ignore_eos,
        seed=req.seed,
        logprobs=bool(req.logprobs),
    )


def request_id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def usage_dict(prompt_tokens: int, completion_tokens: int, cached: int = 0) -> dict:
    out = {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }
    if cached:
        out["prompt_tokens_details"] = {"cached_tokens": cached}
    return out


def completion_response(
    rid: str, model: str, text: str, finish_reason: str | None, usage: dict
) -> dict:
    return {
        "id": rid,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {"index": 0, "text": text, "logprobs": None,
             "finish_reason": finish_reason}
        ],
        "usage": usage,
    }


def chat_response(
    rid: str, model: str, text: str, finish_reason: str | None, usage: dict
) -> dict:
    return {
        "id": rid,
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": finish_reason,
            }
        ],
        "usage": usage,
    }


def completion_chunk(
    rid: str, model: str, text: str, finish_reason: str | None, index: int = 0
) -> dict:
    return {
        "id": rid,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {"index": index, "text": text, "logprobs": None,
             "finish_reason": finish_reason}
        ],
    }


def chat_chunk(
    rid: str, model: str, delta: dict, finish_reason: str | None, index: int = 0
) -> dict:
    return {
        "id": rid,
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {"index": index, "delta": delta, "finish_reason": finish_reason}
        ],
    }


def error_body(message: str, etype: str = "invalid_request_error", code: int = 400) -> dict:
    return {"error": {"message": message, "type": etype, "code": code}}
