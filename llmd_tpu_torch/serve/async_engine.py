"""Async bridge between the HTTP front end and the blocking engine loop.

The engine steps on a dedicated thread; request submission and
incremental outputs cross the thread boundary through a lock-guarded
inbox and per-request asyncio queues. The asyncio side never blocks on
device work.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from dataclasses import dataclass
from typing import AsyncIterator

from llmd_tpu_torch.engine.engine import LLMEngine
from llmd_tpu_torch.engine.request import RequestOutput, SamplingParams

log = logging.getLogger(__name__)


@dataclass
class _Pending:
    request_id: str
    prompt_token_ids: list[int]
    sampling: SamplingParams
    priority: int = 0


class RequestFailed(Exception):
    """Client-side error (invalid request); maps to HTTP 400."""


class EngineError(Exception):
    """Internal engine failure (device fault); maps to HTTP 500."""


class AsyncEngine:
    """Runs an LLMEngine on a background thread with an asyncio surface."""

    def __init__(self, engine: LLMEngine) -> None:
        self.engine = engine
        self._lock = threading.Condition()
        self._inbox: list[_Pending] = []  # guarded by _lock
        self._aborts: list[str] = []  # guarded by _lock
        self._stop = False  # guarded by _lock
        # request_id -> asyncio.Queue of RequestOutput | Exception
        self._subs: dict[str, asyncio.Queue] = {}  # guarded by _lock
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None

    def start(self, loop: asyncio.AbstractEventLoop) -> None:
        self._loop = loop
        self._thread = threading.Thread(
            target=self._run, name="llmd-torch-engine", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)

    @property
    def ready(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def submit(
        self,
        request_id: str,
        prompt_token_ids: list[int],
        sampling: SamplingParams,
        priority: int = 0,
    ) -> asyncio.Queue:
        """Queue a request for the engine thread; returns its output queue."""
        q: asyncio.Queue = asyncio.Queue()
        with self._lock:
            if request_id in self._subs:
                raise RequestFailed(f"duplicate request id {request_id}")
            self._subs[request_id] = q
            self._inbox.append(
                _Pending(request_id, prompt_token_ids, sampling, priority)
            )
            self._lock.notify_all()
        return q

    def abort(self, request_id: str) -> None:
        with self._lock:
            self._subs.pop(request_id, None)
            self._aborts.append(request_id)
            self._lock.notify_all()

    async def generate(
        self,
        request_id: str,
        prompt_token_ids: list[int],
        sampling: SamplingParams,
        priority: int = 0,
    ) -> AsyncIterator[RequestOutput]:
        """Async stream of incremental outputs until the request finishes."""
        q = self.submit(request_id, prompt_token_ids, sampling, priority)
        try:
            while True:
                item = await q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
                if item.finished:
                    return
        finally:
            with self._lock:
                # Identity check: only abort OUR registration.
                if self._subs.get(request_id) is q:
                    # Consumer bailed early (client disconnect): abort.
                    self._subs.pop(request_id, None)
                    self._aborts.append(request_id)
                    self._lock.notify_all()

    def _deliver(self, request_id: str, item) -> None:
        with self._lock:
            q = self._subs.get(request_id)
            if q is None:
                return
            if isinstance(item, RequestOutput) and item.finished:
                self._subs.pop(request_id, None)
        self._loop.call_soon_threadsafe(q.put_nowait, item)

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._stop and not (
                    self._inbox or self._aborts or self.engine.has_work()
                ):
                    self._lock.wait()
                if self._stop:
                    return
                pending, self._inbox = self._inbox, []
                aborts, self._aborts = self._aborts, []
            for rid in aborts:
                self.engine.abort_request(rid)
            for p in pending:
                try:
                    self.engine.add_request(
                        p.prompt_token_ids, p.sampling,
                        request_id=p.request_id, priority=p.priority,
                    )
                except ValueError as e:  # validation errors -> caller
                    self._deliver(p.request_id, RequestFailed(str(e)))
            if not self.engine.has_work():
                continue
            try:
                outputs = self.engine.step()
            # The loop must survive a failed step: every subscriber gets
            # the failure as a terminal item (HTTP 500) and its request is
            # dropped, so the step is not retried forever.
            except Exception:
                log.exception("engine step failed")
                with self._lock:
                    subs = list(self._subs)
                for rid in subs:
                    self._deliver(rid, EngineError("engine step failed"))
                    self.engine.abort_request(rid)
                continue
            for out in outputs:
                self._deliver(out.request_id, out)
