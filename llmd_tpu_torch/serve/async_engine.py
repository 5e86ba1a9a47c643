"""Async bridge between the HTTP front end and the blocking engine loop.

The engine steps on a dedicated thread; request submission and
incremental outputs cross the thread boundary through a lock-guarded
inbox and per-request asyncio queues. The asyncio side never blocks on
device work.

Besides the requests it carries the engine-coordination surface of the JAX
package's ``AsyncEngine``: pause, resume and drain (the resilience
operator's), readiness, and the step watchdog, which fails in-flight
streams and turns ``/health`` 503 when a step outlives its budget; and the
request deadline (``generate(deadline_s=...)``), which ends a stream with
:class:`DeadlineExceeded` and aborts its engine request.

A P/D consumer's KV fetch runs on a fetch thread, never on the engine
thread or the event loop (JAX ``async_engine.py:320-447``): the pulled
bundle rides to the engine in ``kv_transfer_params["__pulled__"]``; a
group-streamed import is submitted once its first layer group is resident,
with its handle in ``"__stream__"``. The request deadline bounds either
fetch; a bundle that never reaches the engine's apply is released
(``_release_pulled``), so no streamed page leaks.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import logging
import os
import threading
import time
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
    # Failover resume: the prompt's last N tokens are output a dead
    # replica already delivered; generation continues at output position N.
    resume_output_tokens: int = 0
    kv_transfer_params: dict | None = None


def _release_pulled(engine, kv_transfer_params) -> None:
    """Release a fetched bundle that will not be applied
    (``"__pulled__"``), or abandon a stream's handle (``"__stream__"``):
    a streamed import holds pool pages until one of them runs."""
    conn = getattr(engine, "kv_connector", None)
    if conn is None or not kv_transfer_params:
        return
    bundle = kv_transfer_params.get("__pulled__")
    if bundle is not None:
        conn.release_bundle(bundle)
    handle = kv_transfer_params.get("__stream__")
    if handle is not None:
        handle.abandon()


class RequestFailed(Exception):
    """Client-side error (invalid request); maps to HTTP 400."""


class EngineError(Exception):
    """Internal engine failure (device fault); maps to HTTP 500."""


class DeadlineExceeded(EngineError):
    """The request's deadline passed before its stream finished; maps to
    HTTP 504 (unstreamed) or a terminal error frame (streamed)."""


class WatchdogStalled(EngineError):
    """A step outlived the watchdog's budget: the device program is
    wedged. In-flight streams get this as a terminal frame instead of
    hanging."""


class AsyncEngine:
    """Runs an LLMEngine on a background thread with an asyncio surface."""

    def __init__(self, engine: LLMEngine, watchdog_s: float | None = None) -> None:
        self.engine = engine
        # Step watchdog budget in seconds (0: off); None reads
        # LLMD_STEP_WATCHDOG_S, as the reference does (a value that is not
        # a number means off). It arms once a step has completed: the first
        # step builds kernels, the startup probe's business.
        if watchdog_s is None:
            try:
                watchdog_s = float(os.environ.get("LLMD_STEP_WATCHDOG_S", "0") or 0)
            except ValueError:
                watchdog_s = 0.0
        self.watchdog_s = watchdog_s or 0.0
        self._step_started: float | None = None
        self._steps_done = 0
        self._stall_flagged = False
        self._watchdog_task: asyncio.Task | None = None
        # Set by drain(): /ready turns 503 before the engine goes away.
        self.draining = False
        self._lock = threading.Condition()
        self._inbox: list[_Pending] = []  # guarded by _lock
        self._aborts: list[str] = []  # guarded by _lock
        self._stop = False  # guarded by _lock
        # A paused engine does not step: in-flight sequences keep their KV
        # and go on after resume.
        self._paused = False  # guarded by _lock
        # request_id -> asyncio.Queue of RequestOutput | Exception
        self._subs: dict[str, asyncio.Queue] = {}  # guarded by _lock
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        # P/D consumer fetches, off the engine thread and the event loop.
        self._fetch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="llmd-torch-kv-fetch")

    def start(self, loop: asyncio.AbstractEventLoop) -> None:
        self._loop = loop
        self._thread = threading.Thread(
            target=self._run, name="llmd-torch-engine", daemon=True
        )
        self._thread.start()
        if self.watchdog_s:
            self._watchdog_task = loop.create_task(self._watchdog_loop())

    def stop(self) -> None:
        if self._watchdog_task is not None:
            self._watchdog_task.cancel()
            self._watchdog_task = None
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
        self._fetch_pool.shutdown(wait=False, cancel_futures=True)

    @property
    def stats(self):
        return self.engine.stats

    @property
    def stalled(self) -> bool:
        """Whether the current step has outlived the watchdog's budget."""
        if not self.watchdog_s or not self._steps_done:
            return False
        t0 = self._step_started
        return t0 is not None and time.monotonic() - t0 > self.watchdog_s

    @property
    def ready(self) -> bool:
        """Readiness (beside /health's liveness): the engine thread is up,
        stepping within budget, neither paused nor draining. Each flag is
        one atomic read: a probe racing pause() reports either state."""
        return (
            self._thread is not None
            and self._thread.is_alive()
            and not self._paused
            and not self.draining
            and not self.stalled
        )

    async def _watchdog_loop(self) -> None:
        period = max(self.watchdog_s / 4.0, 0.05)
        while True:
            await asyncio.sleep(period)
            if not self.stalled:
                continue
            if not self._stall_flagged:
                self._stall_flagged = True
                self.engine.stats.engine_watchdog_stalls_total += 1
                log.error(
                    "engine step watchdog: step running > %.1fs; failing "
                    "in-flight streams and turning /health 503",
                    self.watchdog_s,
                )
            # Terminal frames for every in-flight stream; their sequences
            # are queued for abort, so a recovering engine does not spend
            # device time on abandoned requests.
            with self._lock:
                subs, self._subs = dict(self._subs), {}
                self._aborts.extend(subs)
                self._lock.notify_all()
            err = WatchdogStalled(
                f"engine step exceeded the {self.watchdog_s}s watchdog "
                "budget; the engine is wedged"
            )
            for q in subs.values():
                q.put_nowait(err)

    @property
    def paused(self) -> bool:
        return self._paused

    def pause(self) -> None:
        with self._lock:
            self._paused = True
            self._lock.notify_all()

    def resume(self) -> None:
        with self._lock:
            self._paused = False
            self.draining = False  # a resumed engine serves again
            self._lock.notify_all()

    async def drain(self, timeout_s: float = 60.0) -> bool:
        """Wait until no request is queued or running; whether it got
        there within ``timeout_s``. /ready turns 503 here, so the gateway
        stops routing before the engine goes away; new submissions are
        still accepted (callers gate them upstream)."""
        self.draining = True
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        while loop.time() < deadline:
            with self._lock:
                idle = not self._inbox and not self.engine.has_work()
            if idle:
                return True
            await asyncio.sleep(0.05)
        return False

    def submit(
        self,
        request_id: str,
        prompt_token_ids: list[int],
        sampling: SamplingParams,
        priority: int = 0,
        resume_output_tokens: int = 0,
        kv_transfer_params: dict | None = None,
    ) -> asyncio.Queue:
        """Queue a request for the engine thread; returns its output queue."""
        q: asyncio.Queue = asyncio.Queue()
        with self._lock:
            if request_id in self._subs:
                raise RequestFailed(f"duplicate request id {request_id}")
            self._subs[request_id] = q
            self._inbox.append(_Pending(
                request_id, prompt_token_ids, sampling, priority, resume_output_tokens,
                kv_transfer_params))
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
        deadline_s: float | None = None,
        resume_output_tokens: int = 0,
        kv_transfer_params: dict | None = None,
    ) -> AsyncIterator[RequestOutput]:
        """Async stream of incremental outputs until the request finishes.

        ``deadline_s`` bounds the whole stream, a P/D fetch included: once
        it passes, the stream raises :class:`DeadlineExceeded` and the
        engine request is aborted (the ``finally`` below), so a starved or
        wedged engine, or a slow producer, slows a request down but never
        holds its caller past its budget."""
        deadline = None if deadline_s is None else time.monotonic() + deadline_s
        kv_transfer_params = await self._fetch_kv(
            prompt_token_ids, kv_transfer_params, deadline, deadline_s)
        try:
            q = self.submit(request_id, prompt_token_ids, sampling, priority,
                            resume_output_tokens, kv_transfer_params)
        except Exception:
            _release_pulled(self.engine, kv_transfer_params)
            raise
        try:
            while True:
                if deadline is None:
                    item = await q.get()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise DeadlineExceeded(f"request deadline of {deadline_s}s exceeded")
                    try:
                        item = await asyncio.wait_for(q.get(), remaining)
                    except asyncio.TimeoutError:
                        raise DeadlineExceeded(
                            f"request deadline of {deadline_s}s exceeded") from None
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

    async def _fetch_kv(self, prompt_token_ids: list[int], params: dict | None,
                        deadline: float | None, deadline_s: float | None) -> dict | None:
        """A P/D consumer's fetch, on the fetch pool: the params to submit
        (with ``"__stream__"`` or ``"__pulled__"``), or ``params`` as they
        are when the engine imports nothing."""
        conn = getattr(self.engine, "kv_connector", None)
        if conn is None or not conn.wants_import(params):
            return params
        remaining = None if deadline is None else max(deadline - time.monotonic(), 0.001)
        if conn.streaming_import(params):
            # Submitted once group 0 is resident; the engine parks the
            # request until the stream resolves.
            handle = conn.make_stream_handle(params)
            loop = asyncio.get_running_loop()
            admittable = asyncio.Event()
            handle.on_first_group = functools.partial(loop.call_soon_threadsafe, admittable.set)

            def fetch_streamed() -> None:
                try:
                    conn.fetch_remote_policy(list(prompt_token_ids), params, handle)
                finally:
                    if not handle.done.is_set():
                        handle.fail("streamed fetch died unresolved")

            self._fetch_pool.submit(fetch_streamed)
            try:
                await asyncio.wait_for(admittable.wait(), remaining)
            except asyncio.TimeoutError:
                pass
            except asyncio.CancelledError:
                handle.abandon()
                raise
            if not handle.first_group.is_set():
                # The fetch runs on; abandon() frees its pages when it ends.
                handle.abandon()
                raise DeadlineExceeded(
                    f"request deadline of {deadline_s}s exceeded during remote KV stream")
            return {**params, "__stream__": handle}
        # The concurrent future in hand: cancelling the awaiting task drops
        # only the asyncio wrapper, so the release hangs on the future.
        cfut = self._fetch_pool.submit(conn.fetch_remote_policy, list(prompt_token_ids), params)

        def release(f) -> None:
            try:
                bundle = f.result()
            except BaseException:
                return  # a failed fetch holds nothing
            _release_pulled(self.engine, {"__pulled__": bundle})

        try:
            bundle = await asyncio.wait_for(asyncio.wrap_future(cfut), remaining)
        except asyncio.TimeoutError:
            cfut.add_done_callback(release)
            raise DeadlineExceeded(
                f"request deadline of {deadline_s}s exceeded during remote KV fetch") from None
        except asyncio.CancelledError:
            cfut.add_done_callback(release)
            raise
        except Exception as e:  # KVLoadError under policy 'fail'
            raise EngineError(f"remote KV load failed: {e}") from e
        return {**params, "__pulled__": bundle}

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
                while not self._stop and (
                    self._paused
                    or not (self._inbox or self._aborts or self.engine.has_work())
                ):
                    self._lock.wait()
                if self._stop:
                    # Queued requests die with the loop; their fetched
                    # bundles must not hold pages.
                    for p in self._inbox:
                        _release_pulled(self.engine, p.kv_transfer_params)
                    self._inbox = []
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
                        resume_output_tokens=p.resume_output_tokens,
                        kv_transfer_params=p.kv_transfer_params,
                    )
                except ValueError as e:  # validation errors -> caller
                    _release_pulled(self.engine, p.kv_transfer_params)
                    self._deliver(p.request_id, RequestFailed(str(e)))
            if not self.engine.has_work():
                continue
            try:
                # The watchdog's heartbeat brackets the one blocking call.
                self._step_started = time.monotonic()
                outputs = self.engine.step()
            # The loop must survive a failed step: every subscriber gets
            # the failure as a terminal item (HTTP 500) and its request is
            # dropped, so the step is not retried forever.
            except Exception:
                log.exception("engine step failed")
                # The failed step's tokens never commit: the engine forgets
                # its step in flight first, so the aborts below free the
                # pages of its requests instead of waiting for a commit.
                self.engine.drop_inflight()
                with self._lock:
                    subs = list(self._subs)
                for rid in subs:
                    self._deliver(rid, EngineError("engine step failed"))
                    self.engine.abort_request(rid)
                continue
            finally:
                self._step_started = None
                self._steps_done += 1
                self._stall_flagged = False
            for out in outputs:
                self._deliver(out.request_id, out)
