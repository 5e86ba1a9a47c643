"""The port's KV events (``engine/kv_cache.py``'s sink, ``events/``) against
the JAX package's, on the CPU.

* Engines: a recording sink on a port engine and one on a JAX engine (the
  port's on the JAX engine's parameters) see the same stream for the same
  requests (stores, a prefix hit, evictions, a clear), with and without
  the host tier's ``TieredEventSink`` (device evictions of host-held pages
  as ``cpu`` stores).
* The wire: one batch of the port's publisher is, frame for frame, the
  bytes JAX's publisher sends (captured at its socket).
* The port's ZMTP PUB socket against libzmq (pyzmq): the JAX package's
  ``KVEventSubscriber`` reads the port's publisher into a ``KVBlockIndex``
  equal to the one it builds from JAX's publisher on the same events, with
  two subscribers, one subscribed to a topic that does not match, one
  closed mid-stream, a lost batch (the subscriber's ``events.drop`` site)
  whose gap makes the subscriber drop its view and resync, and a late
  joiner; subscriptions by 3.1 commands (libzmq's) and 3.0 messages (a raw
  peer's), a queue past its high-water mark dropping, long frames.
* The server builds the publisher from ``--kv-events-endpoint`` with the
  advertised address as its pod.

Every wait has a deadline. About 10 s serial.
"""

import asyncio
import socket
import struct
import time

import jax
import numpy as np
import pytest
import torch
import zmq
from aiohttp import web

import llmd_tpu.config as jcfg
from llmd_tpu import faults as jfaults
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine import SamplingParams as JaxSP
from llmd_tpu.events.index import KVBlockIndex
from llmd_tpu.events.publisher import ZMQEventSink as JaxZMQEventSink
from llmd_tpu.events.subscriber import KVEventSubscriber
import llmd_tpu_torch.config as tcfg
from llmd_tpu_torch.engine import LLMEngine, SamplingParams
from llmd_tpu_torch.events import ZMQEventSink, zmtp
from llmd_tpu_torch.models.llama import params_from_jax
from llmd_tpu_torch.serve.api import ENGINE_KEY

from test_torch_spec import jax_compile_cache, one_thread  # noqa: F401 (module fixtures)

DEADLINE_S = 10.0
POD = "10.0.0.7:8200"


def wait_until(cond, what: str, limit_s: float = DEADLINE_S) -> None:
    end = time.monotonic() + limit_s
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


# --------------------------------------------------------------------- #
# the engines' streams


class Recorder:
    """A sink (either package's allocator and tiered sink take it) that
    keeps every event as the publisher would render it."""

    def __init__(self) -> None:
        self.events: list[tuple] = []
        self.medium = "gpu"

    def blocks_stored(self, hashes, parent, token_ids, medium=None) -> None:
        self.events.append(("BlockStored", [h.hex() for h in hashes],
                            parent.hex() if parent else None, list(token_ids),
                            medium or self.medium))

    def blocks_removed(self, hashes, medium=None) -> None:
        self.events.append(("BlockRemoved", [h.hex() for h in hashes], medium or self.medium))

    def all_cleared(self) -> None:
        self.events.append(("AllBlocksCleared",))


PAGE, BLOCKS, HOST_PAGES, JUNK = 4, 16, 24, 3
PROMPT = [1, 5, 9, 13, 2, 8, 4, 4, 4, 4, 6, 6, 6, 6, 11, 7, 3]


def junk(i: int) -> list[int]:
    return [int(t) for t in np.random.default_rng(i).integers(20, 250, size=22)]


@pytest.fixture(scope="module")
def engines():
    """(JAX, port) engine pairs with recording sinks, without and with the
    host tier; the port's on the JAX engine's parameters."""
    cache = dict(page_size=PAGE, num_blocks=BLOCKS, dtype="float32")
    sched = dict(max_num_seqs=4, max_num_batched_tokens=32)
    pairs, params = {}, None
    for tiered in (False, True):
        jrec, trec = Recorder(), Recorder()
        j = JaxEngine(jcfg.EngineConfig(
            model=jcfg.tiny_model_config(), cache=jcfg.CacheConfig(**cache),
            scheduler=jcfg.SchedulerConfig(**sched),
            offload=jcfg.OffloadConfig(cpu_chunks=HOST_PAGES) if tiered else None),
            event_sink=jrec)
        if params is None:
            params = params_from_jax(jax.tree.map(np.asarray, j.runner.params))
        t = LLMEngine(tcfg.EngineConfig(
            model=tcfg.tiny_model_config(), cache=tcfg.CacheConfig(**cache),
            scheduler=tcfg.SchedulerConfig(**sched),
            offload=tcfg.OffloadConfig(cpu_chunks=HOST_PAGES) if tiered else None),
            params=params, device="cpu", event_sink=trec)
        pairs[tiered] = ((j, JaxSP, jrec), (t, SamplingParams, trec))
    return pairs


def drive(eng, SP) -> list[list[int]]:
    """Stores, a prefix hit, evictions (and host restores when tiered), a
    clear (host tier first, so the clear reaches the sink), and the prompt
    once more."""
    def gen(prompt):
        sp = SP(temperature=0.0, max_tokens=5, ignore_eos=True)
        return next(iter(eng.generate([list(prompt)], sp).values()))

    outs = [gen(PROMPT), gen(PROMPT)]
    for i in range(JUNK):
        outs.append(gen(junk(i)))
    outs.append(gen(PROMPT))
    for i in range(JUNK, JUNK + 4):
        outs.append(gen(junk(i)))
    if eng._host_cache is not None:
        eng._host_cache.clear()
    eng.allocator.clear()
    outs.append(gen(PROMPT))
    return outs


@pytest.mark.parametrize("tiered", [False, True], ids=["device", "tiered"])
def test_engine_event_streams_equal_jax(engines, tiered):
    (j, jsp, jrec), (t, tsp, trec) = engines[tiered]
    assert drive(t, tsp) == drive(j, jsp)
    assert trec.events == jrec.events
    kinds = {e[0] for e in trec.events}
    assert kinds == {"BlockStored", "BlockRemoved", "AllBlocksCleared"}
    # The first page chains on the scheduler's root hash, as JAX's does.
    first = next(e for e in trec.events if e[0] == "BlockStored")
    assert first[2] == b"llmd-root".hex() and first[3] == PROMPT[:PAGE]
    if tiered:
        assert ("cpu" in {e[-1] for e in trec.events if e[0] == "BlockStored"})
        assert t.stats.offload_restores == j.stats.offload_restores > 0


# --------------------------------------------------------------------- #
# the wire


class FrameTap:
    """Stands in for JAX's PUB socket: keeps the frames it is given."""

    def __init__(self) -> None:
        self.sent: list[list[bytes]] = []

    def send_multipart(self, frames, copy=True) -> None:
        self.sent.append([bytes(f) for f in frames])

    def close(self, linger=None) -> None:
        pass


def some_events(sink, k: int) -> None:
    hs = [bytes([k, i]) * 8 for i in range(3)]
    sink.blocks_stored(hs[:2], hs[2], list(range(k, k + 8)))
    sink.blocks_removed(hs[1:])
    if k % 3 == 2:
        sink.all_cleared()


def test_one_batch_is_jax_bytes():
    """The same calls give the same frames: the port's as a libzmq SUB
    receives them from its socket, JAX's as its sink hands them to pyzmq.
    One batch has 300 hashes (frames past 255 bytes take 8-byte sizes)."""
    port = ZMQEventSink("tcp://127.0.0.1:0", pod=POD, flush_interval_s=3600)
    ref = JaxZMQEventSink("tcp://127.0.0.1:0", pod=POD, flush_interval_s=3600)
    ref._sock.close(0)
    ref._sock = tap = FrameTap()
    ctx = zmq.Context.instance()
    sub = ctx.socket(zmq.SUB)
    sub.setsockopt(zmq.LINGER, 0)
    sub.setsockopt(zmq.RCVTIMEO, int(DEADLINE_S * 1000))
    sub.setsockopt_string(zmq.SUBSCRIBE, "kv-events")
    try:
        assert port.endpoint.startswith("tcp://127.0.0.1:") and not port.endpoint.endswith(":0")
        sub.connect(port.endpoint)
        wait_until(lambda: port.subscriber_count() == 1, "the subscription")
        got = []
        for k in range(3):
            for sink in (port, ref):
                some_events(sink, k)
                if k == 2:
                    sink.blocks_removed([i.to_bytes(2, "big") * 8 for i in range(300)])
                sink.flush()
            got.append(sub.recv_multipart())
        assert got == tap.sent and len(got) == 3
        assert [struct.unpack(">Q", f[1])[0] for f in got] == [0, 1, 2]
        assert len(got[2][2]) > 255 and port.dropped == 0
    finally:
        sub.close()
        port.close()
        ref.close()


def probe(sink) -> int:
    """Publish one harmless batch (the removal of a hash nobody holds);
    returns its sequence number."""
    with sink._lock:
        seq = sink._seq
    sink.blocks_removed([b"\xee" * 16])
    sink.flush()
    return seq


def sync(sink, subs, what: str) -> None:
    """Probe until every subscriber of ``subs`` has seen a probe (a SUB's
    subscription reaches the publisher some time after it connects)."""
    end = time.monotonic() + DEADLINE_S
    while True:
        seq = probe(sink)
        try:
            wait_until(lambda: all(s._seqs.get(POD, -1) >= seq for s in subs), what, 0.1)
            return
        except AssertionError:
            if time.monotonic() > end:
                raise


def batch(sink, k: int, subs) -> None:
    """One batch of events, seen by every subscriber of ``subs``."""
    with sink._lock:
        seq = sink._seq
    some_events(sink, k)
    sink.flush()
    wait_until(lambda: all(s._seqs.get(POD, -1) >= seq for s in subs), f"batch {k}")


def index_state(index: KVBlockIndex) -> tuple:
    with index._lock:
        return ({h: dict(p) for h, p in index._blocks.items()},
                {p: list(lru) for p, lru in index._pod_lru.items()})


def subscriber_run(sink) -> dict:
    """One scenario against a publisher: the indexes its subscribers hold
    at the end."""
    s1, s2 = (KVEventSubscriber(KVBlockIndex()) for _ in range(2))
    other = KVEventSubscriber(KVBlockIndex(), topic="other-topic")
    late = None
    try:
        for s in (s1, s2, other):
            s.add_pod(POD, sink.endpoint)
        sync(sink, [s1, s2], "two subscribers")
        batch(sink, 0, [s1, s2])
        batch(sink, 1, [s1, s2])
        s2.close()  # closed mid-stream: the publisher goes on
        batch(sink, 2, [s1])
        # A lost batch: s1 drops it (its sequence stays), so the next one
        # shows the gap, and s1 drops its view of the pod and resyncs.
        jfaults.arm(jfaults.FaultPlan([jfaults.FaultSpec(site="events.drop", times=1)]))
        try:
            with sink._lock:
                lost = sink._seq
            some_events(sink, 3)
            sink.flush()
            wait_until(lambda: jfaults.injected_counts().get("events.drop") == 1, "the drop")
            assert s1._seqs[POD] == lost - 1
        finally:
            jfaults.disarm()
        batch(sink, 4, [s1])
        late = KVEventSubscriber(KVBlockIndex())  # joins after the gap
        late.add_pod(POD, sink.endpoint)
        sync(sink, [late], "the late joiner")
        batch(sink, 5, [s1, late])
        batch(sink, 6, [s1, late])
        assert other._seqs == {}
        return {"s1": index_state(s1.index), "s2": index_state(s2.index),
                "other": index_state(other.index), "late": index_state(late.index)}
    finally:
        for s in (s1, s2, other, late):
            if s is not None:
                s.close()


def test_jax_subscriber_reads_the_port_publisher():
    port = ZMQEventSink("tcp://127.0.0.1:0", pod=POD, flush_interval_s=3600)
    ref = JaxZMQEventSink("tcp://127.0.0.1:0", pod=POD, flush_interval_s=3600)
    try:
        got, want = subscriber_run(port), subscriber_run(ref)
    finally:
        port.close()
        ref.close()
    assert got == want
    # s2 closed after batches 0 and 1; the resync dropped s1's view of
    # batches 0-2, batch 5 cleared the pod, batch 6 stored one page that
    # stayed; the late joiner saw batches 5 and 6; "other" saw nothing.
    page = {k: bytes([k, 0]).hex() * 8 for k in range(7)}
    assert set(got["s2"][0]) == {page[0], page[1]}
    assert set(got["s1"][0]) == set(got["late"][0]) == {page[6]}
    assert got["other"] == ({}, {})


# --------------------------------------------------------------------- #
# the socket: subscription forms, the queue bound, bind forms


def raw_sub(port: int, minor: int):
    """A hand-rolled SUB (``events/zmtp.py``'s framing) speaking ZMTP
    3.``minor``."""
    s = socket.create_connection(("127.0.0.1", port), timeout=DEADLINE_S)
    greeting = bytearray(zmtp.GREETING)
    greeting[11] = minor
    s.sendall(bytes(greeting) + zmtp.ready("SUB"))
    got = b""
    while len(got) < zmtp.GREETING_SIZE:
        chunk = s.recv(4096)
        assert chunk, "the publisher closed the connection"
        got += chunk
    assert zmtp.check_greeting(got[: zmtp.GREETING_SIZE]) == (3, 1)
    parser = zmtp.FrameParser()
    frames = parser.feed(got[zmtp.GREETING_SIZE:])
    return s, parser, frames


def read_message(s, parser, frames: list) -> list[bytes]:
    """The next multipart message (commands skipped)."""
    msg = []
    while True:
        while frames:
            flags, body = frames.pop(0)
            if flags & zmtp.FLAG_COMMAND:
                continue
            msg.append(body)
            if not flags & zmtp.FLAG_MORE:
                return msg
        chunk = s.recv(65536)
        assert chunk, "the publisher closed the connection"
        frames.extend(parser.feed(chunk))


@pytest.mark.parametrize("form", ["3.0 message", "3.1 command"])
def test_subscriptions_filter_by_prefix(form):
    """A peer's subscriptions, in either form, select messages by the
    prefix of their first frame; a cancel takes one back."""
    pub = zmtp.PubSocket()
    port = pub.bind("tcp://127.0.0.1:0")
    s, parser, frames = raw_sub(port, 0 if form.startswith("3.0") else 1)
    try:
        assert any(zmtp.parse_command(b)[0] == b"READY" for f, b in frames if f & zmtp.FLAG_COMMAND)

        def sub(prefix: bytes, on: bool = True) -> None:
            if form.startswith("3.0"):
                s.sendall(zmtp.encode_frame(bytes((int(on),)) + prefix))
            else:
                s.sendall(zmtp.command(b"SUBSCRIBE" if on else b"CANCEL", prefix))

        sub(b"kv")
        wait_until(lambda: pub.subscriber_count(b"kv-events") == 1, "the subscription")
        assert pub.subscriber_count(b"other") == 0
        assert pub.send_multipart([b"other", b"x"]) == 0
        assert pub.send_multipart([b"kv-events", b"\x00" * 8, b"y" * 300]) == 1
        assert read_message(s, parser, frames) == [b"kv-events", b"\x00" * 8, b"y" * 300]
        sub(b"kv", on=False)
        wait_until(lambda: pub.subscriber_count(b"kv-events") == 0, "the cancel")
        assert pub.send_multipart([b"kv-events", b"z"]) == 0
    finally:
        s.close()
        pub.close()


def test_a_full_queue_drops_and_the_sender_never_waits():
    """A peer that reads nothing: its queue takes ``hwm`` messages and the
    rest are dropped, each send returning at once; the peer, reading at
    last, gets every message that was not dropped, and no more."""
    pub = zmtp.PubSocket(hwm=5)
    port = pub.bind("tcp://127.0.0.1:0")
    s, parser, frames = raw_sub(port, 1)
    try:
        s.sendall(zmtp.command(b"SUBSCRIBE", b""))
        wait_until(lambda: pub.subscriber_count(b"t") == 1, "the subscription")
        big = b"x" * (1 << 20)
        t0 = time.monotonic()
        for _ in range(64):
            pub.send_multipart([b"t", big])
        assert time.monotonic() - t0 < 2.0
        # At most the socket buffers plus hwm messages were taken.
        assert 0 < pub.dropped <= 64 - 5
        for _ in range(64 - pub.dropped):
            assert read_message(s, parser, frames) == [b"t", big]
        assert not frames
        s.settimeout(0.2)
        with pytest.raises(socket.timeout):
            s.recv(1)
    finally:
        s.close()
        pub.close()


@pytest.mark.parametrize("endpoint", ["tcp://*:0", "tcp://0.0.0.0:0", "tcp://127.0.0.1:0"])
def test_bind_forms_report_the_port(endpoint):
    sink = ZMQEventSink(endpoint, pod=POD)
    try:
        host, port = sink.endpoint[len("tcp://"):].rsplit(":", 1)
        assert host == endpoint[len("tcp://"):].rsplit(":", 1)[0] and int(port) > 0
        with socket.create_connection(("127.0.0.1", int(port)), timeout=DEADLINE_S):
            pass
    finally:
        sink.close()
    with pytest.raises(ValueError):
        zmtp.PubSocket().bind("ipc:///tmp/x")


def test_server_builds_the_publisher(monkeypatch):
    """``--kv-events-endpoint`` builds the publisher with the advertised
    address as its pod and hands it to the engine; the server's cleanup
    closes it."""
    import llmd_tpu_torch.events as events
    from llmd_tpu_torch.serve import __main__ as serve

    built, apps = [], []

    class Sink(ZMQEventSink):
        def __init__(self, **kw):
            super().__init__(**kw)
            built.append(self)

    monkeypatch.setattr(events, "ZMQEventSink", Sink)
    monkeypatch.setattr(web, "run_app", lambda app, **kw: apps.append(app))
    serve.main(["--model", "tiny", "--device", "cpu", "--num-blocks", "16", "--skip-warmup",
                "--advertised-address", POD, "--kv-events-endpoint", "tcp://127.0.0.1:0"])
    (sink,) = built
    try:
        assert sink.pod == POD and sink.endpoint.startswith("tcp://127.0.0.1:")
        assert apps[0][ENGINE_KEY].engine.allocator.event_sink is sink
        for cleanup in apps[0].on_cleanup:
            asyncio.run(cleanup(apps[0]))
        assert sink._stop.is_set()
    finally:
        sink.close()
