"""A ZMTP 3.1 PUB socket on the standard library's ``socket``.

The KV events' wire is ZeroMQ's: the router's subscribers (pyzmq / libzmq
SUB sockets, ``llmd_tpu/events/subscriber.py``) connect to each engine's
PUB endpoint. The port speaks the protocol itself (ZMTP 3.1, RFC 37, with
the NULL security mechanism, RFC 23's framing) rather than import a ZeroMQ
binding, so every machine runs the same code.

What a PUB does, and so what this one does:

* ``bind`` takes ``tcp://*:P``, ``tcp://0.0.0.0:P``, ``tcp://HOST:P`` (an
  IPv4 host) and port 0 (a free port, returned, as pyzmq's
  ``bind_to_random_port``);
* each peer that connects exchanges greetings (signature, version 3.1,
  mechanism ``NULL``) and ``READY`` commands (``Socket-Type: PUB``; a peer
  that is not a SUB or XSUB is dropped);
* a peer subscribes and unsubscribes by topic prefix, with ZMTP 3.1's
  ``SUBSCRIBE`` / ``CANCEL`` commands or with 3.0's messages whose first
  byte is 1 or 0, whichever its library sends; a message goes to the peers
  one of whose prefixes starts its first frame, and to no other;
* ``send_multipart`` frames a message once (the MORE flag on all frames but
  the last; one-byte sizes up to 255, eight-byte sizes past that), queues
  it for every matching peer and returns: it never waits for a peer. A
  peer's queue holds at most ``hwm`` messages (libzmq's default SNDHWM,
  1,000); past that the message is dropped for that peer (``dropped``), as
  a PUB drops for a slow subscriber;
* one thread does the socket work (accepts, handshakes, subscriptions,
  writes); ``close`` stops it and closes every socket at once (linger 0).

``FrameParser``, ``encode_frame``, ``command`` and ``GREETING`` are the
framing a SUB side needs as well (``chip_smoke.py`` reads the engine's
events with them).
"""

from __future__ import annotations

import collections
import logging
import selectors
import socket
import struct
import threading

log = logging.getLogger(__name__)

# Greeting: signature (0xFF, 8 padding bytes, 0x7F), version 3.1, the
# mechanism's name in 20 bytes, as-server, 31 bytes of filler.
SIGNATURE = b"\xff" + b"\x00" * 8 + b"\x7f"
GREETING = SIGNATURE + b"\x03\x01" + b"NULL".ljust(20, b"\x00") + b"\x00" + b"\x00" * 31
GREETING_SIZE = 64

FLAG_MORE, FLAG_LONG, FLAG_COMMAND = 1, 2, 4

# libzmq's default send high-water mark, in messages.
DEFAULT_HWM = 1000


def encode_frame(body: bytes, more: bool = False, is_command: bool = False) -> bytes:
    """One frame: flags, size (one byte up to 255, else eight), body."""
    flags = (FLAG_MORE if more else 0) | (FLAG_COMMAND if is_command else 0)
    n = len(body)
    if n > 255:
        return bytes((flags | FLAG_LONG,)) + struct.pack(">Q", n) + bytes(body)
    return bytes((flags, n)) + bytes(body)


def encode_message(frames) -> bytes:
    """A multipart message: every frame but the last carries MORE."""
    last = len(frames) - 1
    return b"".join(encode_frame(f, more=i < last) for i, f in enumerate(frames))


def command(name: bytes, data: bytes = b"") -> bytes:
    """A command frame: the name's length, the name, its data."""
    return encode_frame(bytes((len(name),)) + name + data, is_command=True)


def ready(socket_type: str) -> bytes:
    """The NULL mechanism's READY command with its one property."""
    key, value = b"Socket-Type", socket_type.encode()
    return command(b"READY", bytes((len(key),)) + key + struct.pack(">I", len(value)) + value)


def parse_command(body: bytes) -> tuple[bytes, bytes]:
    """(name, data) of a command frame's body."""
    if not body:
        raise ValueError("empty command")
    n = body[0]
    if len(body) < 1 + n:
        raise ValueError("truncated command name")
    return bytes(body[1 : 1 + n]), bytes(body[1 + n :])


def parse_properties(data: bytes) -> dict[str, bytes]:
    """READY's metadata: (name length u8, name, value length u32, value)*."""
    out, i = {}, 0
    while i < len(data):
        n = data[i]
        key = bytes(data[i + 1 : i + 1 + n]).decode("ascii", "replace")
        i += 1 + n
        if i + 4 > len(data):
            raise ValueError("truncated property")
        (m,) = struct.unpack_from(">I", data, i)
        out[key.lower()] = bytes(data[i + 4 : i + 4 + m])
        i += 4 + m
    return out


def check_greeting(g: bytes) -> tuple[int, int]:
    """The peer's (major, minor) version; ValueError unless its greeting is
    a ZMTP 3.x greeting with the NULL mechanism."""
    if g[0] != 0xFF or g[9] & 1 != 1:
        raise ValueError("not a ZMTP signature")
    if g[10] < 3:
        raise ValueError(f"ZMTP {g[10]}.{g[11]} peer: 3.0 or later is required")
    if bytes(g[12:32]).rstrip(b"\x00") != b"NULL":
        raise ValueError(f"mechanism {bytes(g[12:32]).rstrip(bytes(1))!r}: only NULL is spoken")
    return g[10], g[11]


class FrameParser:
    """Incremental frame reader: ``feed`` bytes, get the complete frames as
    (flags, body)."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> list[tuple[int, bytes]]:
        self._buf += data
        out, i, buf = [], 0, self._buf
        while len(buf) - i >= 2:
            flags = buf[i]
            if flags & FLAG_LONG:
                if len(buf) - i < 9:
                    break
                (n,) = struct.unpack_from(">Q", buf, i + 1)
                head = 9
            else:
                n, head = buf[i + 1], 2
            if len(buf) - i < head + n:
                break
            out.append((flags, bytes(buf[i + head : i + head + n])))
            i += head + n
        del buf[:i]
        return out


class _Peer:
    """One connected subscriber: its handshake state, subscriptions and
    send queue."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.inbound = bytearray()  # the greeting, until it is whole
        self.parser = FrameParser()
        self.state = "greeting"  # -> "ready" -> "active"
        self.subs: collections.Counter[bytes] = collections.Counter()
        self.queue: collections.deque[bytes] = collections.deque()  # whole messages
        self.handshake = bytearray(GREETING + ready("PUB"))
        self.out: memoryview | None = None  # what is left of the message being written
        self.want_write = True

    def matches(self, topic: bytes) -> bool:
        return any(topic.startswith(p) for p in self.subs)


class PubSocket:
    """A ZMTP 3.1 PUB socket (see the module docstring). Thread-safe:
    ``send_multipart`` and ``close`` may come from any thread."""

    def __init__(self, hwm: int = DEFAULT_HWM) -> None:
        self.hwm = hwm
        self.dropped = 0  # messages a full peer queue refused; guarded by _lock
        self.port: int | None = None
        self._lock = threading.Lock()
        self._peers: dict[int, _Peer] = {}  # by fileno; guarded by _lock
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._listener: socket.socket | None = None
        self._closed = False
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ setup

    def bind(self, endpoint: str) -> int:
        """Listen on ``tcp://HOST:PORT`` (``*`` for every interface; port 0
        for a free one); returns the port."""
        if not endpoint.startswith("tcp://"):
            raise ValueError(f"{endpoint!r}: only tcp:// endpoints are supported")
        host, _, port = endpoint[len("tcp://") :].rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"{endpoint!r} is not tcp://HOST:PORT")
        if host == "*":
            host = "0.0.0.0"
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lst.bind((host, int(port)))
            lst.listen(64)
        except OSError:
            lst.close()
            raise
        lst.setblocking(False)
        self._listener = lst
        self.port = lst.getsockname()[1]
        self._sel.register(lst, selectors.EVENT_READ, "accept")
        self._thread = threading.Thread(target=self._run, name="llmd-zmtp-pub", daemon=True)
        self._thread.start()
        return self.port

    # ------------------------------------------------------------- send

    def send_multipart(self, frames) -> int:
        """Queue one message for every subscribed peer; returns to how many.
        Never blocks on a peer."""
        if self._closed:
            raise OSError("socket closed")
        topic = bytes(frames[0]) if frames else b""
        data = None
        n = 0
        with self._lock:
            for peer in self._peers.values():
                if peer.state != "active" or not peer.matches(topic):
                    continue
                if len(peer.queue) >= self.hwm:
                    self.dropped += 1
                    continue
                if data is None:
                    data = encode_message([bytes(f) for f in frames])
                peer.queue.append(data)
                peer.want_write = True
                n += 1
        if n:
            self._wake()
        return n

    def subscriber_count(self, topic: bytes = b"") -> int:
        """Peers past the handshake that ``topic`` would reach."""
        with self._lock:
            return sum(p.state == "active" and p.matches(topic) for p in self._peers.values())

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except (BlockingIOError, OSError):
            pass  # a wake is already pending, or the socket is closing

    # ------------------------------------------------------ the I/O thread

    def _run(self) -> None:
        while not self._closed:
            with self._lock:
                for fd, peer in self._peers.items():
                    events = selectors.EVENT_READ
                    if peer.want_write:
                        events |= selectors.EVENT_WRITE
                    try:
                        self._sel.modify(peer.sock, events, fd)
                    except (KeyError, ValueError, OSError):
                        pass
            try:
                ready_ = self._sel.select(timeout=0.5)
            except OSError:
                if self._closed:
                    return
                raise
            for key, events in ready_:
                if self._closed:
                    return
                if key.data == "wake":
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                elif key.data == "accept":
                    self._accept()
                else:
                    peer = self._peers.get(key.data)
                    if peer is None:
                        continue
                    try:
                        if events & selectors.EVENT_READ:
                            self._read(peer)
                        if events & selectors.EVENT_WRITE and peer.sock.fileno() >= 0:
                            self._write(peer)
                    except (OSError, ValueError) as e:
                        log.debug("zmtp peer dropped: %s", e)
                        self._drop(peer)

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            peer = _Peer(sock)
            fd = sock.fileno()
            with self._lock:
                self._peers[fd] = peer
            self._sel.register(sock, selectors.EVENT_READ | selectors.EVENT_WRITE, fd)

    def _drop(self, peer: _Peer) -> None:
        with self._lock:
            fd = next((f for f, p in self._peers.items() if p is peer), None)
            if fd is not None:
                del self._peers[fd]
        try:
            self._sel.unregister(peer.sock)
        except (KeyError, ValueError, OSError):
            pass
        peer.sock.close()

    def _read(self, peer: _Peer) -> None:
        data = peer.sock.recv(65536)
        if not data:
            raise ConnectionResetError("peer closed")
        if peer.state == "greeting":
            peer.inbound += data
            if len(peer.inbound) < GREETING_SIZE:
                return
            check_greeting(peer.inbound[:GREETING_SIZE])
            data = bytes(peer.inbound[GREETING_SIZE:])
            peer.inbound = bytearray()
            peer.state = "ready"
        for flags, body in peer.parser.feed(data):
            if flags & FLAG_COMMAND:
                self._on_command(peer, *parse_command(body))
            elif peer.state != "active":
                raise ValueError("message before READY")
            elif body[:1] == b"\x01":  # ZMTP 3.0 subscribe
                with self._lock:
                    peer.subs[body[1:]] += 1
            elif body[:1] == b"\x00":  # ZMTP 3.0 cancel
                self._cancel(peer, body[1:])
            # other messages from a subscriber are dropped, as a PUB does

    def _on_command(self, peer: _Peer, name: bytes, data: bytes) -> None:
        if name == b"READY":
            kind = parse_properties(data).get("socket-type", b"")
            if kind not in (b"SUB", b"XSUB"):
                raise ValueError(f"a {kind!r} peer cannot subscribe to a PUB")
            peer.state = "active"
        elif peer.state != "active":
            raise ValueError(f"{name!r} before READY")
        elif name == b"SUBSCRIBE":
            with self._lock:
                peer.subs[data] += 1
        elif name == b"CANCEL":
            self._cancel(peer, data)
        elif name == b"PING":  # heartbeat: answer with its context
            ctx = data[2:]
            with self._lock:
                peer.handshake += command(b"PONG", ctx)
                peer.want_write = True
        elif name == b"ERROR":
            raise ValueError(f"peer error: {data[1:]!r}")

    def _cancel(self, peer: _Peer, topic: bytes) -> None:
        with self._lock:
            if peer.subs[topic] > 1:
                peer.subs[topic] -= 1
            else:
                peer.subs.pop(topic, None)

    def _write(self, peer: _Peer) -> None:
        while True:
            with self._lock:
                if peer.out is None:
                    if peer.handshake:
                        peer.out = memoryview(bytes(peer.handshake))
                        peer.handshake = bytearray()
                    elif peer.state == "active" and peer.queue:
                        peer.out = memoryview(peer.queue.popleft())
                    else:
                        peer.want_write = False
                        return
                out = peer.out
            try:
                n = peer.sock.send(out)
            except BlockingIOError:
                return
            with self._lock:
                peer.out = out[n:] if n < len(out) else None

    # ------------------------------------------------------------ close

    def close(self) -> None:
        """Stop the I/O thread and close every socket; queued messages are
        dropped (a linger of 0)."""
        if self._closed:
            return
        self._closed = True
        self._wake()
        if self._thread is not None:
            self._thread.join(timeout=5)
        with self._lock:
            peers, self._peers = list(self._peers.values()), {}
        for peer in peers:
            peer.sock.close()
        if self._listener is not None:
            self._listener.close()
        self._sel.close()
        self._wake_r.close()
        self._wake_w.close()
