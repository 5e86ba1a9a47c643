"""The KV shipper: register, pull, renew and free KV byte bundles.

The port of ``llmd_tpu/kvtransfer/shipper.py``'s Python server and client.
They speak the JAX package's length-prefixed wire ("KVSH"), so a port
producer serves a JAX consumer and a JAX producer (its Python server or
its native core) serves a port consumer. A request is ``<magic u32, op u8,
key length u16>``, the key, and for a renew the lease in ms (u64); a reply
is ``<status u8, length u64>`` and that many bytes. Pull model: a producer
registers a bundle under a key with a lease; a consumer pulls it, renews
the lease while it waits and free-notifies once the bundle landed; a
reaper drops bundles whose lease ran out.

The JAX package's native core (``llmd_tpu/native/kvship.cpp``) is not
ported: the port's server is the Python one, and nothing probes for
another.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time

MAGIC = 0x4B565348  # "KVSH"
OP_PULL, OP_FREE, OP_RENEW, OP_STAT = 1, 2, 3, 4
ST_OK, ST_NOT_FOUND, ST_ERR = 0, 1, 2

# A 30 s lease, renewed by the consumer at two thirds of it.
DEFAULT_LEASE_MS = 30_000
# The reaper's period (s): a lease ends at most this late.
REAP_PERIOD_S = 0.5


class PullError(RuntimeError):
    def __init__(self, msg: str, status: int = ST_ERR) -> None:
        super().__init__(msg)
        self.status = status


class ShipperServer:
    """A producer's registry of bundles and its TCP server, one port for
    metadata and bytes. ``clock`` (monotonic seconds) dates the leases;
    the reaper runs every ``reap_period_s``."""

    def __init__(self, port: int = 0, clock=time.monotonic,
                 reap_period_s: float = REAP_PERIOD_S) -> None:
        self._entries: dict[str, tuple[bytes, float]] = {}  # guarded by _lock
        self._lock = threading.Lock()
        self._clock = clock
        self.expired_count = 0  # guarded by _lock
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.settimeout(60.0)  # an idle connection's bound
                try:
                    while True:
                        hdr = _recv_exact(sock, 7)
                        if hdr is None:
                            return
                        magic, op, keylen = struct.unpack("<IBH", hdr)
                        if magic != MAGIC:
                            return
                        key = _recv_exact(sock, keylen) if keylen else b""
                        if key is None:
                            return
                        outer._dispatch(sock, op, bytes(key).decode())
                except (ConnectionError, OSError, struct.error):
                    return

        class Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Srv(("0.0.0.0", port), Handler)
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        self._stop = threading.Event()
        self._reap_period_s = reap_period_s
        self._reaper = threading.Thread(target=self._reap_loop, daemon=True)
        self._reaper.start()
        self._closed = False

    def _dispatch(self, sock: socket.socket, op: int, key: str) -> None:
        if op == OP_PULL:
            with self._lock:
                entry = self._entries.get(key)
            if entry is None:
                sock.sendall(struct.pack("<BQ", ST_NOT_FOUND, 0))
            else:
                sock.sendall(struct.pack("<BQ", ST_OK, len(entry[0])))
                sock.sendall(entry[0])
        elif op == OP_FREE:
            ok = self.unregister(key)
            sock.sendall(struct.pack("<BQ", ST_OK if ok else ST_NOT_FOUND, 0))
        elif op == OP_RENEW:
            raw = _recv_exact(sock, 8)
            if raw is None:
                return
            (lease_ms,) = struct.unpack("<Q", raw)
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries[key] = (entry[0], self._clock() + lease_ms / 1e3)
            st = ST_OK if entry is not None else ST_NOT_FOUND
            sock.sendall(struct.pack("<BQ", st, 0))
        elif op == OP_STAT:
            with self._lock:
                n = len(self._entries)
                b = sum(len(v[0]) for v in self._entries.values())
            sock.sendall(struct.pack("<BQQQ", ST_OK, 16, n, b))

    def register(self, key: str, data, lease_ms: int = DEFAULT_LEASE_MS,
                 header: bytes = b"") -> None:
        """Register ``header`` + ``data`` (bytes or any C-contiguous buffer,
        e.g. a numpy array) under ``key`` for ``lease_ms``."""
        if self._closed:
            # A clean error for the staging thread to count, not an
            # AttributeError that could take the step loop down.
            raise RuntimeError("shipper server is closed")
        blob = header + memoryview(data).cast("B")  # one copy
        with self._lock:
            self._entries[key] = (blob, self._clock() + lease_ms / 1e3)

    def unregister(self, key: str) -> bool:
        with self._lock:
            return self._entries.pop(key, None) is not None

    @property
    def registered_bytes(self) -> int:
        with self._lock:
            return sum(len(v[0]) for v in self._entries.values())

    @property
    def registered_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def reap(self) -> int:
        """Drop every bundle whose lease has ended; how many."""
        now = self._clock()
        with self._lock:
            dead = [k for k, (_, dl) in self._entries.items() if dl <= now]
            for k in dead:
                del self._entries[k]
            self.expired_count += len(dead)
        return len(dead)

    def _reap_loop(self) -> None:
        while not self._stop.wait(self._reap_period_s):
            self.reap()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._srv.shutdown()
        self._srv.server_close()
        with self._lock:
            self._entries.clear()


def _recv_exact(sock: socket.socket, n: int) -> bytearray | None:
    """``n`` bytes received straight into one buffer; None if the peer
    closed first."""
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            return None
        got += k
    return buf


# --------------------------------------------------------------------- #
# client operations (one connection an operation)


def _roundtrip(host: str, port: int, op: int, key: str, lease_ms: int = 0) -> tuple[int, bytes]:
    with socket.create_connection((host, port), timeout=30.0) as sock:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        kb = key.encode()
        msg = struct.pack("<IBH", MAGIC, op, len(kb)) + kb
        if op == OP_RENEW:
            msg += struct.pack("<Q", lease_ms)
        sock.sendall(msg)
        hdr = _recv_exact(sock, 9)
        if hdr is None:
            raise PullError("connection closed mid-response")
        st, length = struct.unpack("<BQ", hdr)
        payload = b""
        if length:
            payload = _recv_exact(sock, length)
            if payload is None:
                raise PullError("connection closed mid-payload")
        return st, payload


def pull(host: str, port: int, key: str) -> bytearray:
    """One-sided pull of a registered bundle (a writable buffer, which
    numpy and torch read without a copy); PullError if absent."""
    st, payload = _roundtrip(host, port, OP_PULL, key)
    if st != ST_OK:
        raise PullError(f"pull {key!r} from {host}:{port} -> status {st}", status=st)
    return payload


def pull_many(host: str, port: int, keys: list[str]) -> dict[str, bytes]:
    """Pull several bundles over one connection, one request after
    another. Keys the server does not hold are absent from the result; a
    transport error raises PullError. If the peer closes between requests,
    the remaining keys are pulled one connection each."""
    out: dict[str, bytes] = {}
    remaining = list(keys)
    if not remaining:
        return out
    try:
        with socket.create_connection((host, port), timeout=30.0) as sock:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while remaining:
                kb = remaining[0].encode()
                sock.sendall(struct.pack("<IBH", MAGIC, OP_PULL, len(kb)) + kb)
                hdr = _recv_exact(sock, 9)
                if hdr is None:
                    raise ConnectionError("peer closed mid-batch")
                st, length = struct.unpack("<BQ", hdr)
                payload = b""
                if length:
                    payload = _recv_exact(sock, length)
                    if payload is None:
                        raise ConnectionError("peer closed mid-payload")
                if st == ST_OK:
                    out[remaining[0]] = payload
                remaining.pop(0)
    except (ConnectionError, OSError):
        for key in remaining:
            try:
                out[key] = pull(host, port, key)
            except PullError as e:
                if e.status != ST_NOT_FOUND:
                    raise
    return out


def pull_wait(host: str, port: int, key: str, deadline: float, poll_s: float = 0.01) -> bytes:
    """Pull, retrying while the key is not registered yet (a producer
    registers each chunk once its download is done). Other errors, and
    ``deadline`` (monotonic), end the wait."""
    while True:
        try:
            return pull(host, port, key)
        except PullError as e:
            if e.status != ST_NOT_FOUND or time.monotonic() >= deadline:
                raise
        time.sleep(poll_s)


def free_notify(host: str, port: int, key: str) -> bool:
    """Tell the producer the bundle landed; it may drop it."""
    try:
        st, _ = _roundtrip(host, port, OP_FREE, key)
    except (OSError, PullError):
        return False
    return st == ST_OK


def renew(host: str, port: int, key: str, lease_ms: int = DEFAULT_LEASE_MS) -> bool:
    """The consumer's heartbeat: extend the producer's lease."""
    try:
        st, _ = _roundtrip(host, port, OP_RENEW, key, lease_ms)
    except (OSError, PullError):
        return False
    return st == ST_OK


def stat(host: str, port: int) -> tuple[int, int]:
    """(registered count, registered bytes) of a remote shipper."""
    st, payload = _roundtrip(host, port, OP_STAT, "")
    if st != ST_OK or len(payload) != 16:
        raise PullError(f"stat {host}:{port} failed")
    n, b = struct.unpack("<QQ", payload)
    return n, b
