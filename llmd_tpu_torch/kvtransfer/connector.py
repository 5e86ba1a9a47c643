"""The P/D transfer connector: the KV shipper wired into the engine.

The port of ``llmd_tpu/kvtransfer/connector.py``, one host and one card:

  producer (the prefill engine): when a request tagged ``do_remote_decode``
  finishes, the KV pages of its full prompt pages are snapshotted on the
  device (in the finish hook, before its pages are released), and a staging
  thread downloads them and registers them with the local shipper, one key
  a chunk of pages (``chunk_key``), or under the v3 group-framed wire one a
  (layer group, chunk) cell (``group_key``), group-major. The response
  carries ``kv_transfer_params`` with the shipper's address.

  consumer (the decode engine): a request that arrives with those params
  pulls the bundle, lands it in fresh pool pages and commits each page's
  chained hash to the prefix cache (``apply_bundle``), so the prefill is a
  prefix-cache hit and only the last partial page is recomputed. A ring
  engine (no prefix cache) takes the pages and a fresh ring straight into
  the request instead (``apply_preload``). A failed pull follows
  ``load_failure_policy``: "recompute" (prefill locally) or "fail".

The wire is the JAX package's byte for byte: headers of versions 1, 2 and
3 (``pack_header``, ``pack_header_q8``), the dtype by name ('bfloat16',
'float32', 'int8q:<name>' for the q8 form), the CRC32 of versions 2 and 3
and the group extension of version 3. numpy has no bfloat16 and the port
does not import ``ml_dtypes``: a bf16 bundle is held as its bits,
``uint16`` (``runner.pages_to_numpy``), and a name travels beside it.

Producer and consumer in one process take a fast path (``claim_local``):
the consumer takes the producer's device snapshots and scatters them on
the device, with no host staging and no wire. The JAX package's registry
of such producers is its own, so a JAX engine and a port engine in one
process always meet over TCP.

The rollout pins are read as the JAX package reads them:
``LLMD_KV_BUNDLE_COMPAT_V1=1`` makes producers write version-1 headers
(no CRC), ``LLMD_KV_STREAM_COMPAT_V2=1`` the v2 chunk framing (no layer
groups). They choose a wire form for mixed rolling deploys, nothing else.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import math
import os
import struct
import threading
import time
import uuid
import weakref
import zlib
from typing import Any

import numpy as np
import torch

from llmd_tpu_torch import faults
from llmd_tpu_torch.engine.kv_cache import NoFreePagesError, PageAllocator, page_hashes_for_tokens
from llmd_tpu_torch.engine.runner import pages_to_numpy
from llmd_tpu_torch.kvtransfer import shipper as shipper_mod
from llmd_tpu_torch.kvtransfer.offload import HostPagePool
from llmd_tpu_torch.kvtransfer.shipper import DEFAULT_LEASE_MS, PullError, ShipperServer
from llmd_tpu_torch.ops.quant_kv import quantize_rows_q8

log = logging.getLogger(__name__)

_HDR = struct.Struct("<4sBHIIIII")  # magic, version, dtype_len, L, n, K, page, inner
_MAGIC = b"KVPG"
# Version 2 appends the CRC32 of everything after the dtype name (scales
# and payload for q8, the payload otherwise); version 3 puts the group
# extension (group index, number of groups, first layer) between the name
# and the CRC, and its L is the group's layer count.
_CRC = struct.Struct("<I")
_GRP = struct.Struct("<HHH")
_Q8_PREFIX = "int8q:"

_COMPAT_V1 = os.environ.get("LLMD_KV_BUNDLE_COMPAT_V1", "0") not in ("", "0")
_COMPAT_V2 = os.environ.get("LLMD_KV_STREAM_COMPAT_V2", "0") not in ("", "0")


@dataclasses.dataclass
class KVTransferConfig:
    role: str  # "kv_producer" | "kv_consumer" | "kv_both"
    host: str = "127.0.0.1"  # the address consumers are told
    port: int = 9100  # 0: any free port
    lease_ms: int = DEFAULT_LEASE_MS
    load_failure_policy: str = "recompute"  # "recompute" | "fail"
    # "auto": the pool's dtype, byte for byte; "int8": each row's K and V
    # halves as int8 with an f16 scale, quantized on the device (half the
    # bytes, about 0.4% per row); "adaptive": the faster of the two on
    # this link, measured per chunk in original bytes a second.
    transfer_dtype: str = "auto"
    # Consumers claim an in-process producer's device snapshots.
    local_fastpath: bool = True
    # The v3 group-framed wire: exports in this many contiguous layer
    # groups, staged group-major; 1 (or a rollout pin) is the v2 framing.
    stream_groups: int = 4

    @property
    def is_producer(self) -> bool:
        return self.role in ("kv_producer", "kv_both")

    @property
    def is_consumer(self) -> bool:
        return self.role in ("kv_consumer", "kv_both")


class KVLoadError(RuntimeError):
    """A remote KV pull failed under policy 'fail'."""


class KVCorruptionError(PullError):
    """A bundle failed its CRC32: every policy path treats it as a failed
    pull, and the connector counts it apart (``crc_failures``)."""


def _pad_chunk_ids(ids: list[int], cp: int) -> list[int]:
    """A chunk's page ids padded to ``cp`` by repeating the last: the
    producer pads a tail chunk by repeating its last page, so the pad
    writes the same values to the same page."""
    return ids + [ids[-1]] * (cp - len(ids)) if len(ids) < cp else ids


# --------------------------------------------------------------------- #
# the wire


def wire_dtype_name(a) -> str:
    """The dtype name a bundle travels under: numpy's, or 'bfloat16' for
    the port's bf16 bits (``uint16``) and for ``ml_dtypes``' bfloat16."""
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    return "bfloat16" if a.dtype == np.uint16 or a.dtype.name == "bfloat16" else a.dtype.name


def _np_dtype(name: str) -> np.dtype:
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A host bundle as a CPU tensor of its wire dtype (bf16 bits read as
    bf16), writable (a copy of a buffer that is not)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if wire_dtype_name(a) == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _as_f32(a: np.ndarray) -> np.ndarray:
    """A float bundle's values in float32 (exact for bf16 and f16)."""
    if wire_dtype_name(a) == "bfloat16":
        return (np.ascontiguousarray(a).view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(a, np.float32)


def chunk_key(key: str, j: int) -> str:
    """Shipper key of one export chunk."""
    return f"{key}:c{j}"


def group_key(key: str, g: int, j: int) -> str:
    """Shipper key of one (layer group, chunk) cell of a v3 export."""
    return f"{key}:g{g}:c{j}"


def swa_key(key: str) -> str:
    """Shipper key of a ring export's sliding-layer section."""
    return f"{key}:swa"


def layer_groups(num_layers: int, groups: int) -> list[tuple[int, int]]:
    """(layer0, n_layers) of ``num_layers`` cut into ``groups`` contiguous
    groups (at most one a layer), the first ``num_layers % groups`` one
    layer larger: producer and consumer derive it from (L, groups) alone."""
    groups = max(1, min(groups, num_layers))
    base, rem = divmod(num_layers, groups)
    out, l0 = [], 0
    for g in range(groups):
        lg = base + (1 if g < rem else 0)
        out.append((l0, lg))
        l0 += lg
    return out


def transfer_keys(params: dict) -> list[str]:
    """Every shipper key of a transfer (a legacy bundle's one, a chunk's,
    a cell's, and a ring export's section)."""
    key = params.get("remote_key", "")
    n = int(params.get("num_chunks", 0) or 0)
    ng = int(params.get("num_groups", 0) or 0)
    if n <= 0:
        keys = [key]
    elif ng > 1:
        keys = [group_key(key, g, j) for g in range(ng) for j in range(n)]
    else:
        keys = [chunk_key(key, j) for j in range(n)]
    if int(params.get("swa_pages", 0) or 0) > 0:
        keys.append(swa_key(key))
    return keys


def payload_crc(*parts) -> int:
    """CRC32 of the bytes after the dtype name (parts: bytes or
    C-contiguous buffers)."""
    crc = 0
    for p in parts:
        crc = zlib.crc32(p, crc)
    return crc


def _header(name: str, shape, crc: int | None, group) -> bytes:
    dt = name.encode()
    L, n, K, page, inner = shape
    if group is not None:
        if crc is None:
            raise ValueError("a group-framed header carries a CRC")
        return _HDR.pack(_MAGIC, 3, len(dt), L, n, K, page, inner) + dt + _GRP.pack(*group) \
            + _CRC.pack(crc)
    if crc is None or _COMPAT_V1:
        return _HDR.pack(_MAGIC, 1, len(dt), L, n, K, page, inner) + dt
    return _HDR.pack(_MAGIC, 2, len(dt), L, n, K, page, inner) + dt + _CRC.pack(crc)


def pack_header(pages, crc: int | None = None, group: tuple[int, int, int] | None = None,
                dtype_name: str | None = None) -> bytes:
    """Header of a ``[L, n, K, page, inner]`` bundle: version 1 without
    ``crc`` (or under ``LLMD_KV_BUNDLE_COMPAT_V1``), 2 with it, 3 with
    ``group=(g, num_groups, layer0)``. The dtype travels by name
    (``wire_dtype_name`` unless ``dtype_name`` is given)."""
    return _header(dtype_name or wire_dtype_name(pages), pages.shape, crc, group)


def pack_header_q8(q8, orig_dtype_name: str, crc: int | None = None,
                   group: tuple[int, int, int] | None = None) -> bytes:
    """Header of a q8 bundle: the name 'int8q:<original dtype>'; the f16
    scales follow the header, the int8 rows follow them; a CRC covers both."""
    return _header(_Q8_PREFIX + orig_dtype_name, q8.shape, crc, group)


def _payload_offset(blob: bytes, ver: int, dlen: int) -> int:
    """Where the bytes after the name (and the group extension) start;
    versions 2 and 3 check their CRC first."""
    off = _HDR.size + dlen
    if ver < 2:
        return off
    if ver >= 3:
        off += _GRP.size
    (want,) = _CRC.unpack_from(blob, off)
    off += _CRC.size
    got = zlib.crc32(memoryview(blob)[off:])
    if got != want:
        raise KVCorruptionError(f"KV bundle CRC mismatch: header {want:#010x} vs payload "
                                f"{got:#010x} ({len(blob)} wire bytes)")
    return off


def bundle_group_info(blob: bytes) -> tuple[int, int, int]:
    """(group index, number of groups, layer0) of a blob; (0, 1, 0) before
    version 3."""
    magic, ver, dlen, *_ = _HDR.unpack_from(blob, 0)
    if magic != _MAGIC:
        raise PullError("bad KV bundle header")
    if ver < 3:
        return (0, 1, 0)
    return _GRP.unpack_from(blob, _HDR.size + dlen)


def unpack_pages_any(blob: bytes):
    """Decode either form: ("exact", pages) or ("q8", q8, f16 scales,
    original dtype name); bf16 pages as ``uint16`` bits."""
    magic, ver, dlen, L, n, K, page, inner = _HDR.unpack_from(blob, 0)
    if magic != _MAGIC or ver not in (1, 2, 3):
        raise PullError("bad KV bundle header")
    name = blob[_HDR.size : _HDR.size + dlen].decode()
    off = _payload_offset(blob, ver, dlen)
    if not name.startswith(_Q8_PREFIX):
        pages = np.frombuffer(blob, dtype=_np_dtype(name), offset=off)
        return ("exact", pages.reshape(L, n, K, page, inner))
    rows = L * n * K * page
    scales = np.frombuffer(blob, dtype=np.float16, offset=off, count=rows * 2)
    q8 = np.frombuffer(blob, dtype=np.int8, offset=off + rows * 4, count=rows * inner)
    return ("q8", q8.reshape(L, n, K, page, inner), scales.reshape(L, n, K, page, 2),
            name[len(_Q8_PREFIX):])


def unpack_pages(blob: bytes) -> np.ndarray:
    """An exact bundle's pages (a q8 bundle raises PullError)."""
    decoded = unpack_pages_any(blob)
    if decoded[0] != "exact":
        raise PullError("expected an exact KV bundle, got the q8 form")
    return decoded[1]


def _dequant_chunk(c) -> np.ndarray:
    """A host chunk's values: a float bundle as it is, a q8 pair as f32."""
    if not isinstance(c, tuple):
        return c
    q8, scales = c
    *lead, d2 = q8.shape
    out = q8.astype(np.float32).reshape(*lead, 2, d2 // 2) * scales[..., None].astype(np.float32)
    return out.reshape(*lead, d2)


def _faulty_pull(host: str, port: int, key: str, deadline: float | None = None) -> bytes:
    """Every consumer pull: the fault sites kv.pull.delay_ms, kv.pull.drop
    and kv.bundle.corrupt wrap the wire call."""
    faults.delay("kv.pull.delay_ms", key)
    if faults.fires("kv.pull.drop", key):
        raise PullError(f"injected kv.pull.drop for {key!r}")
    if deadline is None:
        blob = shipper_mod.pull(host, port, key)
    else:
        blob = shipper_mod.pull_wait(host, port, key, deadline)
    return faults.corrupt("kv.bundle.corrupt", blob, key)


@dataclasses.dataclass
class PulledBundle:
    """A fetched and checked bundle waiting for the engine thread's apply
    (or ``release_bundle``)."""

    pages: np.ndarray | None  # a legacy single bundle, [L, n_full, ...]
    hashes: list[bytes]  # chained content hashes, one a page
    nbytes: int
    host: str
    port: int
    key: str
    keys: list[str] = dataclasses.field(default_factory=list)  # shipper keys
    # Chunks on the device ([L, cp, ...] each, or (chunk, layer0, Lg,
    # device cell) of a claimed v3 export), and host chunks.
    device_chunks: list = dataclasses.field(default_factory=list)
    np_chunks: list = dataclasses.field(default_factory=list)
    chunk_pages: int = 0
    # A streamed import's pool pages, written by the fetch thread: pages
    # [start_page, start_page + len(stream_ids)); the bundle owns them
    # until apply or release.
    stream_ids: list | None = None
    # The prompt page of the first pulled chunk's first page.
    start_page: int = 0
    # A ring export's sliding-layer section (host pages, or a claimed
    # device snapshot) and the prompt page it starts at.
    swa_pages_np: np.ndarray | None = None
    swa_device: Any = None
    swa_start_page: int = 0
    swa_count: int = 0

    def host_pages(self, n_full: int) -> np.ndarray:
        """The pulled pages ``[L, n_full - start_page, ...]`` on the host,
        q8 chunks dequantized (the buffered path only)."""
        if self.pages is not None:
            return self.pages
        chunks = [_dequant_chunk(c) for c in self.np_chunks]
        return np.concatenate(chunks, axis=1)[:, : n_full - self.start_page]


# In-process producers (the single-host fast path) by shipper port, and
# in-process consumers (weak: a consumer dropped without close() must not
# hold producers' grace windows open).
_LOCAL_PRODUCERS: dict[int, "KVConnector"] = {}
_LOCAL_CONSUMERS: "weakref.WeakSet[KVConnector]" = weakref.WeakSet()
_LOCAL_HOSTS = {"127.0.0.1", "localhost", "::1"}


def _lookup_local(host: str, port: int) -> "KVConnector | None":
    conn = _LOCAL_PRODUCERS.get(port)
    if conn is not None and (host in _LOCAL_HOSTS or host == conn.cfg.host):
        return conn
    return None


class KVStreamHandle:
    """One group-streamed import in flight (consumer side). The serving
    layer submits the request once ``first_group`` is set; the engine parks
    it and, once ``done`` is set, applies the bundle or recomputes. Exactly
    one of ``take`` and ``abandon`` disposes of the bundle."""

    def __init__(self, connector: "KVConnector", params: dict) -> None:
        self.connector = connector
        self.params = params
        self.first_group = threading.Event()
        self.done = threading.Event()
        self._lock = threading.Lock()
        self._bundle: PulledBundle | None = None  # guarded by _lock
        self._abandoned = False  # guarded by _lock
        self.error: str | None = None
        # Set before the fetch starts, called once from the fetch thread
        # when the first group is resident (an event loop's wake-up).
        self.on_first_group = None

    def mark_first_group(self) -> None:
        if not self.first_group.is_set():
            self.first_group.set()
            cb = self.on_first_group
            if cb is not None:
                try:
                    cb()
                except RuntimeError:
                    pass  # the event loop closed meanwhile

    def resolve(self, bundle: PulledBundle) -> None:
        release = None
        with self._lock:
            if self._abandoned:
                release = bundle
            else:
                self._bundle = bundle
        self.mark_first_group()
        self.done.set()
        if release is not None:
            self.connector.release_bundle(release)

    def fail(self, error: str) -> None:
        self.error = error
        self.mark_first_group()
        self.done.set()

    def take(self) -> PulledBundle | None:
        with self._lock:
            bundle, self._bundle = self._bundle, None
            return bundle

    def abandon(self) -> None:
        with self._lock:
            self._abandoned = True
            bundle, self._bundle = self._bundle, None
        if bundle is not None:
            self.connector.release_bundle(bundle)

    def wait_admittable(self, timeout: float | None = None) -> bool:
        return self.first_group.wait(timeout)


class KVConnector:
    """The engine's connector (JAX ``TPUConnector``), one an engine."""

    # Pages a transfer chunk: the staging thread registers chunk by chunk,
    # and the consumer's uploads overlap the producer's later downloads.
    CHUNK_PAGES = 8
    # How long a staging thread waits for an in-process claim before it
    # downloads (only while an in-process consumer exists).
    LOCAL_CLAIM_GRACE_S = 0.1
    # Pending in-process exports kept at most (a remote consumer never
    # claims).
    MAX_LOCAL_PENDING = 16
    # Pinned staging slots reserved at start (one an export staging at
    # once; more are pinned when more stage together), and the alignment
    # of the second half of a q8 pair in its slot.
    STAGING_SLOTS = 4
    _SLOT_ALIGN = 64

    def __init__(self, cfg: KVTransferConfig, runner, allocator: PageAllocator) -> None:
        if cfg.transfer_dtype not in ("auto", "int8", "adaptive"):
            raise ValueError(f"kv transfer_dtype {cfg.transfer_dtype!r} not supported "
                             "('auto', 'int8', or 'adaptive')")
        if cfg.load_failure_policy not in ("recompute", "fail"):
            raise ValueError(f"kv load_failure_policy {cfg.load_failure_policy!r} not "
                             "supported ('recompute' or 'fail')")
        if cfg.transfer_dtype == "adaptive" and runner.cfg.is_mla:
            # The q8 form's K|V midpoint split is wrong for latent rows.
            log.warning("transfer_dtype='adaptive' downgraded to 'auto' for an MLA model: "
                        "the q8 wire form is unsafe for latent rows, so no encoding race "
                        "will run")
            cfg = dataclasses.replace(cfg, transfer_dtype="auto")
        if cfg.transfer_dtype == "int8" and runner.cfg.is_mla:
            raise ValueError("kv transfer_dtype='int8' is not supported for MLA models "
                             "(latent rows need their own scale layout); use 'auto'")
        self.cfg = cfg
        self.runner = runner
        self.allocator = allocator
        if cfg.is_consumer and not allocator.enable_prefix_caching and runner.swa is None:
            # Imports land as prefix-cache seeds (a ring engine takes the
            # preload path instead).
            raise ValueError("kv_consumer role requires enable_prefix_caching=True")
        self.server: ShipperServer | None = None
        if cfg.is_producer:
            self.server = ShipperServer(cfg.port)
            log.info("kvship producer listening on :%d", self.server.port)
            # The staging threads' pinned slots, reserved now: pinning
            # host memory inside an export would cost more than the copy.
            self._staging = HostPagePool((self._staging_slot_bytes(),), torch.uint8,
                                         pin=runner.device.type == "cuda",
                                         slab_pages=self.STAGING_SLOTS,
                                         reserve=self.STAGING_SLOTS)
        self._local_lock = threading.Lock()
        self._local_cond = threading.Condition(self._local_lock)
        self._local_exports: dict[str, tuple] = {}  # guarded by _local_lock
        self._local_claimed: set[str] = set()  # guarded by _local_lock
        self._staging_active: set[str] = set()  # guarded by _local_lock
        self._local_enabled = cfg.local_fastpath and self.server is not None
        if self._local_enabled:
            _LOCAL_PRODUCERS[self.server.port] = self
        if cfg.is_consumer and cfg.local_fastpath:
            _LOCAL_CONSUMERS.add(self)
        self.exported_requests = 0
        self.exported_bytes = 0  # guarded by _local_lock (staging threads)
        self.imported_requests = 0
        self.imported_bytes = 0
        self.import_failures = 0
        self.local_imports = 0
        self.stream_imports = 0
        self.stream_groups_total = 0  # guarded by _local_lock
        self.last_first_group_ms = 0.0
        self._fetch_t0 = 0.0  # the last import's start (monotonic)
        self.crc_failures = 0
        self.recompute_fallbacks = 0
        self.transfer_failures: collections.Counter = collections.Counter()
        # Adaptive encoding: staging rate (original bytes a second, EWMA)
        # of each wire form.
        self._enc_rate: dict[str, float | None] = {"exact": None, "q8": None}  # guarded
        self._adaptive_exports = 0  # guarded by _local_lock
        # The last transfer's legs (ms): the producer's snapshots in the
        # finish hook, its downloads and registrations, the consumer's
        # pulls and uploads, its scatters and commits.
        self.last_export_ms = 0.0
        self.last_stage_ms = 0.0
        self.last_fetch_ms = 0.0
        self.last_apply_ms = 0.0
        # The last export's staged bytes and the seconds of its downloads
        # (their sum over cells) and registrations.
        self.last_staged_bytes = 0
        self.last_download_s = 0.0
        self.last_register_s = 0.0
        # The last import's pulls: their seconds and bytes (the rest of
        # ``last_fetch_ms`` is the checks, uploads and scatters).
        self.last_pull_s = 0.0
        self.last_pulled_bytes = 0

    # ------------------------------------------------------------------ #
    # the layer groups

    @property
    def _pool_layers(self) -> int:
        """Layers of the full-attention pool (the ring's sliding layers
        travel as a section of their own)."""
        spec = self.runner.swa
        return len(spec.full_layers) if spec is not None else self.runner.cfg.num_layers

    def _group_plan(self, n_groups: int | None = None) -> list[tuple[int, int]]:
        if n_groups is None:
            n_groups = 1 if (_COMPAT_V1 or _COMPAT_V2) else self.cfg.stream_groups
        return layer_groups(self._pool_layers, max(1, n_groups))

    # ------------------------------------------------------------------ #
    # producer

    def wants_export(self, req) -> bool:
        return bool(self.cfg.is_producer and self.server is not None
                    and req.kv_transfer_params
                    and req.kv_transfer_params.get("do_remote_decode"))

    def export_finished(self, req) -> dict[str, Any] | None:
        """Snapshot a finished producer request's full prompt pages on the
        device and start their staging; returns the params for the
        consumer. Runs while ``req.block_ids`` is live (the scheduler's
        finish hook). ``skip_pages`` in the request's params drops the
        leading pages the consumer holds already."""
        t0 = time.monotonic()
        page = self.allocator.page_size
        n_full = req.num_prompt_tokens // page
        if n_full == 0 or len(req.block_ids) < n_full or req.num_computed_tokens < n_full * page:
            return None
        skip = 0
        if req.kv_transfer_params:
            try:
                skip = min(max(int(req.kv_transfer_params.get("skip_pages", 0) or 0), 0), n_full)
            except (TypeError, ValueError):
                skip = 0  # a malformed client field: a full export
        # A server-unique key: colliding request ids cannot cross exports.
        key = f"{req.request_id}:{uuid.uuid4().hex[:12]}"
        cp = self.CHUNK_PAGES
        ids = list(req.block_ids[skip:n_full])
        n_chunks = -(-len(ids) // cp) if ids else 0
        quantized_pool = self.runner.kv_quantized
        # An int8 pool always ships its bytes in the q8 form. An adaptive
        # export snapshots exact and decides per cell on the staging
        # thread, so a local claim stays lossless.
        adaptive_stage = self.cfg.transfer_dtype == "adaptive" and not quantized_pool
        use_q8 = self.cfg.transfer_dtype == "int8" or quantized_pool
        snap_fn = (self.runner.snapshot_pages_device_q8 if use_q8
                   else self.runner.snapshot_pages_device)
        plan = self._group_plan()
        n_groups = len(plan)
        cells = [(g, l0, lg, j, snap_fn(ids[j * cp : (j + 1) * cp], cp,
                                        layers=(l0, lg) if n_groups > 1 else None))
                 for g, (l0, lg) in enumerate(plan) for j in range(n_chunks)]
        swa_snap, swa_s0, swa_n = None, 0, 0
        spec = self.runner.swa
        if spec is not None and req.swa_block_ids:
            n_pre, swa_s0, swa_n = spec.section(req.num_prompt_tokens, page)
            R = len(req.swa_block_ids)
            # Once the ring has moved past slot s0 (a long decode), the
            # section holds newer positions: export none (the consumer
            # then recomputes).
            highest_page = max(0, req.num_computed_tokens - 1) // page
            if swa_n <= 0 or highest_page >= swa_s0 + R:
                swa_s0, swa_n = 0, 0
            else:
                ring_ids = [req.swa_block_ids[p % R] for p in range(swa_s0, n_pre)]
                swa_snap = self.runner.snapshot_swa_pages_device(ring_ids, swa_n)
        if cells or swa_snap is not None:
            with self._local_lock:
                # Active from here, not from the thread's start: a claim
                # that lands before the thread runs must stop it too.
                self._staging_active.add(key)
                if cells and self._local_enabled:
                    self._prune_local_locked()
                    self._local_exports[key] = (
                        time.monotonic() + min(self.cfg.lease_ms / 1e3, 5.0),
                        cells, swa_snap, n_groups)
            threading.Thread(target=self._stage_chunks,
                             args=(key, cells, swa_snap, adaptive_stage, n_groups),
                             daemon=True).start()
        self.exported_requests += 1
        out = {
            "remote_host": self.cfg.host,
            "remote_port": self.server.port,
            "remote_key": key,
            "num_full_pages": n_full,
            "page_size": page,
            "chunk_pages": cp,
            "num_chunks": n_chunks,
            "start_page": skip,
            "swa_pages": swa_n,
            "swa_start_page": swa_s0,
        }
        if n_groups > 1:
            out["num_groups"] = n_groups
        self.last_export_ms = (time.monotonic() - t0) * 1e3
        return out

    def _staging_slot_bytes(self) -> int:
        """The most one staging step downloads: a chunk of every pool
        layer in the staging dtype (a q8 pair, int8 rows and two f16
        scales a row, is smaller), or a ring export's largest section."""
        r = self.runner
        item = torch.empty((), dtype=r.staging_dtype).element_size()
        need = math.prod(r.page_shape) * self.CHUNK_PAGES * item
        if r.swa is not None:
            ring = r.kv_swa[0] if isinstance(r.kv_swa, tuple) else r.kv_swa
            section = r.swa.max_section_pages(self.allocator.page_size)
            need = max(need, ring.shape[0] * section * math.prod(ring.shape[2:]) * item)
        return need + self._SLOT_ALIGN

    def _download(self, *snaps: torch.Tensor) -> tuple[list[np.ndarray], torch.Tensor]:
        """Snapshots (a cell, a q8 pair or a ring section) on the host, in
        one pinned staging slot: numpy views of it (``pages_to_numpy``),
        and the slot, which the caller gives back once the views are
        registered (the server keeps a copy)."""
        slot = self._staging.take()
        try:
            views, off = [], 0
            for t in snaps:
                n = t.numel() * t.element_size()
                if off + n > slot.numel():
                    raise ValueError(f"a download of {off + n} bytes exceeds the staging "
                                     f"slot's {slot.numel()}")
                views.append(slot[off : off + n].view(t.dtype).view(t.shape))
                off += -(-n // self._SLOT_ALIGN) * self._SLOT_ALIGN
            # One copy stream: the last copy's event follows the others.
            done = [self.runner.launch_host_copies(t, v) for t, v in zip(snaps, views)][-1]
            self.runner.wait_copies(done)
        except BaseException:
            self._staging.give(slot)
            raise
        return [pages_to_numpy(v) for v in views], slot

    def _prune_local_locked(self) -> None:
        now = time.monotonic()
        for k in [k for k, e in self._local_exports.items() if e[0] < now]:
            del self._local_exports[k]
        while len(self._local_exports) > self.MAX_LOCAL_PENDING:
            self._local_exports.pop(next(iter(self._local_exports)))

    def claim_local(self, key: str) -> tuple | None:
        """An in-process consumer takes the pending device snapshots of
        ``key``: (cells, section snapshot or None, num_groups); the
        staging thread then stops."""
        with self._local_lock:
            self._prune_local_locked()
            entry = self._local_exports.pop(key, None)
            if entry is not None and key in self._staging_active:
                self._local_claimed.add(key)
            self._local_cond.notify_all()
        return None if entry is None else (entry[1], entry[2], entry[3])

    def _stage_chunks(self, key: str, cells: list, swa_snap=None,
                      adaptive_stage: bool = False, n_groups: int = 1) -> None:
        """The staging thread: download each cell (group-major) and
        register it; the ring's section first. A failure leaves later cells
        unregistered: the consumer's pull times out and its policy decides."""
        t0 = time.monotonic()
        staged = 0
        download_s = register_s = 0.0
        with self._local_lock:
            if self._local_enabled and _LOCAL_CONSUMERS:
                deadline = time.monotonic() + self.LOCAL_CLAIM_GRACE_S
                while key not in self._local_claimed and key in self._local_exports:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._local_cond.wait(remaining)
            swa_wanted = swa_snap is not None and key not in self._local_claimed
        runner = self.runner
        try:
            if swa_wanted:
                (pages,), slot = self._download(swa_snap)
                try:
                    self.server.register(swa_key(key), pages, self.cfg.lease_ms,
                                         header=pack_header(pages, crc=payload_crc(pages),
                                                            dtype_name=runner.staging_dtype_name))
                finally:
                    self._staging.give(slot)
                with self._local_lock:
                    self.exported_bytes += pages.nbytes
            itemsize = torch.empty((), dtype=runner.staging_dtype).element_size()
            per_group = len(cells) // n_groups if n_groups else 0
            for g, l0, _lg, j, snap in cells:
                # A lock-free peek: a claim landing meanwhile costs one
                # more download at most.
                if key in self._local_claimed:
                    break
                t_cell = time.monotonic()
                if adaptive_stage and not isinstance(snap, tuple) and self._adaptive_pick_q8():
                    with runner.device_lock:
                        runner._wait_ready(snap)
                        snap = quantize_rows_q8(snap)
                        runner._mark_ready(*snap)
                grp = (g, n_groups, l0) if n_groups > 1 else None
                host, slot = self._download(*(snap if isinstance(snap, tuple) else (snap,)))
                try:
                    t_reg = time.monotonic()
                    if isinstance(snap, tuple):
                        payload, scales = host
                        scales_b = scales.tobytes()
                        header = pack_header_q8(payload, runner.staging_dtype_name,
                                                crc=payload_crc(scales_b, payload),
                                                group=grp) + scales_b
                        orig_bytes = payload.nbytes * itemsize
                    else:
                        (payload,) = host
                        header = pack_header(payload, crc=payload_crc(payload), group=grp,
                                             dtype_name=runner.staging_dtype_name)
                        orig_bytes = payload.nbytes
                    self.server.register(
                        group_key(key, g, j) if n_groups > 1 else chunk_key(key, j),
                        payload, self.cfg.lease_ms, header=header)
                finally:
                    self._staging.give(slot)  # the server holds its own copy
                now = time.monotonic()
                download_s += t_reg - t_cell
                register_s += now - t_reg
                if g == 0 and j == per_group - 1:
                    # Group 0 shipped: the consumer's admission gate opens.
                    self.last_first_group_ms = (now - t0) * 1e3
                self._observe_encoding(isinstance(snap, tuple), orig_bytes, now - t_cell)
                staged += len(header) + payload.nbytes
                with self._local_lock:
                    self.exported_bytes += len(header) + payload.nbytes
        except Exception:
            with self._local_lock:
                self.transfer_failures[("export-staging", "abandon")] += 1
            log.exception("KV export staging failed for %s", key)
        finally:
            self.last_stage_ms = (time.monotonic() - t0) * 1e3
            self.last_staged_bytes = staged
            self.last_download_s, self.last_register_s = download_s, register_s
            with self._local_lock:
                self._staging_active.discard(key)
                self._local_claimed.discard(key)

    # ------------------------------------------------------------------ #
    # consumer

    def wants_import(self, params: dict | None) -> bool:
        return bool(self.cfg.is_consumer and params and params.get("remote_host"))

    def _check_exact(self, payload: np.ndarray, pool_quant: bool, what: str = "KV") -> None:
        """The exact wire keeps the pool's dtype: no silent cast (an int8
        pool requantizes any float dtype)."""
        got, want = wire_dtype_name(payload), self.runner.staging_dtype_name
        if got != want and not pool_quant:
            raise ValueError(f"{what} dtype mismatch: producer {got} vs consumer {want}")

    def fetch_remote(self, prompt_token_ids: list[int], params: dict,
                     handle: KVStreamHandle | None = None) -> PulledBundle:
        """The network half of an import: pull, check, land on the device.
        Runs on a fetch thread. A v3 export (``num_groups`` > 1) streams:
        pool pages are allocated once, each cell is pulled, checked and
        scattered into them while later cells are on the wire, and
        ``handle`` is signalled once group 0 is resident; apply then only
        commits hashes. A ring consumer (or allocation pressure) reassembles
        full-layer chunks instead."""
        page = self.allocator.page_size
        if params.get("page_size") != page:
            raise ValueError(f"page_size mismatch: producer {params.get('page_size')} "
                             f"vs consumer {page}")
        n_full = int(params["num_full_pages"])
        hashes = page_hashes_for_tokens(prompt_token_ids, page)
        if len(hashes) < n_full:
            raise ValueError(f"producer sent {n_full} pages but prompt has only "
                             f"{len(hashes)} full pages")
        ring_mode = self.runner.swa is not None
        n_swa = int(params.get("swa_pages", 0) or 0)
        swa_sp = int(params.get("swa_start_page", 0) or 0)
        if ring_mode and n_swa <= 0:
            raise ValueError("kv_swa_ring consumer requires a sliding-layer section in the "
                             "export (pair it with a kv_swa_ring producer)")
        if ring_mode and int(params.get("start_page", 0) or 0) > 0:
            raise ValueError("kv_swa_ring consumer cannot use a partial export "
                             "(start_page > 0)")
        host, port, key = params["remote_host"], int(params["remote_port"]), params["remote_key"]
        pool_quant = self.runner.kv_quantized
        n_chunks = int(params.get("num_chunks", 0) or 0)
        sp = int(params.get("start_page", 0) or 0)
        if sp > n_full:
            raise ValueError(f"start_page {sp} > num_full_pages {n_full}")
        if n_chunks <= 0 and "start_page" in params:
            # Everything was declared cached here: nothing to pull.
            return PulledBundle(pages=None, hashes=hashes[:n_full], nbytes=0, host=host,
                                port=port, key=key, start_page=n_full)
        if n_chunks <= 0:
            blob = self._pull(host, port, key)
            pages = unpack_pages(blob)
            if pages.shape[1] != n_full:
                raise ValueError(f"bundle holds {pages.shape[1]} pages, expected {n_full}")
            self._check_exact(pages, pool_quant)
            return PulledBundle(pages=pages, hashes=hashes[:n_full], nbytes=len(blob),
                                host=host, port=port, key=key)
        cp = int(params["chunk_pages"])
        if cp <= 0 or -(-(n_full - sp) // cp) != n_chunks:
            raise ValueError(f"chunk geometry mismatch: {n_full - sp} pages / {cp} per chunk "
                             f"!= {n_chunks} chunks")
        n_groups = int(params.get("num_groups", 1) or 1)
        grouped = n_groups > 1
        all_keys = transfer_keys(params)
        if self.cfg.local_fastpath:
            producer = _lookup_local(host, port)
            claimed = producer.claim_local(key) if producer is not None else None
            if claimed is not None:
                cells, swa_snap, _ = claimed
                if ring_mode and swa_snap is None:
                    raise ValueError("local claim carried no sliding-layer snapshot")
                self.local_imports += 1
                if grouped and not ring_mode:
                    bundle = self._claim_streamed(cells, hashes, n_full, sp, cp, host, port,
                                                  key, all_keys, handle)
                    if bundle is not None:
                        return bundle
                dev = ([(j, l0, lg, snap) for _g, l0, lg, j, snap in cells] if grouped
                       else [snap for *_, snap in cells])
                return PulledBundle(pages=None, hashes=hashes[:n_full], nbytes=0, host=host,
                                    port=port, key=key, keys=all_keys, device_chunks=dev,
                                    chunk_pages=cp, start_page=sp,
                                    swa_device=swa_snap if ring_mode else None,
                                    swa_start_page=swa_sp, swa_count=n_swa)
        # Skip whole chunks the local prefix cache holds already.
        skip0 = 0
        while skip0 < n_full and self.allocator.has_cached(hashes[skip0]):
            skip0 += 1
        j0 = max(0, (skip0 - sp) // cp) if skip0 > sp else 0
        start_page = sp + j0 * cp
        if grouped:
            return self._fetch_grouped_wire(params, hashes, n_full, sp, cp, n_chunks, j0,
                                            n_groups, host, port, key, all_keys, ring_mode,
                                            n_swa, swa_sp, pool_quant, handle)
        # A per-chunk deadline, renewed on progress, and an overall one of
        # 2 s a chunk past the first wait.
        per_chunk_s = min(self.cfg.lease_ms / 1e3, 20.0)
        hard_deadline = time.monotonic() + per_chunk_s + 2.0 * (n_chunks + 1)
        np_chunks, dev_chunks, nbytes = [], [], 0
        swa_np = None
        if ring_mode and n_swa:
            blob = self._pull(host, port, swa_key(key),
                                min(time.monotonic() + per_chunk_s, hard_deadline))
            swa_np = self._section(blob, n_swa, pool_quant)
            nbytes += len(blob)
        for j in range(j0, n_chunks):
            blob = self._pull(host, port, chunk_key(key, j),
                                min(time.monotonic() + per_chunk_s, hard_deadline))
            decoded = unpack_pages_any(blob)
            if decoded[1].shape[1] != cp:
                raise ValueError(f"chunk {j} holds {decoded[1].shape[1]} pages, expected {cp}")
            if decoded[0] == "q8":
                entry = (decoded[1], decoded[2])
                dev_chunks.append(self.runner.upload_pages_device_q8(*entry))
            else:
                self._check_exact(decoded[1], pool_quant)
                entry = decoded[1]
                dev_chunks.append(self.runner.upload_pages_device(host_tensor(entry)))
            np_chunks.append(entry)
            nbytes += len(blob)
        return PulledBundle(pages=None, hashes=hashes[:n_full], nbytes=nbytes, host=host,
                            port=port, key=key, keys=all_keys, device_chunks=dev_chunks,
                            np_chunks=np_chunks, chunk_pages=cp, start_page=start_page,
                            swa_pages_np=swa_np, swa_start_page=swa_sp, swa_count=n_swa)

    def _pull(self, host: str, port: int, key: str, deadline: float | None = None) -> bytes:
        """One pull (``_faulty_pull``), its seconds and bytes added to the
        import's wire leg (``last_pull_s``, ``last_pulled_bytes``)."""
        t0 = time.monotonic()
        blob = _faulty_pull(host, port, key, deadline)
        self.last_pull_s += time.monotonic() - t0
        self.last_pulled_bytes += len(blob)
        return blob

    def _section(self, blob: bytes, n_swa: int, pool_quant: bool) -> np.ndarray:
        """A ring export's section pages, checked."""
        pages = unpack_pages(blob)
        if pages.shape[1] != n_swa:
            raise ValueError(f"sliding section holds {pages.shape[1]} pages, expected {n_swa}")
        self._check_exact(pages, pool_quant, "sliding-section KV")
        return pages

    def _note_first_group(self, handle: KVStreamHandle | None) -> None:
        self.last_first_group_ms = (time.monotonic() - self._fetch_t0) * 1e3
        if handle is not None:
            handle.mark_first_group()

    def _stream_alloc(self, need: int) -> list[int] | None:
        """Pages of a streamed import, allocated once: never more than a
        quarter of the pool, and only with an eighth (at least 16 pages)
        left over; None takes the buffered path."""
        if need <= 0:
            return []
        if need > self.allocator.num_pages // 4:
            return None
        try:
            return self.allocator.allocate_with_floor(need, max(self.allocator.num_pages // 8, 16))
        except NoFreePagesError:
            return None

    def _claim_streamed(self, cells, hashes, n_full, sp, cp, host, port, key, all_keys,
                        handle) -> PulledBundle | None:
        """A claimed v3 export: every device cell scattered into streamed
        pages on this thread; None under allocation pressure."""
        stream_ids = self._stream_alloc(n_full - sp)
        if stream_ids is None:
            return None
        n_chunks = max(j for _g, _l0, _lg, j, _s in cells) + 1 if cells else 0
        try:
            for g, l0, lg, j, snap in cells:
                ids_j = _pad_chunk_ids(stream_ids[j * cp : (j + 1) * cp], cp)
                self.runner.scatter_pages_from_device(ids_j, snap, layers=(l0, lg))
                with self._local_lock:
                    self.stream_groups_total += 1
                if g == 0 and j == n_chunks - 1:
                    self._note_first_group(handle)
        except Exception:
            self.allocator.free(stream_ids)
            raise
        return PulledBundle(pages=None, hashes=hashes[:n_full], nbytes=0, host=host, port=port,
                            key=key, keys=all_keys, chunk_pages=cp, start_page=sp,
                            stream_ids=stream_ids)

    def _fetch_grouped_wire(self, params, hashes, n_full, sp, cp, n_chunks, j0, n_groups,
                            host, port, key, all_keys, ring_mode, n_swa, swa_sp, pool_quant,
                            handle) -> PulledBundle:
        """The wire leg of a v3 import: streamed into allocated pages, or
        (a ring consumer, allocation pressure) reassembled into full-layer
        f32 chunks applied as a v2 import is."""
        plan = self._group_plan(n_groups)
        start_page = sp + j0 * cp
        stream_ids = None if ring_mode else self._stream_alloc(n_full - start_page)
        per_chunk_s = min(self.cfg.lease_ms / 1e3, 20.0)
        n_cells = n_groups * max(n_chunks - j0, 0)
        hard_deadline = time.monotonic() + per_chunk_s + 2.0 * (n_cells + 1)
        np_bufs: dict[int, np.ndarray] = {}
        nbytes = 0
        swa_np = None
        try:
            if ring_mode and n_swa:
                blob = self._pull(host, port, swa_key(key),
                                    min(time.monotonic() + per_chunk_s, hard_deadline))
                swa_np = self._section(blob, n_swa, pool_quant)
                nbytes += len(blob)
            for g, (l0, lg) in enumerate(plan):
                for j in range(j0, n_chunks):
                    blob = self._pull(host, port, group_key(key, g, j),
                                        min(time.monotonic() + per_chunk_s, hard_deadline))
                    decoded = unpack_pages_any(blob)
                    payload = decoded[1]
                    frame = bundle_group_info(blob)
                    if frame != (g, n_groups, l0):
                        raise ValueError(f"group frame mismatch at cell g{g}c{j}: wire says "
                                         f"(group {frame[0]}/{frame[1]}, layer0 {frame[2]}), "
                                         f"expected (group {g}/{n_groups}, layer0 {l0})")
                    if payload.shape[0] != lg or payload.shape[1] != cp:
                        raise ValueError(f"cell g{g}c{j} holds {payload.shape[0]}x"
                                         f"{payload.shape[1]} layers x pages, expected {lg}x{cp}")
                    if decoded[0] == "exact":
                        self._check_exact(payload, pool_quant)
                    if stream_ids is not None:
                        o0 = sp + j * cp - start_page
                        ids_j = _pad_chunk_ids(stream_ids[o0 : o0 + cp], cp)
                        if decoded[0] == "q8":
                            # An int8 pool takes the pair as it is; a float
                            # pool dequantizes it on the device.
                            dev = self.runner.upload_pages_device_q8(decoded[1], decoded[2])
                        else:
                            dev = self.runner.upload_pages_device(host_tensor(payload))
                        self.runner.scatter_pages_from_device(ids_j, dev, layers=(l0, lg))
                    else:
                        if decoded[0] == "q8":
                            vals = _dequant_chunk((decoded[1], decoded[2]))
                        else:
                            vals = _as_f32(payload)
                        buf = np_bufs.get(j)
                        if buf is None:
                            # f32 holds every staging dtype exactly.
                            _, _, K, pg, inner = payload.shape
                            buf = np_bufs[j] = np.empty((self._pool_layers, cp, K, pg, inner),
                                                        np.float32)
                        buf[l0 : l0 + lg] = vals
                    with self._local_lock:
                        self.stream_groups_total += 1
                    nbytes += len(blob)
                if g == 0:
                    self._note_first_group(handle)
        except Exception:
            if stream_ids is not None:
                self.allocator.free(stream_ids)
            raise
        return PulledBundle(pages=None, hashes=hashes[:n_full], nbytes=nbytes, host=host,
                            port=port, key=key, keys=all_keys,
                            np_chunks=[np_bufs[j] for j in sorted(np_bufs)], chunk_pages=cp,
                            start_page=start_page, stream_ids=stream_ids, swa_pages_np=swa_np,
                            swa_start_page=swa_sp, swa_count=n_swa)

    def streaming_import(self, params: dict | None) -> bool:
        """Whether ``params`` are a v3 import this consumer admits at its
        first group: a cache-seeding consumer under policy 'recompute'."""
        return bool(self.wants_import(params)
                    and int(params.get("num_groups", 1) or 1) > 1
                    and self.runner.swa is None
                    and self.cfg.load_failure_policy == "recompute")

    def make_stream_handle(self, params: dict) -> KVStreamHandle:
        return KVStreamHandle(self, params)

    def fetch_remote_policy(self, prompt_token_ids: list[int], params: dict,
                            handle: KVStreamHandle | None = None) -> PulledBundle | None:
        """``fetch_remote`` under the load-failure policy: None on a failure
        under 'recompute', KVLoadError under 'fail'; with ``handle`` the
        outcome is published through it as well."""
        t0 = self._fetch_t0 = time.monotonic()
        self.last_pull_s, self.last_pulled_bytes = 0.0, 0
        try:
            bundle = self.fetch_remote(prompt_token_ids, params, handle)
            if handle is not None:
                handle.resolve(bundle)
            return bundle
        except (PullError, OSError, ValueError, KeyError, TypeError, struct.error) as e:
            self.import_failures += 1
            if isinstance(e, KVCorruptionError):
                self.crc_failures += 1
            policy = self.cfg.load_failure_policy
            self.transfer_failures[("fetch", policy)] += 1
            if handle is not None:
                handle.fail(str(e))
            if policy == "fail":
                raise KVLoadError(str(e)) from e
            self.recompute_fallbacks += 1
            log.warning("remote KV load failed, recomputing locally: %s", e)
            return None
        finally:
            self.last_fetch_ms = (time.monotonic() - t0) * 1e3

    def _adaptive_pick_q8(self) -> bool:
        """The encoding of the next adaptive cell: the two forms alternate
        until both have a rate, then the faster, with every 8th export
        probing the other."""
        with self._local_lock:
            self._adaptive_exports += 1
            exact, q8 = self._enc_rate["exact"], self._enc_rate["q8"]
            if exact is None or q8 is None:
                return self._adaptive_exports % 2 == 0
            best_q8 = q8 > exact
            if self._adaptive_exports % 8 == 0:
                return not best_q8
            return best_q8

    def _observe_encoding(self, q8: bool, orig_bytes: int, dt_s: float) -> None:
        if dt_s <= 0 or orig_bytes <= 0:
            return
        k = "q8" if q8 else "exact"
        rate = orig_bytes / dt_s
        with self._local_lock:
            prev = self._enc_rate[k]
            self._enc_rate[k] = rate if prev is None else 0.7 * prev + 0.3 * rate

    def release_bundle(self, bundle: PulledBundle) -> None:
        """Dispose of a bundle that will not be applied: free its streamed
        pages and free-notify the producer."""
        if bundle.stream_ids is not None:
            self.allocator.free(bundle.stream_ids)
            bundle.stream_ids = None
        self._notify_free_async(bundle)

    @staticmethod
    def _chunk_layers(idx: int, entry) -> tuple[int, Any, tuple[int, int] | None]:
        """(chunk index, device cell, layer slice) of a device chunk: a
        claimed v3 cell carries its own, a whole-layer chunk its position."""
        if isinstance(entry, tuple) and len(entry) == 4:
            j, l0, lg, dev = entry
            return j, dev, (l0, lg)
        return idx, entry, None

    def apply_bundle(self, prompt_token_ids: list[int], bundle: PulledBundle) -> int:
        """The engine thread's half: seed the prefix cache with the bundle
        (scatters and commits); the free-notify goes out on a thread. No
        free pages degrades to a recompute. Returns the pages adopted."""
        t_apply = time.monotonic()
        page = self.allocator.page_size
        hashes = bundle.hashes
        n_full = len(hashes)
        skip = 0
        while skip < n_full and self.allocator.has_cached(hashes[skip]):
            skip += 1
        skip = max(skip, bundle.start_page)
        if bundle.stream_ids is not None:
            parent = None if skip == 0 else hashes[skip - 1]
            adopted = 0
            for i, pid in enumerate(bundle.stream_ids):
                idx = bundle.start_page + i
                if idx >= n_full or idx < skip:
                    continue
                self.allocator.commit_page(pid, hashes[idx],
                                           prompt_token_ids[idx * page : (idx + 1) * page], parent)
                parent = hashes[idx]
                adopted += 1
            self.allocator.free(bundle.stream_ids)
            bundle.stream_ids = None
            self.stream_imports += 1
            self._imported(bundle, t_apply)
            return adopted
        if bundle.device_chunks and not bundle.np_chunks:
            # A claimed bundle keeps no host chunks: re-import from its
            # start (duplicate hashes dedup at commit).
            skip = bundle.start_page
        adopted = 0
        if skip < n_full:
            try:
                page_ids = self.allocator.allocate(n_full - skip)
            except NoFreePagesError as e:
                self.import_failures += 1
                self.transfer_failures[("apply", "recompute")] += 1
                self.recompute_fallbacks += 1
                log.warning("no free pages for KV import, recomputing: %s", e)
                self._notify_free_async(bundle)
                return 0
            try:
                if bundle.device_chunks:
                    cp = bundle.chunk_pages
                    for idx, entry in enumerate(bundle.device_chunks):
                        j, dev, layers = self._chunk_layers(idx, entry)
                        p0 = bundle.start_page + j * cp
                        if p0 + cp <= skip:
                            continue  # cached since the fetch
                        if p0 >= skip:
                            ids_j = _pad_chunk_ids(page_ids[p0 - skip : p0 - skip + cp], cp)
                            self.runner.scatter_pages_from_device(ids_j, dev, layers=layers)
                        else:
                            # The cache grew between fetch and apply: the
                            # uncached tail from the host chunk.
                            want = _dequant_chunk(bundle.np_chunks[j])[:, skip - p0 :]
                            take = min(p0 + cp, n_full) - skip
                            self.runner.scatter_pages(page_ids[:take],
                                                      host_tensor(want[:, :take]))
                elif bundle.pages is not None or bundle.np_chunks:
                    want = bundle.host_pages(n_full)[:, skip - bundle.start_page :]
                    self.runner.scatter_pages(page_ids, host_tensor(want))
                parent = None if skip == 0 else hashes[skip - 1]
                for i, pid in enumerate(page_ids):
                    idx = skip + i
                    self.allocator.commit_page(pid, hashes[idx],
                                               prompt_token_ids[idx * page : (idx + 1) * page],
                                               parent)
                    parent = hashes[idx]
            finally:
                # The pages stay cached (ref 0) for the request's hit; a
                # failed scatter refunds them.
                self.allocator.free(page_ids)
            adopted = len(page_ids)
        self._imported(bundle, t_apply)
        return adopted

    def _imported(self, bundle: PulledBundle, t_apply: float) -> None:
        self.imported_requests += 1
        self.imported_bytes += bundle.nbytes
        self._notify_free_async(bundle)
        self.last_apply_ms = (time.monotonic() - t_apply) * 1e3

    def apply_preload(self, prompt_token_ids: list[int], bundle: PulledBundle,
                      swa_allocator: PageAllocator, ring_pages: int) -> dict[str, Any] | None:
        """A ring engine's import: the full-group pages into fresh pool
        pages and the section into a fresh ring at its slots, handed to the
        request (``block_ids``, ``swa_block_ids``, ``tokens`` computed).
        All or nothing: a failure frees everything and returns None."""
        t_apply = time.monotonic()
        page = self.allocator.page_size
        n_full = len(bundle.hashes)
        n_pre, s0, _ = self.runner.swa.section(len(prompt_token_ids), page)
        if (n_pre <= 0 or bundle.swa_count <= 0 or bundle.start_page != 0
                or (bundle.swa_pages_np is None and bundle.swa_device is None)):
            self._notify_free_async(bundle)
            return None
        page_ids: list[int] = []
        ring_ids: list[int] = []
        try:
            # The section must match the consumer's own geometry.
            if (n_full < n_pre or bundle.swa_start_page != s0
                    or bundle.swa_start_page + bundle.swa_count < n_pre
                    or n_pre - s0 <= 0 or n_pre - s0 > ring_pages):
                raise ValueError(f"sliding section [{bundle.swa_start_page}, "
                                 f"+{bundle.swa_count}) over {n_full} pages does not match the "
                                 f"required window [{s0}, {n_pre}) (ring {ring_pages} pages)")
            # Every exported page lands (pad writes into real pages), and
            # the request keeps the first n_pre.
            page_ids = self.allocator.allocate(n_full)
            ring_ids = swa_allocator.allocate(ring_pages)
            if bundle.device_chunks:
                cp = bundle.chunk_pages
                for idx, entry in enumerate(bundle.device_chunks):
                    j, dev, layers = self._chunk_layers(idx, entry)
                    p0 = bundle.start_page + j * cp
                    self.runner.scatter_pages_from_device(
                        _pad_chunk_ids(page_ids[p0 : p0 + cp], cp), dev, layers=layers)
            elif bundle.pages is not None or bundle.np_chunks:
                self.runner.scatter_pages(page_ids, host_tensor(bundle.host_pages(n_full)))
            else:
                raise ValueError("preload bundle carries no full-group data")
            n_swa = min(bundle.swa_count, n_pre - bundle.swa_start_page)
            swa_ids = [ring_ids[(bundle.swa_start_page + i) % ring_pages] for i in range(n_swa)]
            if bundle.swa_device is not None:
                self.runner.scatter_pages_from_device(swa_ids, bundle.swa_device[:, :n_swa],
                                                      swa=True)
            else:
                self.runner.scatter_pages(swa_ids, host_tensor(bundle.swa_pages_np[:, :n_swa]),
                                          swa=True)
        except (NoFreePagesError, ValueError, KeyError, TypeError) as e:
            self.import_failures += 1
            self.transfer_failures[("preload", "recompute")] += 1
            self.recompute_fallbacks += 1
            log.warning("KV ring preload failed, recomputing locally: %s", e)
            if page_ids:
                self.allocator.free(page_ids)
            if ring_ids:
                swa_allocator.free(ring_ids)
            self._notify_free_async(bundle)
            return None
        if len(page_ids) > n_pre:
            self.allocator.free(page_ids[n_pre:])
            page_ids = page_ids[:n_pre]
        self._imported(bundle, t_apply)
        return {"block_ids": page_ids, "swa_block_ids": ring_ids, "tokens": n_pre * page}

    @staticmethod
    def _notify_free_async(bundle: PulledBundle) -> None:
        keys = bundle.keys or [bundle.key]

        def notify() -> None:
            for k in keys:
                shipper_mod.free_notify(bundle.host, bundle.port, k)

        threading.Thread(target=notify, daemon=True).start()

    # ------------------------------------------------------------------ #

    def stats(self) -> dict[str, Any]:
        with self._local_lock:
            exported_bytes = self.exported_bytes
            groups = self.stream_groups_total
            rate_exact, rate_q8 = self._enc_rate["exact"], self._enc_rate["q8"]
        out = {
            "stream_groups_total": groups,
            "last_first_group_ms": round(self.last_first_group_ms, 2),
            "exported_requests": self.exported_requests,
            "exported_bytes": exported_bytes,
            "imported_requests": self.imported_requests,
            "imported_bytes": self.imported_bytes,
            "import_failures": self.import_failures,
            "crc_failures": self.crc_failures,
            "recompute_fallbacks": self.recompute_fallbacks,
            "transfer_failures": dict(self.transfer_failures),
            "local_imports": self.local_imports,
            "stream_imports": self.stream_imports,
            "enc_rate_exact_mbps": round((rate_exact or 0.0) / 2**20, 2),
            "enc_rate_q8_mbps": round((rate_q8 or 0.0) / 2**20, 2),
            "last_stage_ms": round(self.last_stage_ms, 1),
            "last_fetch_ms": round(self.last_fetch_ms, 1),
            "last_apply_ms": round(self.last_apply_ms, 1),
        }
        if self.server is not None:
            out["registered_count"] = self.server.registered_count
            out["registered_bytes"] = self.server.registered_bytes
            out["expired_count"] = self.server.expired_count
        return out

    def close(self) -> None:
        _LOCAL_CONSUMERS.discard(self)
        if self.server is not None:
            if _LOCAL_PRODUCERS.get(self.server.port) is self:
                del _LOCAL_PRODUCERS[self.server.port]
            self.server.close()
            self.server = None
        with self._local_lock:
            self._local_exports.clear()
