"""The P/D transfer plane of the port (``kvtransfer/connector.py``,
``kvtransfer/shipper.py``, the runner's page functions) against the JAX
package's, on the CPU.

The wire is the JAX package's byte for byte: headers of versions 1, 2 and 3
(exact and q8, f32 and bf16) are equal for the same pages, each side
unpacks the other's whole bundles, and a flipped payload byte fails the
CRC on both. The q8 row codec and the pool/wire scale converters are bit
for bit JAX's (all-zero, tiny and f16-overflowing halves included). The
runner's snapshots, downloads, uploads and scatters equal the JAX runner's
on f32, bf16, int8 (f32 and bf16 models) and MLA latent pools, whole and
as a layer slice, and on the sliding-window ring pool; int8 pools take a
q8 pair's bytes as they are. The shippers interoperate both ways (the
port's server with JAX's client, JAX's Python server with the port's
client), and the port's leases run on a clock the test controls.
"""

import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llmd_tpu.config as jcfg
import llmd_tpu_torch.config as tcfg
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine.runner import _dequantize_rows_q8, _quantize_rows_q8
from llmd_tpu.kvtransfer import connector as jconn
from llmd_tpu.kvtransfer import native as jnative
from llmd_tpu.kvtransfer import shipper as jship
from llmd_tpu.models.registry import get_model_config as jax_model_config
from llmd_tpu_torch.engine import LLMEngine
from llmd_tpu_torch.kvtransfer import connector as tconn
from llmd_tpu_torch.kvtransfer import shipper as tship
from llmd_tpu_torch.models.llama import params_from_jax
from llmd_tpu_torch.models.registry import get_model_config
from llmd_tpu_torch.ops.quant_kv import (
    dequantize_rows_q8,
    pool_scales_to_wire,
    quantize_rows_q8,
    wire_scales_to_pool,
)

from test_torch_spec import jax_compile_cache, one_thread  # noqa: F401 (module fixtures)


def bits(a) -> np.ndarray:
    """An array's bits: bf16 (``ml_dtypes``', the port's ``uint16`` or a
    tensor) as ``uint16``, anything else as it is."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def rows(shape, seed: int, dtype=np.float32) -> np.ndarray:
    """Random K|V rows with the codec's edge cases: an all-zero row, a row
    with an all-zero half, tiny values whose f16 scale underflows, and
    (f32 only) a half whose scale overflows f16."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.01, 30, shape[:-1] + (1,))
    flat = x.reshape(-1, shape[-1])
    D = shape[-1] // 2
    flat[0] = 0.0
    flat[1, :D] = 0.0
    flat[2] *= 1e-9
    if dtype == np.float32:
        flat[3, D:] *= 1e7
    return x


# --------------------------------------------------------------------- #
# the q8 codec and the scale converters


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_codec_is_jax(dtype):
    x = rows((2, 3, 2, 4, 16), 1, np.float32 if dtype == "float32" else None)
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    jq, js = _quantize_rows_q8(jx)
    tq, ts = quantize_rows_q8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16 and ts.shape == (2, 3, 2, 4, 2)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint16), np.asarray(js).view(np.uint16))
    for out in ("float32", "bfloat16"):
        # Equal values; the f16-overflowing half dequantizes to NaN (0 x
        # inf) on both sides, whose bf16 NaN bits may differ.
        got = dequantize_rows_q8(tq, ts, getattr(torch, out)).float().numpy()
        want = np.asarray(_dequantize_rows_q8(jq, js, out).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)
        assert np.isnan(got).any() == (dtype == "float32")


def test_scale_converters_round_trip():
    """Pool scales are f32 on the f16 grid: to the wire (f16) and back is
    lossless, as JAX's ``astype(float16)`` and widening."""
    s = np.random.default_rng(2).uniform(1e-4, 5, (2, 3, 2, 4, 2)).astype(np.float16)
    pool = torch.from_numpy(s.astype(np.float32))
    wire = pool_scales_to_wire(pool)
    assert wire.dtype == torch.float16
    np.testing.assert_array_equal(wire.numpy(), s)
    back = wire_scales_to_pool(wire)
    assert back.dtype == torch.float32 and torch.equal(back, pool)
    from llmd_tpu.ops.quant_kv import pool_scales_to_wire as jp, wire_scales_to_pool as jw

    np.testing.assert_array_equal(np.asarray(jp(jnp.asarray(s.astype(np.float32))).astype(jnp.float16)),
                                  wire.numpy())
    np.testing.assert_array_equal(np.asarray(jw(s)).astype(np.float32), back.numpy())


# --------------------------------------------------------------------- #
# the wire


def page_sets():
    """The same pages as JAX holds them and as the port does (bf16 as
    ``ml_dtypes`` and as ``uint16`` bits)."""
    x = np.random.default_rng(3).standard_normal((3, 2, 2, 4, 16)).astype(np.float32)
    j16 = np.asarray(jnp.asarray(x, dtype=jnp.bfloat16))
    return {"float32": (x, x), "bfloat16": (j16, j16.view(np.uint16))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["v1", "v2", "v3"])
def test_exact_headers_and_blobs_are_jax(dtype, form):
    jpages, tpages = page_sets()[dtype]
    body = tpages.tobytes()
    assert body == jpages.tobytes()
    crc = None if form == "v1" else tconn.payload_crc(tpages)
    assert crc == (None if form == "v1" else jconn.payload_crc(jpages.view(np.uint8)))
    group = (1, 3, 1) if form == "v3" else None
    th = tconn.pack_header(tpages, crc=crc, group=group)
    assert th == jconn.pack_header(jpages, crc=crc, group=group)
    assert th[4] == int(form[1]) and (b"bfloat16" in th) == (dtype == "bfloat16")
    blob = th + body
    # Each side unpacks the other's (the same blob).
    got = tconn.unpack_pages_any(blob)
    assert got[0] == "exact" and got[1].dtype == tpages.dtype
    np.testing.assert_array_equal(got[1], tpages)
    np.testing.assert_array_equal(bits(jconn.unpack_pages(blob)), bits(jpages))
    assert tconn.bundle_group_info(blob) == jconn.bundle_group_info(blob) == (group or (0, 1, 0))
    if form != "v1":
        bad = bytearray(blob)
        bad[len(bad) - 3] ^= 0x40
        with pytest.raises(tconn.KVCorruptionError):
            tconn.unpack_pages_any(bytes(bad))
        with pytest.raises(jconn.KVCorruptionError):
            jconn.unpack_pages_any(bytes(bad))
    if form == "v2":
        assert blob == jconn.pack_pages(jpages)


@pytest.mark.parametrize("form", ["v1", "v2", "v3"])
def test_q8_headers_and_blobs_are_jax(form):
    x = rows((2, 2, 2, 4, 16), 4)
    jq, js = (np.asarray(a) for a in _quantize_rows_q8(jnp.asarray(x)))
    tq, ts = (t.numpy() for t in quantize_rows_q8(torch.from_numpy(x)))
    np.testing.assert_array_equal(tq, jq)
    scales_b = ts.tobytes()
    crc = None if form == "v1" else tconn.payload_crc(scales_b, tq)
    group = (0, 2, 0) if form == "v3" else None
    th = tconn.pack_header_q8(tq, "bfloat16", crc=crc, group=group)
    assert th == jconn.pack_header_q8(jq, "bfloat16", crc=crc, group=group)
    blob = th + scales_b + tq.tobytes()
    kind, q, s, orig = tconn.unpack_pages_any(blob)
    jkind, jq2, js2, jorig = jconn.unpack_pages_any(blob)
    assert (kind, orig) == (jkind, jorig) == ("q8", "bfloat16")
    np.testing.assert_array_equal(q, jq2)
    np.testing.assert_array_equal(s.view(np.uint16), js2.view(np.uint16))
    np.testing.assert_array_equal(tconn._dequant_chunk((q, s)), jconn.PulledBundle._dequant_chunk((jq2, js2)))


def test_keys_groups_and_the_compat_pins_are_jax(monkeypatch):
    for L in (1, 3, 4, 7, 27):
        for g in (1, 2, 4, 9):
            assert tconn.layer_groups(L, g) == jconn.layer_groups(L, g)
    for params in ({"remote_key": "k", "num_chunks": 2},
                   {"remote_key": "k", "num_chunks": 3, "num_groups": 4},
                   {"remote_key": "k", "num_chunks": 0},
                   {"remote_key": "k", "num_chunks": 2, "num_groups": 1, "swa_pages": 3}):
        assert tconn.transfer_keys(params) == jconn.transfer_keys(params)
    x = np.ones((1, 1, 1, 2, 4), np.float32)
    monkeypatch.setattr(tconn, "_COMPAT_V1", True)
    monkeypatch.setattr(jconn, "_COMPAT_V1", True)
    assert tconn.pack_header(x, crc=5) == jconn.pack_header(x, crc=5)
    assert tconn.pack_header(x, crc=5)[4] == 1


# --------------------------------------------------------------------- #
# the runner's page functions

RUNNERS = {
    "f32": (None, dict(), "float32"),
    "bf16": (None, dict(dtype="bfloat16"), "bfloat16"),
    "int8-f32": (None, dict(), "int8"),
    "int8-bf16": (None, dict(dtype="bfloat16"), "int8"),
    "mla-bf16": ("tiny-mla", dict(dtype="bfloat16"), "bfloat16"),
    "ring-f32": (None, dict(num_layers=4, num_heads=4, num_kv_heads=2, sliding_window=8,
                            layer_types=("sliding_attention", "full_attention") * 2), "float32"),
}


def runner_pair(kind):
    """A JAX runner and the port's on one config (the port's on the JAX
    parameters), their pools (and ring pools) filled with the same seeded
    values, an int8 pool's scales on the f16 grid."""
    name, model, kv_dtype = RUNNERS[kind]
    ring = kind.startswith("ring")
    cache = dict(page_size=4, num_blocks=12, dtype=kv_dtype, swa_ring=ring,
                 enable_prefix_caching=not ring)
    sched = dict(max_num_batched_tokens=32)
    jm = jax_model_config(name, **model) if name else jcfg.tiny_model_config(**model)
    tm = get_model_config(name, **model) if name else tcfg.tiny_model_config(**model)
    j = JaxEngine(jcfg.EngineConfig(model=jm, cache=jcfg.CacheConfig(**cache),
                                    scheduler=jcfg.SchedulerConfig(**sched),
                                    parallel=jcfg.ParallelConfig())).runner
    params = params_from_jax(jax.tree.map(np.asarray, j.params))
    p = LLMEngine(tcfg.EngineConfig(model=tm, cache=tcfg.CacheConfig(**cache),
                                    scheduler=tcfg.SchedulerConfig(**sched)),
                  params=params, device="cpu").runner
    rng = np.random.default_rng(5)
    for attr in ("kv_cache", "kv_swa") if ring else ("kv_cache",):
        tpool, jpool = getattr(p, attr), getattr(j, attr)
        if isinstance(tpool, tuple):
            data = rng.integers(-127, 128, size=tpool[0].shape).astype(np.int8)
            scales = rng.uniform(0.004, 0.02, size=tpool[1].shape).astype(np.float16).astype(np.float32)
            setattr(j, attr, (jnp.asarray(data), jnp.asarray(scales)))
            tpool[0].copy_(torch.from_numpy(data))
            tpool[1].copy_(torch.from_numpy(scales))
        else:
            n = min(tpool.shape[1], jpool.shape[1])
            vals = rng.standard_normal(jpool.shape).astype(np.float32)
            setattr(j, attr, jnp.asarray(vals, dtype=jpool.dtype))
            tpool[:, :n].copy_(torch.from_numpy(vals[:, :n]).to(tpool.dtype))
    return j, p


def pool_bits(pool, n: int | None = None) -> list[np.ndarray]:
    return [bits(t)[:, :n] for t in (pool if isinstance(pool, tuple) else (pool,))]


def assert_pools_equal(p, j, attr="kv_cache"):
    tp, jp = getattr(p, attr), getattr(j, attr)
    n = (jp[0] if isinstance(jp, tuple) else jp).shape[1]
    for a, b in zip(pool_bits(tp, n), pool_bits(jp, n)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", [k for k in RUNNERS if not k.startswith("ring")])
def test_page_functions_are_jax_runners(kind):
    j, p = runner_pair(kind)
    ptrs = [t.data_ptr() for t in (p.kv_cache if p.kv_quantized else (p.kv_cache,))]
    L = p.page_shape[0]
    assert p.staging_dtype_name == j.staging_dtype_name
    for layers in (None, (1, L - 1)):
        snap = p.snapshot_pages_device([7, 2, 11], 4, layers=layers)
        want = j.download_pages(j.snapshot_pages_device([7, 2, 11], 4, layers=layers))
        got = p.download_pages(snap)
        assert got.shape == want.shape
        np.testing.assert_array_equal(bits(got), bits(want))
        if kind.startswith("mla"):
            continue
        q8 = p.snapshot_pages_device_q8([5, 3], 2, layers=layers)
        jq8 = j.snapshot_pages_device_q8([5, 3], 2, layers=layers)
        np.testing.assert_array_equal(p.download_pages(q8[0]), j.download_pages(jq8[0]))
        np.testing.assert_array_equal(p.download_pages(q8[1]).view(np.uint16),
                                      j.download_pages(jq8[1]).view(np.uint16))
    # Scatters: a float bundle whole and as a layer slice, a device
    # bundle, and (not MLA) a q8 bundle, whose pair an int8 pool takes as
    # it is; the port's pool tensors do not move.
    rng = np.random.default_rng(9)
    shape = (L, 2, *p.page_shape[1:])
    jdt = j.staging_dtype
    bundle = np.asarray(jnp.asarray(rng.standard_normal(shape), dtype=jdt))
    j.scatter_pages([1, 9], bundle)
    p.scatter_pages([1, 9], bundle)
    j.scatter_pages([4, 6], bundle[1:], layers=(1, L - 1))
    p.scatter_pages([4, 6], bundle[1:], layers=(1, L - 1))
    j.scatter_pages_from_device([0, 8], j.upload_pages_device(bundle))
    p.scatter_pages_from_device([0, 8], p.upload_pages_device(bundle))
    assert_pools_equal(p, j)
    if not kind.startswith("mla"):
        x = rows((L, 2, *p.page_shape[1:]), 6, None)  # no NaN (its bits may differ)
        q, s = (np.asarray(a) for a in _quantize_rows_q8(jnp.asarray(x)))
        j.scatter_pages_q8([3, 10], q, s)
        p.scatter_pages_q8([3, 10], q, s)
        j.scatter_pages_from_device([5, 2], j.upload_pages_device_q8(q[1:], s[1:]),
                                    layers=(1, L - 1))
        p.scatter_pages_from_device([5, 2], p.upload_pages_device_q8(q[1:], s[1:]),
                                    layers=(1, L - 1))
        assert_pools_equal(p, j)
        if p.kv_quantized:
            # The int8 pool holds the wire's bytes and scales exactly.
            np.testing.assert_array_equal(p.kv_cache[0][:, [3, 10]].numpy(), q)
            np.testing.assert_array_equal(p.kv_cache[1][:, [3, 10]].numpy(), s.astype(np.float32))
    assert ptrs == [t.data_ptr() for t in (p.kv_cache if p.kv_quantized else (p.kv_cache,))]


def test_ring_page_functions_are_jax_runners():
    """The ring pool's snapshots and scatters (a ring export's section)."""
    j, p = runner_pair("ring-f32")
    ptr = p.kv_swa.data_ptr()
    got = p.download_pages(p.snapshot_swa_pages_device([3, 1, 5], 3))
    want = j.download_pages(j.snapshot_swa_pages_device([3, 1, 5], 3))
    np.testing.assert_array_equal(got, want)
    vals = np.random.default_rng(4).standard_normal(want.shape).astype(np.float32)
    j.scatter_pages([7, 0, 2], vals, swa=True)
    p.scatter_pages([7, 0, 2], vals, swa=True)
    j.scatter_pages_from_device([4], j.upload_pages_device(vals[:, :1]), swa=True)
    p.scatter_pages_from_device([4], p.upload_pages_device(vals[:, :1]), swa=True)
    assert_pools_equal(p, j, "kv_swa")
    assert_pools_equal(p, j, "kv_cache")
    assert p.kv_swa.data_ptr() == ptr


# --------------------------------------------------------------------- #
# the shippers


@pytest.fixture
def jax_python_server(monkeypatch):
    monkeypatch.setattr(jnative, "load", lambda: None)
    srv = jship.ShipperServer(port=0)
    assert srv.backend == "python"
    yield srv
    srv.close()


def test_port_server_serves_the_jax_client(monkeypatch):
    monkeypatch.setattr(jnative, "load", lambda: None)
    srv = tship.ShipperServer(port=0)
    try:
        data = np.arange(4096, dtype=np.uint16)
        srv.register("k1", data, lease_ms=60_000, header=b"HDR")
        srv.register("k2", b"two", lease_ms=60_000)
        assert jship.pull("127.0.0.1", srv.port, "k1") == b"HDR" + data.tobytes()
        assert jship.stat("127.0.0.1", srv.port) == (2, 3 + data.nbytes + 3)
        assert jship.pull_many("127.0.0.1", srv.port, ["k2", "gone", "k1"]) == {
            "k2": b"two", "k1": b"HDR" + data.tobytes()}
        assert jship.renew("127.0.0.1", srv.port, "k2", 60_000)
        assert not jship.renew("127.0.0.1", srv.port, "gone", 60_000)
        assert jship.free_notify("127.0.0.1", srv.port, "k2")
        with pytest.raises(jship.PullError) as e:
            jship.pull("127.0.0.1", srv.port, "k2")
        assert e.value.status == jship.ST_NOT_FOUND
        assert (srv.registered_count, srv.registered_bytes) == (1, 3 + data.nbytes)
    finally:
        srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.register("k3", b"x")


def test_port_client_pulls_from_the_jax_server(jax_python_server):
    srv = jax_python_server
    srv.register("a", b"A" * 100_000, lease_ms=60_000, header=b"h")
    srv.register("b", b"B", lease_ms=60_000)
    assert tship.pull("127.0.0.1", srv.port, "a") == b"h" + b"A" * 100_000
    assert tship.pull_many("127.0.0.1", srv.port, ["b", "zz", "a"]) == {
        "b": b"B", "a": b"h" + b"A" * 100_000}
    assert tship.stat("127.0.0.1", srv.port) == (2, 100_002)
    assert tship.renew("127.0.0.1", srv.port, "b", 60_000)
    assert tship.free_notify("127.0.0.1", srv.port, "b")
    assert not tship.free_notify("127.0.0.1", srv.port, "b")
    with pytest.raises(tship.PullError) as e:
        tship.pull_wait("127.0.0.1", srv.port, "b", deadline=0.0)
    assert e.value.status == tship.ST_NOT_FOUND


def test_leases_on_a_clock_the_test_sets():
    """A lease ends at its time on the server's clock; a renew (the
    consumer's heartbeat over the wire) moves it; the reaper counts what
    it dropped. No wall-clock wait: the clock is the test's and the
    reaper is called by hand."""
    now = [100.0]
    srv = tship.ShipperServer(port=0, clock=lambda: now[0], reap_period_s=3600)
    try:
        srv.register("short", b"x" * 8, lease_ms=1_000)
        srv.register("kept", b"y" * 8, lease_ms=1_000)
        now[0] = 100.5
        assert jship.renew("127.0.0.1", srv.port, "kept", 5_000)  # until 105.5
        assert srv.reap() == 0
        now[0] = 101.0
        assert srv.reap() == 1 and srv.expired_count == 1
        with pytest.raises(tship.PullError):
            tship.pull("127.0.0.1", srv.port, "short")
        now[0] = 105.4
        assert srv.reap() == 0
        assert tship.pull("127.0.0.1", srv.port, "kept") == b"y" * 8
        now[0] = 105.5
        assert srv.reap() == 1 and srv.registered_count == 0
    finally:
        srv.close()


def test_a_bad_request_closes_only_its_connection():
    srv = tship.ShipperServer(port=0)
    try:
        import socket

        with socket.create_connection(("127.0.0.1", srv.port), timeout=5) as s:
            s.sendall(struct.pack("<IBH", 0xDEADBEEF, 1, 0))
            assert s.recv(9) == b""  # the server hung up
        srv.register("k", b"ok")
        assert tship.pull("127.0.0.1", srv.port, "k") == b"ok"
        assert zlib.crc32(b"ok") == tconn.payload_crc(b"o", b"k")
    finally:
        srv.close()
