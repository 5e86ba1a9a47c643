"""Test fixture: run everything on a virtual 8-device CPU mesh.

Mirrors the reference's CPU-backend test substitute (SURVEY.md section 4.5:
the CPU vLLM overlay exercises the full stack without accelerators); a
host-platform device count of 8 lets TP/DP/EP sharding tests run anywhere.

XLA_FLAGS must be set before jax import; the platform override must go
through jax.config (env JAX_PLATFORMS can be pinned by the host harness).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = _flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

# ------------------------------------------------------------------ #
# Lock sanitizer (docs/architecture/static-analysis.md): LLMD_LOCKSAN=1
# arms the instrumented lock wrappers for the whole session — every
# threading.Lock/RLock created from here on records acquisition stacks,
# feeds the global lock-order graph, and flags locks held across an
# asyncio callback boundary. Armed HERE (after the jax import) so jax's
# import-time internals stay raw while every llmd_tpu lock — created in
# __init__ methods during tests — is instrumented.

_LOCKSAN = os.environ.get("LLMD_LOCKSAN") == "1"
# Leak sanitizer (same doc): LLMD_LEAKSAN=1 wraps every registered
# resource manager (PageAllocator pages, AdapterPool slots + admission
# leases, breaker probe grants, flow-control admission tokens,
# kvtransfer staged bundles) with per-handle outstanding maps and
# acquisition backtraces; the autouse gate below fails the test on
# whose watch a handle leaked — background threads included — and the
# session renders a cumulative leaksan_report.json.
_LEAKSAN = os.environ.get("LLMD_LEAKSAN") == "1"
if _LOCKSAN or _LEAKSAN:
    from llmd_tpu.analysis import sanitize as _sanitize

    if _LOCKSAN:
        _sanitize.arm()
    if _LEAKSAN:
        _sanitize.arm_leaksan()


@pytest.fixture(autouse=True)
def _locksan_gate():
    """Fail the test on whose watch the sanitizer recorded a violation —
    including ones raised on background threads and swallowed there."""
    if not _LOCKSAN:
        yield
        return
    _sanitize.drain_violations()  # never blame this test for leftovers
    yield
    vs = _sanitize.drain_violations()
    assert not vs, (
        "lock sanitizer violations during this test: "
        + "; ".join(f"{v['kind']} ({v.get('locks') or v.get('acquired')})"
                    for v in vs)
    )


@pytest.fixture(autouse=True)
def _leaksan_gate(request):
    """Zero-outstanding-at-teardown: every resource handle acquired on
    this test's watch (any thread) must be released, transferred, or
    expired by teardown; violations (double-release, release-without-
    acquire) recorded meanwhile fail the test too."""
    if not _LEAKSAN:
        yield
        return
    _sanitize.leaksan_set_test(request.node.nodeid)
    _sanitize.leaksan_drain_violations()  # leftovers are not ours
    yield
    vs = _sanitize.leaksan_drain_violations()
    leaks = _sanitize.leaksan_check_test(request.node.nodeid, record=True)
    _sanitize.leaksan_set_test("<between-tests>")
    if vs or leaks:
        lines = [
            f"leak sanitizer: {len(leaks)} outstanding handle(s), "
            f"{len(vs)} violation(s) on this test's watch"
        ]
        for v in vs:
            lines.append(
                f"  [{v['kind']}] {v['resource']} {v.get('handle')} "
                f"on {v['manager']} (thread {v['thread']})"
            )
        for r in leaks:
            lines.append(
                f"  [leak] {r['resource']} handle {r['handle']} x"
                f"{r['count']} on {r['manager']} (thread {r['thread']}) "
                "acquired at:"
            )
            lines.extend(f"    {frame}" for frame in r["stack"][-6:])
        raise _sanitize.LeakError("\n".join(lines))


@pytest.fixture
def leaksan():
    """Arm the leak sanitizer for ONE test (no-op when the session is
    already armed, e.g. under the leaksan CI job) — the shared fixture
    for the lifecycle regression pins in test_spec_decode/test_faults
    and any future leak-seam test."""
    from llmd_tpu.analysis import sanitize

    was_armed = sanitize.leaksan_armed()
    if not was_armed:
        sanitize.arm_leaksan()
    sanitize.leaksan_drain_violations()
    try:
        yield sanitize
    finally:
        sanitize.leaksan_drain_violations()
        if not was_armed:
            sanitize.disarm_leaksan()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips without one",
    )


def pytest_sessionfinish(session, exitstatus):
    if _LOCKSAN:
        path = _sanitize.write_report()
        print(f"\nlocksan: report written to {path}")
    if _LEAKSAN:
        path = _sanitize.write_leaksan_report()
        print(f"\nleaksan: report written to {path}")


@pytest.fixture(scope="session")
def devices():
    devs = jax.devices()
    assert len(devs) == 8, devs
    return devs
