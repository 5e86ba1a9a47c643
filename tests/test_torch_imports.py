"""Import hygiene of the port: ``llmd_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package ``llmd_tpu``, nor ``safetensors`` or
``ml_dtypes`` (the loader reads safetensors files itself), nor ``zmq`` (the
KV events' publisher speaks ZMTP itself, ``events/zmtp.py``), and importing
them loads no ``transformers`` or ``tokenizers`` (only ``load_tokenizer`` of
an HF tokenizer imports transformers, when it is called).

Module names are matched exactly or by their dotted prefix:
``"llmd_tpu_torch".startswith("llmd_tpu")`` is true, so a bare prefix
test would flag the port itself.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "llmd_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "llmd_tpu", "safetensors", "ml_dtypes", "zmq")
# Imported lazily where needed, never by importing a module.
NOT_AT_IMPORT = ("transformers", "tokenizers")


def forbidden(module: str, names=FORBIDDEN) -> bool:
    return any(module == f or module.startswith(f + ".") for f in names)


def port_files():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path: pathlib.Path) -> set[str]:
    """Every module an ``import`` or ``from ... import`` names, at any
    depth of the file (function bodies included)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def test_forbidden_matches_by_dotted_prefix_only():
    assert forbidden("jax") and forbidden("jax.numpy") and forbidden("llmd_tpu")
    assert forbidden("llmd_tpu.ops.kv_write")
    assert not forbidden("llmd_tpu_torch") and not forbidden("llmd_tpu_torch.ops")
    assert not forbidden("jaxtyping_like") and not forbidden("numpy")
    assert forbidden("safetensors.torch") and forbidden("ml_dtypes")
    assert forbidden("zmq") and forbidden("zmq.asyncio") and not forbidden("zmqlike")
    assert forbidden("transformers.models", NOT_AT_IMPORT) and not forbidden("transformers")


@pytest.mark.parametrize("path", port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax_or_the_jax_package(path):
    bad = sorted(m for m in imported_modules(path) if forbidden(m))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_module_loads_neither():
    """In a fresh interpreter, import every module of the package (and
    ``chip_smoke.py``) and list what landed in ``sys.modules``."""
    code = f"""
import importlib, json, pkgutil, runpy, sys
import llmd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(llmd_tpu_torch.__path__, "llmd_tpu_torch.")]
for n in names:
    importlib.import_module(n)
runpy.run_path({str(ROOT / "chip_smoke.py")!r}, run_name="chip_smoke")
print(json.dumps({{"imported": names, "modules": sorted(sys.modules)}}))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "llmd_tpu_torch.serve.api" in report["imported"]
    assert "llmd_tpu_torch.ops.kv_write" in report["imported"]
    assert "llmd_tpu_torch.ops.paged_attention" in report["imported"]
    assert "llmd_tpu_torch.profile_step" in report["imported"]
    assert "llmd_tpu_torch.models.loader" in report["imported"]
    assert "llmd_tpu_torch.kvtransfer.shipper" in report["imported"]
    assert "llmd_tpu_torch.kvtransfer.connector" in report["imported"]
    for name in ("events.zmtp", "events.publisher", "federation.core", "federation.wire",
                 "kvstore.client", "kvstore.master", "kvstore.__main__"):
        assert f"llmd_tpu_torch.{name}" in report["imported"]
    assert [m for m in report["modules"] if forbidden(m)] == []
    assert [m for m in report["modules"] if forbidden(m, NOT_AT_IMPORT)] == []
