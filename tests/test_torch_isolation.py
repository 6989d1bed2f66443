"""The PyTorch port stands alone: it imports neither JAX nor the JAX package.

A subprocess imports every module of ``gen2_rfid_tpu_torch`` and
``chip_smoke.py`` with ``jax`` and ``gen2_rfid_tpu`` made unimportable, and
an AST scan of every port source shows no import of either.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "gen2_rfid_tpu_torch"
PORT_FILES = sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "gen2_rfid_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("rel", PORT_FILES + ["chip_smoke.py"])
def test_no_jax_import_in_source(rel):
    bad = [m for m in _imported_modules(REPO / rel) if _forbidden(m)]
    assert not bad, f"{rel} imports {bad}"


# The root scripts the bench twins (gen2_rfid_tpu_torch/tools/bench*.py) mirror.
ROOT_BENCH = ("bench", "bench_configs", "bench_scaling")
BENCH_TWINS = [f"gen2_rfid_tpu_torch/tools/{name}.py" for name in ROOT_BENCH]


@pytest.mark.parametrize("rel", BENCH_TWINS)
def test_bench_twins_import_no_root_script(rel):
    """A twin imports its siblings relatively; an absolute ``bench*`` import
    would be the root JAX script."""
    assert rel in PORT_FILES
    bad = [m for m in _imported_modules(REPO / rel) if m.split(".")[0] in ROOT_BENCH]
    assert not bad, f"{rel} imports {bad}"


def test_forbidden_names_do_not_match_the_port():
    assert not _forbidden("gen2_rfid_tpu_torch.runtime.inventory")
    assert _forbidden("gen2_rfid_tpu.runtime") and _forbidden("jax.numpy")


def test_port_imports_with_jax_unimportable():
    code = f"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["gen2_rfid_tpu"] = None
sys.path.insert(0, {str(REPO)!r})
import gen2_rfid_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    gen2_rfid_tpu_torch.__path__, "gen2_rfid_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert callable(chip_smoke.main)
bad = [m for m, v in sys.modules.items() if v is not None
       and (m in ("jax", "gen2_rfid_tpu") or m.startswith(("jax.", "gen2_rfid_tpu.")))]
assert not bad, bad
print(len(names))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15
