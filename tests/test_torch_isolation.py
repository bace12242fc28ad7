"""``repro_torch`` and ``chip_smoke.py`` stand alone: no JAX, no ``repro``.

One check imports every module of the port in a fresh interpreter where
``jax`` and ``repro`` cannot be imported; the other scans the sources for
an import of either.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "repro" or name.startswith("repro."):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Block())
sys.modules["jax"] = None
sys.path[:0] = [SRC, ROOT]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
bad = [m for m in sys.modules if m == "jax" and sys.modules[m] is not None
       or m.startswith("jax.") or m == "repro" or m.startswith("repro.")]
assert not bad, bad
print(" ".join(names))
print(len(names))
"""


def test_every_port_module_imports_without_jax_or_repro():
    code = (_IMPORT_ALL.replace("SRC", repr(str(ROOT / "src")))
            .replace("ROOT", repr(str(ROOT))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    *_, names, count = out.stdout.strip().splitlines()
    assert int(count) >= 84
    for sub in ("experiments", "launch", "experiments.durability",
                "fl.resume", "train.checkpoint", "fl.async_plane",
                "fl.population", "core.threefry", "serving",
                "serving.engine", "serving.sampler", "launch.serve",
                "kernels.autograd", "models.remat", "models.encdec",
                "launch.train",
                "launch.fl_spmd"):
        assert f"repro_torch.{sub}" in names.split()


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)
