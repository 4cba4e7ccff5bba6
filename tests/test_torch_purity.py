"""The port imports neither JAX nor the JAX package: checked in a fresh
process by importing every module of ``trustworthy_dl_tpu_torch`` and
reading ``sys.modules``, and statically by walking every module's imports
(``chip_smoke.py`` included)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.torchport

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "trustworthy_dl_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import trustworthy_dl_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "roots = ('jax', 'jaxlib', 'trustworthy_dl_tpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in roots]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('trustworthy_dl_tpu_torch.')]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_port_module_imports_jax():
    files = sorted((REPO / "trustworthy_dl_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) >= 16
    bad = [(str(p.relative_to(REPO)), name) for p in files
           for name in _imports(p) if _forbidden(name)]
    assert not bad, bad
