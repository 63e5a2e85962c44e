"""The port and chip_smoke.py import neither JAX nor the JAX package.

An AST scan of every module of ``src/repro_torch`` and of the root
``chip_smoke.py``: no ``jax``/``jaxlib`` import and no ``repro`` or
``repro.*`` import, at any depth of the file.
"""

import ast
import pathlib

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    assert path.exists(), path
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(REPO).as_posix() for p in FILES}
    for must in ("src/repro_torch/core/simulator.py",
                 "src/repro_torch/kernels/photon_step/photon_step.py",
                 "chip_smoke.py"):
        assert must in names


def test_scan_catches_forbidden_imports(tmp_path):
    for src in ("import jax\n", "from repro.core import rng\n",
                "import repro\n", "def f():\n    import jax.numpy as jnp\n",
                "import importlib\nimportlib.import_module('repro.core')\n"):
        f = tmp_path / "m.py"
        f.write_text(src)
        assert set(_imported_roots(f)) & set(FORBIDDEN), src
    f = tmp_path / "ok.py"
    f.write_text("import torch\nfrom repro_torch.core import rng\n")
    assert not set(_imported_roots(f)) & set(FORBIDDEN)
