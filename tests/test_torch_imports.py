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
                 "src/repro_torch/kernels/photon_step/photon_step_cpu.py",
                 "src/repro_torch/kernels/photon_step/regenerate.py",
                 "src/repro_torch/replay/__init__.py",
                 "src/repro_torch/detectors/__init__.py",
                 "src/repro_torch/telemetry/stats.py",
                 "src/repro_torch/telemetry/trace.py",
                 "src/repro_torch/telemetry/sinks.py",
                 "src/repro_torch/telemetry/__init__.py",
                 "src/repro_torch/core/loadbalance.py",
                 "src/repro_torch/core/shapes.py",
                 "src/repro_torch/scenarios/__init__.py",
                 "src/repro_torch/sources/types.py",
                 "src/repro_torch/sources/base.py",
                 "src/repro_torch/core/multidevice.py",
                 "src/repro_torch/checkpoint/__init__.py",
                 "src/repro_torch/checkpoint/checkpointer.py",
                 "src/repro_torch/resilience/__init__.py",
                 "src/repro_torch/resilience/faults.py",
                 "src/repro_torch/resilience/policy.py",
                 "src/repro_torch/resilience/validate.py",
                 "src/repro_torch/resilience/pool.py",
                 "src/repro_torch/core/procs.py",
                 "src/repro_torch/lint/__init__.py",
                 "src/repro_torch/lint/__main__.py",
                 "src/repro_torch/lint/astutil.py",
                 "src/repro_torch/lint/baseline.py",
                 "src/repro_torch/lint/rules/__init__.py",
                 "src/repro_torch/lint/rules/mirror.py",
                 "src/repro_torch/lint/rules/determinism.py",
                 "src/repro_torch/lint/rules/dtype.py",
                 "src/repro_torch/lint/rules/hostsync.py",
                 "src/repro_torch/lint/rules/smem.py",
                 "src/repro_torch/lint/rules/reach.py",
                 "src/repro_torch/lint/rules/bench.py",
                 "src/repro_torch/lint/traced/__init__.py",
                 "src/repro_torch/lint/traced/rules.py",
                 "src/repro_torch/lint/traced/targets.py",
                 "src/repro_torch/examples/__init__.py",
                 "src/repro_torch/examples/quickstart.py",
                 "src/repro_torch/examples/source_gallery.py",
                 "src/repro_torch/examples/heterogeneous_lb.py",
                 "src/repro_torch/examples/fault_tolerant_campaign.py",
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
