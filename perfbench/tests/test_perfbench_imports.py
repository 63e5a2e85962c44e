"""What the benchmark's command loads, and what the reference loads.

Names are compared by their top-level part taken whole, so the port,
``repro_torch``, is not mistaken for the JAX package, ``repro``.
"""

import json
import subprocess
import sys

import pytest

from perfbench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _modules(script: str, cwd) -> set[str]:
    out = subprocess.run([sys.executable, "-c", script], cwd=cwd,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


TOP = ("import json, sys; print(json.dumps(sorted("
       "{m.split('.')[0] for m in sys.modules})))")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("checkout"))


def test_command_path_loads_no_jax_and_no_jax_package(root):
    script = (
        "import sys; sys.path.insert(0, 'perfbench')\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('r', "
        "'perfbench/run.py')\n"
        "m = importlib.util.module_from_spec(spec); "
        "spec.loader.exec_module(m)\n"
        "out = m.run(['--workload', 'tiny.cw', '--seed', '3', "
        "'--seconds', '0.5'], device='cpu')\n"
        "assert out['correct'], out\n" + TOP)
    mods = _modules(script, root)
    assert "repro_torch" in mods and "torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_reference_loads_nothing_of_the_port(root):
    script = (
        "import sys; sys.path.insert(0, '.')\n"
        "import json, torch\n"
        "from perfbench import port, harness\n"
        "from perfbench.reference import transport\n"
        "cell = harness.find_cell(harness.benchmark(harness.pathlib.Path("
        "'.')), 'tiny.detect', harness.pathlib.Path('.'), 1, "
        "torch.device('cpu'))\n"
        "i = port.Inputs(cell)\n"
        "f = transport.forward(i.labels_dev, i.media_dev, i.shape, i.unit, "
        "i.physics, i.source, 1, 2**40, 500, det_geom=i.det_geom(), "
        "record=True)\n"
        "assert f.n_launched == 500\n" + TOP)
    mods = _modules(script, root)
    assert not mods & (FORBIDDEN | {"repro_torch"})


def test_names_are_compared_whole(monkeypatch):
    run = tiny.harness.load_module(tiny.ROOT / "perfbench" / "run.py",
                                   "perfbench_run_names")
    monkeypatch.setitem(sys.modules, "repro_torch_like.sub", object())
    assert run.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in run.forbidden_modules()


def test_refuses_without_the_port(tmp_path):
    """A directory that holds only BENCHMARK.json and perfbench/ prints
    no result and exits with another code than 0."""
    import shutil

    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.ROOT / "perfbench", tmp_path / "perfbench")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "b1.cw",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_without_a_card(root):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "tiny.cw",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
