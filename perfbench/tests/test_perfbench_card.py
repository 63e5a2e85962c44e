"""Each cell of the benchmark, on the card, through its command."""

import json
import subprocess
import sys

import pytest

from perfbench.tests import tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "3000000017", "--seconds", "2", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, out.stderr[-3000:]
    assert line["device"]["platform"] == "gpu"
