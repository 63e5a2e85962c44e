"""A configuration, a cell and a metric added as new files only.

The tiny checkout adds two configurations and three cells as new files
and ``BENCHMARK.json`` entries; this test adds a metric as well, a
reader of its own, and the harness lists and runs all of them with no
file of ``perfbench/`` edited.
"""

import json

from perfbench import harness
from perfbench.tests import tiny


def test_new_files_only(tmp_path):
    root = tiny.checkout(tmp_path)
    (root / "perfbench" / "metrics" / "solutions_per_s.tiny.py").write_text(
        "def read(run):\n"
        "    return len(run['solutions']) / run['window_s']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({
        "name": "solutions_per_s.tiny", "unit": "1/s", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": ["tiny.cw"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for old in (tiny.ROOT / "perfbench").rglob("*"):
        if old.is_file() and "__pycache__" not in old.parts:
            new = root / old.relative_to(tiny.ROOT)
            assert new.read_bytes() == old.read_bytes(), new
    names = [m["name"] for m in harness.metrics_of(bench, "tiny.cw", False)]
    assert names == ["photons_per_ms", "setup_s", "solutions_per_s.tiny"]
    traced = [m["name"] for m in harness.metrics_of(bench, "tiny.cw", True)]
    assert "photon_step_roofline.cw" in traced
    out = tiny.run(root, "tiny.cw")
    assert out["correct"] is True
    assert out["metrics"]["solutions_per_s.tiny"]["value"] > 0
    assert set(out["metrics"]) == set(names)
