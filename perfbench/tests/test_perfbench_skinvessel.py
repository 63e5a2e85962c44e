"""The skin-vessel cell's driver (``cw_shapes``) on a tiny copy, on the CPU.

The tiny checkout gains, as new files only, a 24^3 configuration with
the skin-vessel's structure (water over epidermis over dermis, a vessel
along x; five media rows, 5 um voxels, 50 ns) built by the port's shape
rasteriser, and a cell of it, entered in the copy's ``BENCHMARK.json``
beside the real ones as ``tiny.py`` enters its own.
"""

import json

import pytest

from perfbench import harness
from perfbench.tests import tiny

CELL = "tiny.sv"
SHAPES = [{"Grid": {"Tag": 1, "Size": [24, 24, 24]}},
          {"ZLayers": [[1, 3, 1], [4, 5, 4], [6, 24, 3]]},
          {"Cylinder": {"Tag": 2, "C0": [0, 12.5, 12.5],
                        "C1": [24, 12.5, 12.5], "R": 3}}]


def add_tiny_skinvessel(root):
    """Add the tiny configuration and its cell to a tiny checkout."""
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "skinvessel.json").read_text())
    vol = cfg["volume"]
    vol.pop("port_preset")
    vol.update(shape=[24, 24, 24], shapes=SHAPES)
    cfg["source"].update(pos=[12.0, 12.0, 3.0], radius=6.0)
    (pb / "configs" / "tinySV.json").write_text(json.dumps(cfg))
    w = json.loads((pb / "workloads" / "skinvessel.cw.json").read_text())
    w.update(photons=2000, lanes=512, steps_per_round=8, warmup_photons=256)
    (pb / "workloads" / f"{CELL}.json").write_text(json.dumps(w))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tinySV", "source": "tiny copy of skinvessel",
        "file": "perfbench/configs/tinySV.json", "reduced": [],
        "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tinySV",
                               "traffic": "cw", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "skinvessel.cw" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return add_tiny_skinvessel(
        tiny.checkout(tmp_path_factory.mktemp("checkout")))


def test_run_is_correct_with_the_labels_compared(root):
    out = tiny.run(root, CELL)
    assert out["correct"] is True, out
    assert out["failed"] == 0
    assert set(out["metrics"]) == {"photons_per_ms", "setup_s"}
    checks = out["checks"]
    assert set(checks) == {"solutions_failed", "fluence_cells_off",
                           "exitance_cells_off", "totals_off", "labels_off"}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in checks.values())


def test_the_cells_per_layer_readers_on_a_made_up_trace(root):
    """A traced run needs the card, so the three readers read a made-up
    trace: the idle share, the step's roofline share on this
    configuration's voxels, exitance bins and five media rows, and the
    host-read spans' share of the window."""
    from perfbench import roofline
    from perfbench.profiling import Trace
    from repro_torch import telemetry as T

    bench = harness.benchmark(root)
    names = [m["name"] for m in harness.metrics_of(bench, CELL, True)]
    assert names == ["device_idle.sv", "photon_step_roofline.sv",
                     "host_read_share.sv"]
    cell = harness.find_cell(bench, "skinvessel.cw", tiny.ROOT, 1, "cpu")
    cell.workload["live_segments_per_photon"] = {"mean": 340.0}
    trace = Trace(window_s=2.0, busy_s=0.5, device_events=10, step_s=0.25,
                  other_s=0.1, device_ops=[], idle_gaps=[])
    run = {"cell": cell, "trace": trace,
           "profiled": [{"photons": 10**7, "rounds": 1100}] * 2}
    spans = T.capture_tracer().events
    spans.clear()
    try:
        for k in range(4):
            spans.append(T.SpanEvent(name="round.host_read", device="cuda:0",
                                     t0=100.0 + k, dur=0.125))
        got = {n: harness.reader(root, n).read(run) for n in names}
    finally:
        spans.clear()
    least = roofline.least_seconds(340.0 * 10**7, 200**3, 200**2, 5)
    assert got == pytest.approx({
        "device_idle.sv": 0.75,
        "photon_step_roofline.sv": 100.0 * 2 * least["seconds"] / 0.25,
        "host_read_share.sv": 0.25})
    assert all(harness.reader(root, n).read(dict(run, trace=None)) is None
               for n in names)


def test_a_port_volume_with_one_label_flipped_is_not_correct(root,
                                                             monkeypatch):
    from repro_torch.core import volume as V

    real = V.volume_from_shapes

    def flipped(*args, **kw):
        vol = real(*args, **kw)
        vol.labels[23, 0, 23] = 4     # a dermis corner voxel as epidermis
        return vol

    monkeypatch.setattr(V, "volume_from_shapes", flipped)
    out = tiny.run(root, CELL)
    assert out["correct"] is False
    assert out["checks"]["labels_off"]["value"] == 1


def test_control_is_rejected(root):
    from perfbench import control

    (out,) = control.readings(CELL, [6], device="cpu", root=root)
    assert all(v == 0 for v in out["sound"].values()), out
    assert max(out["control"].values()) > 0, out
    assert out["live_segments_per_photon"] > 1


def test_no_existing_perfbench_file_differs(root):
    for old in (tiny.ROOT / "perfbench").rglob("*"):
        if old.is_file() and "__pycache__" not in old.parts:
            new = root / old.relative_to(tiny.ROOT)
            assert new.read_bytes() == old.read_bytes(), new


def test_reference_rasteriser_rejects_what_it_does_not_know():
    from perfbench import shapes

    vol = {"shape": [4, 4, 4], "unitinmm": 1.0, "media": [
        {"tag": 1, "mua": 0.1, "mus": 1.0, "g": 0.9, "n": 1.37}],
           "shapes": [{"Grid": {"Tag": 1, "Size": [4, 4, 4]}},
                      {"Sphere": {"Tag": 1, "O": [2, 2, 2], "R": 1}}]}
    with pytest.raises(ValueError):
        shapes.build(vol)
    vol["shapes"] = [{"ZLayers": [[1, 2, 1]]}]
    with pytest.raises(ValueError):
        shapes.build(vol)
