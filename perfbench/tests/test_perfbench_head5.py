"""The five-layer head cell's driver (``detect_shapes``) on a tiny copy,
on the CPU.

The tiny checkout gains, as new files only, a 24 x 24 x 20 configuration
with the head's five layers (1 mm voxels, the same media) built by the
port's shape rasteriser, two detectors, reflection on, 10 gates and
records, and a cell of it, entered in the copy's ``BENCHMARK.json``
beside the real ones as ``tiny.py`` enters its own.
"""

import json

import pytest

from perfbench import harness
from perfbench.tests import tiny

CELL = "tiny.head5"
SHAPES = [{"Grid": {"Tag": 5, "Size": [24, 24, 20]}},
          {"ZLayers": [[1, 3, 1], [4, 10, 2], [11, 12, 3], [13, 16, 4]]}]
NAMES = ["device_idle.head5", "photon_step_roofline.head5",
         "nonstep_ms_per_round.head5", "device_ops_per_round.head5",
         "records_host_share.head5"]


def add_tiny_head5(root):
    """Add the tiny configuration and its cell to a tiny checkout."""
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "head5.json").read_text())
    vol = cfg["volume"]
    vol.pop("port_preset")
    vol.update(shape=[24, 24, 20], shapes=SHAPES)
    cfg["source"].update(pos=[12.0, 12.0, 0.0])
    cfg["detectors"] = [{"x": 15, "y": 12, "radius": 2},
                        {"x": 19, "y": 12, "radius": 2}]
    (pb / "configs" / "tinyHead5.json").write_text(json.dumps(cfg))
    w = json.loads((pb / "workloads" / "head5.td.json").read_text())
    w.update(photons=1500, lanes=512, steps_per_round=8, warmup_photons=256,
             time_gates=10, record_slots=4096)
    (pb / "workloads" / f"{CELL}.json").write_text(json.dumps(w))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tinyHead5", "source": "tiny copy of head5",
        "file": "perfbench/configs/tinyHead5.json", "reduced": [],
        "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tinyHead5",
                               "traffic": "td", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "head5.td" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return add_tiny_head5(tiny.checkout(tmp_path_factory.mktemp("checkout")))


def test_run_is_correct_with_every_number_compared(root):
    out = tiny.run(root, CELL)
    assert out["correct"] is True, out
    assert out["failed"] == 0
    assert set(out["metrics"]) == {"photons_per_ms", "setup_s"}
    checks = out["checks"]
    assert set(checks) == {"solutions_failed", "fluence_cells_off",
                           "exitance_cells_off", "totals_off",
                           "tpsf_cells_off", "ppath_sums_off", "records_off",
                           "labels_off"}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in checks.values())


def test_solution_records_at_both_detectors(root):
    drv = tiny.driver(root, CELL)
    sol = drv.solve(0)
    stats = drv.stats(sol)
    assert stats["records"] > 10 and stats["rounds"] > 0
    assert set(sol.records[:, 2].tolist()) == {0, 1}
    assert drv.quick_check(sol) == []


def test_a_dropped_record_is_not_correct(root, monkeypatch):
    from repro_torch import replay

    real = replay.detected_records
    monkeypatch.setattr(replay, "detected_records",
                        lambda result: real(result)[1:])
    out = tiny.run(root, CELL)
    assert out["correct"] is False
    assert out["checks"]["records_off"]["value"] > 0


def test_a_flipped_label_is_not_correct(root, monkeypatch):
    from repro_torch.core import volume as V

    real = V.volume_from_shapes

    def flipped(*args, **kw):
        vol = real(*args, **kw)
        vol.labels[23, 0, 19] = 4     # a white-matter corner as gray matter
        return vol

    monkeypatch.setattr(V, "volume_from_shapes", flipped)
    out = tiny.run(root, CELL)
    assert out["correct"] is False
    assert out["checks"]["labels_off"]["value"] == 1


def test_a_changed_tpsf_entry_is_not_correct(root, monkeypatch):
    """One TPSF entry altered where the step adds into it (the third of
    the run's grids: fluence, exitance, TPSF, path sums)."""
    from repro_torch.core import simulator

    real = simulator.photon_steps

    def altered(*args, totals=None, **kw):
        outs = real(*args, totals=totals, **kw)
        totals[2].view(-1)[3] += 1
        return outs

    monkeypatch.setattr(simulator, "photon_steps", altered)
    out = tiny.run(root, CELL)
    assert out["correct"] is False
    assert out["checks"]["tpsf_cells_off"]["value"] > 0
    assert out["checks"]["fluence_cells_off"]["value"] == 0


def test_the_cells_per_layer_readers_on_a_made_up_trace(root):
    """A traced run needs the card, so the five readers read a made-up
    trace: the idle share, the step's roofline share on the head's grid,
    gates, detectors and records, the non-step device time and device
    operations a round, and the records spans' share of the window."""
    from perfbench import roofline
    from perfbench.profiling import Trace
    from repro_torch import telemetry as T

    bench = harness.benchmark(root)
    assert [m["name"] for m in harness.metrics_of(bench, CELL, True)] == NAMES
    assert [m["name"] for m in harness.metrics_of(bench, "head5.td",
                                                  True)] == NAMES
    cell = harness.find_cell(bench, "head5.td", tiny.ROOT, 1, "cpu")
    cell.workload["live_segments_per_photon"] = {"mean": 1200.0}
    trace = Trace(window_s=2.0, busy_s=1.5, device_events=4000, step_s=0.5,
                  other_s=0.02, device_ops=[], idle_gaps=[])
    profiled = [{"photons": 3 * 10**6, "rounds": 500, "records": 20000}] * 2
    run = {"cell": cell, "trace": trace, "profiled": profiled}
    spans = T.capture_tracer().events
    spans.clear()
    try:
        for k in range(4):
            spans.append(T.SpanEvent(name="round.records", device="cuda:0",
                                     t0=100.0 + k, dur=0.0005))
        got = {n: harness.reader(root, n).read(run) for n in NAMES}
    finally:
        spans.clear()
    segments = 1200.0 * 3 * 10**6
    mufu = roofline.MUFU_OPS_PER_SEGMENT * segments / roofline.MUFU_OPS_PER_S
    assert got == pytest.approx({
        "device_idle.head5": 0.25,
        "photon_step_roofline.head5": 100.0 * 2 * mufu / 0.5,
        "nonstep_ms_per_round.head5": 0.02e3 / 1000,
        "device_ops_per_round.head5": 4.0,
        "records_host_share.head5": 0.001})
    roof = harness.reader(root, "photon_step_roofline.head5")
    nvox = 120 * 120 * 60
    hbm = (nvox + 16 * 6 + 8 * (nvox * 50 + 120 * 120 + 4 * 50 + 4 * 6)
           + 32 * 20000) / roofline.HBM_BYTES_PER_S
    assert roof.least_seconds(0.0, nvox, 120 * 120, 6, 4, 50,
                              20000) == pytest.approx(hbm)
    assert all(harness.reader(root, n).read(dict(run, trace=None)) is None
               for n in NAMES)
    # an older port records no such span: the share is left out
    assert harness.reader(root, NAMES[-1]).read(run) is None


def test_control_is_rejected(root):
    from perfbench import control

    (out,) = control.readings(CELL, [6], device="cpu", root=root)
    assert all(v == 0 for v in out["sound"].values()), out
    assert max(out["control"].values()) > 0, out
    assert out["live_segments_per_photon"] > 100


def test_a_port_without_the_preset_fails_in_set_up(monkeypatch):
    """The real cell on a port that lacks ``benchmark_head5`` (the
    parent's) fails at once, before any kernel is built or run."""
    import torch

    from repro_torch.core import volume as V

    monkeypatch.delattr(V, "benchmark_head5")
    cell = harness.find_cell(harness.benchmark(tiny.ROOT), "head5.td",
                             tiny.ROOT, 1, torch.device("cpu"))
    drv = harness.driver(cell)
    with pytest.raises(AttributeError, match="benchmark_head5"):
        drv.set_up()


def test_no_existing_perfbench_file_differs(root):
    for old in (tiny.ROOT / "perfbench").rglob("*"):
        if old.is_file() and "__pycache__" not in old.parts:
            new = root / old.relative_to(tiny.ROOT)
            assert new.read_bytes() == old.read_bytes(), new
