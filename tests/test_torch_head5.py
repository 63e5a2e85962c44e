"""The five-layer adult head's time-domain fNIRS probe on the port.

The port builds Okada and Delpy's five z slabs (scalp, skull, CSF, gray
and white matter, 1 mm voxels) from MCX's shape list
(``volume.benchmark_head5``); the benchmark's reference builds its
labels apart (``perfbench/shapes.py``) from the configuration file.  The
two agree voxel for voxel at 120 x 120 x 60, with the same media rows,
physics, probe and record slots.  On a 24 x 24 x 20 slab of the same
layers, with two detectors, reflection on and 10 gates, the port's int64
fixed-point totals, TPSF, path sums and records equal the frozen plain
reference (``perfbench/reference``) bit for bit, on the CPU here and on
the card in the ``cuda``-marked test.  No JAX is imported here.
"""

import argparse
import collections
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import telemetry as T  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402
from repro_torch.launch import simulate as launch  # noqa: E402
from repro_torch.replay import detected_records  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = ROOT / "perfbench" / "configs" / "head5.json"
LAYERS = [[1, 3, 1], [4, 10, 2], [11, 12, 3], [13, 16, 4]]
SMALL_SHAPES = [{"Grid": {"Tag": 5, "Size": [24, 24, 20]}},
                {"ZLayers": LAYERS}]
SMALL_SOURCE = {"type": "pencil", "pos": [12.0, 12.0, 0.0],
                "dir": [0.0, 0.0, 1.0]}
SMALL_DETECTORS = [{"x": 15, "y": 12, "radius": 2},
                   {"x": 19, "y": 12, "radius": 2}]


@pytest.fixture
def bench_modules(monkeypatch):
    """``perfbench.shapes`` and the frozen reference's transport."""
    monkeypatch.syspath_prepend(str(ROOT))
    from perfbench import shapes
    from perfbench.reference import step, transport

    return shapes, step, transport


def small_volume(device="cpu"):
    return V.volume_from_shapes(SMALL_SHAPES, list(V.HEAD5_MEDIA),
                                V.HEAD5_UNITINMM, device)


def small_config(k: int):
    return dataclasses.replace(V.head5_config(), n_time_gates=10,
                               steps_per_round=k)


def det_geom(detectors, device="cpu"):
    rows = [[d["x"], d["y"], float(d["radius"]) * float(d["radius"])]
            for d in detectors]
    return torch.as_tensor(np.asarray(rows, np.float32), device=device)


def reference_run(transport, step, vol, cfg, seed, first, photons):
    phys = step.Physics(do_reflect=cfg.do_reflect, tmax_ns=cfg.tmax_ns,
                        w_threshold=cfg.w_threshold,
                        roulette_m=cfg.roulette_m,
                        n_time_gates=cfg.n_time_gates)
    return transport.forward(vol.labels.reshape(-1), vol.media, vol.shape,
                             vol.unitinmm, phys, SMALL_SOURCE, seed, first,
                             photons, det_geom=det_geom(SMALL_DETECTORS,
                                                        vol.device),
                             record=True)


def by_id(rows) -> np.ndarray:
    rows = np.asarray(rows, np.int64)
    ids = rows[:, 1] << 32 | rows[:, 0]
    return rows[np.argsort(ids, kind="stable")]


def assert_bit_equal(fixed, ref):
    for name in ("fluence", "exitance", "det_w"):
        assert torch.equal(getattr(fixed, name).reshape(-1).cpu(),
                           getattr(ref, name).cpu()), name
    assert torch.equal(fixed.det_ppath.cpu(), ref.det_ppath.cpu())
    got = [int(fixed.escaped), int(fixed.timed_out), int(fixed.launched_w),
           int(fixed.n_launched)]
    assert got == [ref.escaped, ref.timed_out, ref.launched_w,
                   ref.n_launched]
    assert int(fixed.det_rec_overflow) == 0
    mine = detected_records(S.to_sim_result(fixed))
    np.testing.assert_array_equal(by_id(mine), by_id(ref.records.cpu()))


def test_preset_equals_the_benchmarks_rasteriser(bench_modules):
    shapes = bench_modules[0]
    cfg = json.loads(CONFIG.read_text())
    labels, media, unit = shapes.build(cfg["volume"])
    vol = V.benchmark_head5()
    assert vol.shape == (120, 120, 60) and vol.labels.dtype == torch.uint8
    np.testing.assert_array_equal(vol.labels.numpy(), labels)
    np.testing.assert_array_equal(vol.media.numpy(), media)
    assert vol.unitinmm == unit == 1.0
    assert [dict(s) for s in V.HEAD5_SHAPES] == cfg["volume"]["shapes"]
    sim = V.head5_config()
    assert {k: getattr(sim, k) for k in cfg["physics"]} == cfg["physics"]
    assert sim.n_time_gates == 50
    assert sim.gate_width_ns * 1e-9 == pytest.approx(cfg["time"]["Dt_s"])
    assert V.HEAD5_SOURCE == cfg["source"]
    assert launch.bench_source("head5") == cfg["source"]
    assert list(V.HEAD5_DETECTORS) == cfg["detectors"]
    assert V.HEAD5_RECORD_SLOTS == cfg["record_slots"] == 2**20


def test_slabs_follow_the_closed_form():
    """Scalp for k 0-2, skull 3-9, CSF 10-11, gray matter 12-15, white
    matter from k 16 to the floor, the same in every column."""
    labels = V.benchmark_head5().labels.numpy()
    k = np.arange(60)
    want = np.select([k < 3, k < 10, k < 12, k < 16], [1, 2, 3, 4], 5)
    assert (labels == want[None, None, :]).all()
    counts = np.bincount(labels.reshape(-1), minlength=6)
    assert counts.tolist() == [0] + [120 * 120 * t for t in (3, 7, 2, 4, 44)]


@pytest.mark.parametrize("lanes,k,mode", [(256, 8, "dynamic"),
                                          (1000, 3, "static")])
def test_small_case_bit_equal_to_frozen_reference(bench_modules, lanes, k,
                                                  mode):
    _, step, transport = bench_modules
    vol = small_volume()
    cfg = small_config(k)
    seed, first, photons = 2**31 + 29, 2**32 - 600, 1200
    fixed = S.simulate_fixed(vol, cfg, photons, lanes, seed,
                             source=SMALL_SOURCE, mode=mode, device="cpu",
                             detectors=SMALL_DETECTORS,
                             record_detected=4096, id_offset=first)
    ref = reference_run(transport, step, vol, cfg, seed, first, photons)
    assert_bit_equal(fixed, ref)
    assert int(fixed.n_launched) == photons
    # both detectors see photons, in more than one gate, and every
    # layer takes deposits
    tpsf = fixed.det_w.reshape(2, 10)
    assert (tpsf.sum(1) > 0).all() and int((tpsf > 0).sum()) > 2
    assert int(fixed.det_rec_n) == ref.records.shape[0] > 10
    dep = fixed.fluence.reshape(24, 24, 20, 10).sum(-1)
    for tag in range(1, 6):
        assert int(dep[vol.labels == tag].sum()) > 0, tag


def test_records_span_and_run_args_under_a_capture():
    """Under a capture each round issued has a ``round.records`` span
    inside its ``round.totals``, and the ``run`` span notes the records
    kept and those dropped; a run without records records neither."""
    events = T.capture_tracer().events
    events.clear()
    vol, cfg = small_volume(), small_config(8)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            fixed = S.simulate_fixed(vol, cfg, 250, 128, 5,
                                     source=SMALL_SOURCE, device="cpu",
                                     detectors=SMALL_DETECTORS,
                                     record_detected=3)
        spans = collections.defaultdict(list)
        for e in events:
            spans[e.name].append(e)
        totals = {e.span_id for e in spans["round.totals"]}
        assert len(spans["round.records"]) == len(totals) > 0
        assert all(e.parent in totals for e in spans["round.records"])
        (run,) = spans["run"]
        kept, dropped = int(fixed.det_rec_n), int(fixed.det_rec_overflow)
        assert kept == 3 and dropped > 0
        assert run.args["records"] == kept
        assert run.args["record_overflow"] == dropped
        events.clear()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            S.simulate_fixed(vol, cfg, 200, 128, 5, source=SMALL_SOURCE,
                             device="cpu", detectors=SMALL_DETECTORS)
        names = {e.name for e in events}
        assert "round.totals" in names and "round.records" not in names
        (run,) = [e for e in events if e.name == "run"]
        assert "records" not in run.args
        assert "record_overflow" not in run.args
    finally:
        events.clear()


def test_cli_runs_head5_with_its_probe_records_and_counters(tmp_path,
                                                           capsys):
    """The preset's probe and records by default; ``--time-gates 5``
    keeps the CPU's grid small."""
    metrics = tmp_path / "m.jsonl"
    res = launch.main(["--bench", "head5", "--photons", "300", "--lanes",
                       "128", "--steps-per-round", "8", "--device", "cpu",
                       "--time-gates", "5", "--metrics-out", str(metrics)])
    assert int(res.n_launched) == 300
    assert res.energy.shape == (120, 120, 60, 5)
    assert tuple(res.det_w.shape) == (4, 5)
    assert tuple(res.det_ppath.shape) == (4, 6)
    out = capsys.readouterr().out
    assert "head5: 300 photons" in out and "detector 3 (100,60,r=2)" in out
    assert "detected-photon records:" in out
    rows = [json.loads(x) for x in metrics.read_text().splitlines()]
    spans = [r["name"] for r in rows if r["type"] == "span"]
    assert spans == ["volume.shapes", "simulate"]
    counters = {r["name"]: r["value"] for r in rows
                if r["type"] == "counter" and r["name"] != "photons_per_s"}
    assert counters == {"volume.voxels": 864000, "volume.media": 6,
                        "volume.grid_bytes": 8 * (864000 * 5 + 120 * 120),
                        "detectors.n": 4,
                        "records.capacity_bytes": 32 * (2**20 + 1)}


def test_cli_defaults_come_from_the_table_and_flags_override():
    def defaults(bench, **flags):
        args = argparse.Namespace(bench=bench, detectors=None,
                                  save_detected=None, time_gates=None)
        vars(args).update(flags)
        launch.bench_defaults(args)
        return args

    head = defaults("head5")
    assert json.loads(head.detectors) == list(V.HEAD5_DETECTORS)
    assert (head.save_detected, head.time_gates) == (2**20, 50)
    own = defaults("head5", detectors='[{"x": 8, "y": 8, "radius": 1}]',
                   save_detected=16, time_gates=3)
    assert (own.detectors, own.save_detected, own.time_gates) == (
        '[{"x": 8, "y": 8, "radius": 1}]', 16, 3)
    for name in ("B1", "B2", "B2a", "skinvessel"):
        args = defaults(name)
        assert (args.detectors, args.save_detected, args.time_gates) == (
            None, 0, 1), name
    assert launch.bench_source("B1") is None


def test_cli_refuses_another_size():
    with pytest.raises(SystemExit):
        launch.main(["--bench", "head5", "--size", "30", "--device", "cpu"])
    with pytest.raises(ValueError, match="60"):
        launch.get_bench("head5", 30)
    assert launch.get_bench("head5", 60)[0].shape == (120, 120, 60)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    return torch.device("cuda")


@pytest.mark.cuda
def test_small_case_on_card_matches_reference_and_plain_path(
        cuda_device, bench_modules, monkeypatch):
    """On the card, through the graphed round loop: the kernel's run
    equals the frozen reference's and the plain path's
    (``PlainRegeneration`` on the card) bit for bit, records too."""
    _, step, transport = bench_modules
    vol = small_volume(cuda_device)
    cfg = small_config(16)
    args = (vol, cfg, 20_000, 4096, 2**31 + 3)

    def run():
        return S.simulate_fixed(*args, source=SMALL_SOURCE,
                                device=cuda_device,
                                detectors=SMALL_DETECTORS,
                                record_detected=1 << 16,
                                id_offset=2**32 - 9000)

    got = run()
    ref = reference_run(transport, step, vol, cfg, 2**31 + 3,
                        2**32 - 9000, 20_000)
    assert_bit_equal(got, ref)
    monkeypatch.setattr(S, "supports", lambda *a: False)
    want = run()
    for name, x, y in zip(got._fields, got, want):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name
        else:
            assert x == y, name
