"""MCX's skin-vessel deployment on the port, against the frozen reference.

The port builds the volume from MCX's shape list (``core/shapes.py``,
``volume.benchmark_skinvessel``); the benchmark's reference builds its
labels apart (``perfbench/shapes.py``) from the configuration file.  The
two agree voxel for voxel at the published 200^3, with the same media
rows, voxel size, physics and source.  On a 24^3 grid of the same
structure (water over epidermis over dermis, a vessel along x, five
media rows, 5 um voxels, a disk beam, 50 ns) the port's int64 fixed-point
totals equal the frozen plain reference (``perfbench/reference``) bit for
bit, on the CPU here and on the card in the ``cuda``-marked test.  No
JAX is imported here.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import telemetry as T  # noqa: E402
from repro_torch.core import shapes as SH  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402
from repro_torch.launch import simulate as launch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = ROOT / "perfbench" / "configs" / "skinvessel.json"
SMALL_SHAPES = [{"Grid": {"Tag": 1, "Size": [24, 24, 24]}},
                {"ZLayers": [[1, 3, 1], [4, 5, 4], [6, 24, 3]]},
                {"Cylinder": {"Tag": 2, "C0": [0, 12.5, 12.5],
                              "C1": [24, 12.5, 12.5], "R": 3}}]
SMALL_SOURCE = {"type": "disk", "pos": [12.0, 12.0, 3.0],
                "dir": [0.0, 0.0, 1.0], "radius": 6.0}


@pytest.fixture
def bench_modules(monkeypatch):
    """``perfbench.shapes`` and the frozen reference's transport."""
    monkeypatch.syspath_prepend(str(ROOT))
    from perfbench import shapes
    from perfbench.reference import step, transport

    return shapes, step, transport


def small_volume(device="cpu"):
    return V.volume_from_shapes(SMALL_SHAPES, list(V.SKINVESSEL_MEDIA),
                                V.SKINVESSEL_UNITINMM, device)


def reference_run(transport, step, vol, cfg, source, seed, first, photons):
    phys = step.Physics(do_reflect=cfg.do_reflect, tmax_ns=cfg.tmax_ns,
                        w_threshold=cfg.w_threshold,
                        roulette_m=cfg.roulette_m,
                        n_time_gates=cfg.n_time_gates)
    return transport.forward(vol.labels.reshape(-1), vol.media, vol.shape,
                             vol.unitinmm, phys, source, seed, first,
                             photons)


def assert_bit_equal(fixed, ref):
    assert torch.equal(fixed.fluence.reshape(-1).cpu(), ref.fluence.cpu())
    assert torch.equal(fixed.exitance.reshape(-1).cpu(), ref.exitance.cpu())
    got = [int(fixed.escaped), int(fixed.timed_out), int(fixed.launched_w),
           int(fixed.n_launched)]
    assert got == [ref.escaped, ref.timed_out, ref.launched_w,
                   ref.n_launched]


def test_published_volume_equals_the_benchmarks_rasteriser(bench_modules):
    shapes = bench_modules[0]
    cfg = json.loads(CONFIG.read_text())
    labels, media, unit = shapes.build(cfg["volume"])
    vol = V.benchmark_skinvessel()
    assert vol.shape == (200, 200, 200) and vol.labels.dtype == torch.uint8
    np.testing.assert_array_equal(vol.labels.numpy(), labels)
    np.testing.assert_array_equal(vol.media.numpy(), media)
    assert vol.unitinmm == unit == 0.005
    counts = np.bincount(labels.reshape(-1), minlength=5)
    assert counts[0] == 0 and counts.sum() == 200**3
    sim = V.skinvessel_config()
    assert {k: getattr(sim, k) for k in cfg["physics"]} == cfg["physics"]
    assert V.SKINVESSEL_SOURCE == cfg["source"]
    assert launch.bench_source("skinvessel") == cfg["source"]


def test_voxels_follow_the_closed_form():
    """Blood where ``(j - 100)^2 + (k - 100)^2 <= 400``, else water for k
    0-19, epidermis 20-31, dermis 32-199."""
    labels = V.benchmark_skinvessel().labels.numpy()
    j, k = np.meshgrid(np.arange(200), np.arange(200), indexing="ij")
    want = np.where(k < 20, 1, np.where(k < 32, 4, 3))
    want = np.where((j - 100) ** 2 + (k - 100) ** 2 <= 400, 2, want)
    assert (labels == want[None]).all()


def test_oblique_cylinder_matches_a_voxel_loop():
    """The rasteriser against a loop over voxels of the same definition,
    on a cylinder whose axis and ends cut through the grid."""
    c0, c1, r = (1.0, 2.5, 0.5), (8.0, 6.0, 9.5), 2.2
    got = SH.cylinder(SH.grid((10, 9, 11), 1), c0, c1, r, 3)
    a = np.subtract(c1, c0)
    want = np.ones((10, 9, 11), np.uint8)
    for i, j, k in np.ndindex(*want.shape):
        v = np.array([i + 0.5, j + 0.5, k + 0.5]) - c0
        t = float(v @ a) / float(a @ a)
        if 0.0 <= t <= 1.0 and np.sum((v - t * a) ** 2) <= r * r:
            want[i, j, k] = 3
    assert 0 < int((want == 3).sum()) < want.size
    np.testing.assert_array_equal(got, want)


def test_shape_list_errors():
    with pytest.raises(ValueError, match="Grid"):
        SH.rasterize([{"ZLayers": [[1, 2, 1]]}])
    with pytest.raises(ValueError, match="unknown"):
        SH.rasterize([{"Grid": {"Tag": 1, "Size": [4, 4, 4]}},
                      {"Box": {"Tag": 2}}])
    with pytest.raises(ValueError, match="C0"):
        SH.rasterize([{"Grid": {"Tag": 1, "Size": [4, 4, 4]}},
                      {"Cylinder": {"Tag": 2, "C0": [1, 1, 1],
                                    "C1": [1, 1, 1], "R": 1}}])
    with pytest.raises(ValueError, match="medium"):
        V.volume_from_shapes(SMALL_SHAPES, list(V.SKINVESSEL_MEDIA[:3]))


@pytest.mark.parametrize("lanes,k,mode", [(256, 8, "dynamic"),
                                          (1000, 1, "static")])
def test_small_case_bit_equal_to_frozen_reference(bench_modules, lanes, k,
                                                  mode):
    _, step, transport = bench_modules
    vol = small_volume()
    cfg = dataclasses.replace(V.skinvessel_config(), steps_per_round=k)
    seed, first, photons = 2**31 + 17, 2**32 - 700, 1500
    fixed = S.simulate_fixed(vol, cfg, photons, lanes, seed,
                             source=SMALL_SOURCE, mode=mode, device="cpu",
                             id_offset=first)
    ref = reference_run(transport, step, vol, cfg, SMALL_SOURCE, seed,
                        first, photons)
    assert_bit_equal(fixed, ref)
    assert int(fixed.n_launched) == photons and ref.timed_out == 0
    # every medium takes deposits: the vessel, both layers, the water
    dep = fixed.fluence.reshape(24, 24, 24)
    for tag in (1, 2, 3, 4):
        assert int(dep[vol.labels == tag].sum()) > 0, tag


def test_cli_runs_skinvessel_with_its_span_and_counters(tmp_path, capsys):
    metrics = tmp_path / "m.jsonl"
    res = launch.main(["--bench", "skinvessel", "--photons", "300",
                       "--lanes", "128", "--steps-per-round", "8",
                       "--device", "cpu", "--metrics-out", str(metrics)])
    assert int(res.n_launched) == 300 and res.energy.shape == (200,) * 3
    out = capsys.readouterr().out
    assert "skinvessel: 300 photons" in out and "energy balance" in out
    rows = [json.loads(x) for x in metrics.read_text().splitlines()]
    spans = [r["name"] for r in rows if r["type"] == "span"]
    assert spans == ["volume.shapes", "simulate"]
    counters = {r["name"]: r["value"] for r in rows
                if r["type"] == "counter" and r["name"].startswith("volume.")}
    assert counters == {"volume.voxels": 200**3, "volume.media": 5,
                        "volume.grid_bytes": 8 * (200**3 + 200**2)}
    with pytest.raises(SystemExit):
        launch.main(["--bench", "skinvessel", "--size", "60",
                     "--device", "cpu"])
    with pytest.raises(ValueError, match="200"):
        launch.get_bench("skinvessel", 100)
    assert launch.get_bench("skinvessel", 200)[0].shape == (200,) * 3


def test_volume_span_joins_a_capture():
    """Under a ``torch.profiler`` capture the ``volume.shapes`` span is
    recorded in the capture's tracer as well as the CLI's."""
    events = T.capture_tracer().events
    events.clear()
    tracer = T.Tracer()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            launch.build_bench("B1", 8, torch.device("cpu"), 1, tracer)
        assert [e.name for e in events] == ["volume.shapes"]
        assert [e.name for e in tracer.events] == ["volume.shapes"]
        assert events[0].args == {"bench": "B1"}
    finally:
        events.clear()
    launch.build_bench("B1", 8, torch.device("cpu"), 1, None)
    assert events == []


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    return torch.device("cuda")


@pytest.mark.cuda
def test_small_case_on_card_matches_reference_and_plain_path(
        cuda_device, bench_modules, monkeypatch):
    """On the card: the kernel's run equals the frozen reference's and
    the plain path's (``PlainRegeneration`` on the card) bit for bit."""
    _, step, transport = bench_modules
    vol = small_volume(cuda_device)
    cfg = dataclasses.replace(V.skinvessel_config(), steps_per_round=16)
    args = (vol, cfg, 20_000, 4096, 2**31 + 3)

    def run():
        return S.simulate_fixed(*args, source=SMALL_SOURCE,
                                device=cuda_device, id_offset=2**32 - 9000)

    got = run()
    ref = reference_run(transport, step, vol, cfg, SMALL_SOURCE,
                        2**31 + 3, 2**32 - 9000, 20_000)
    assert_bit_equal(got, ref)
    monkeypatch.setattr(S, "supports", lambda *a: False)
    want = run()
    for name, x, y in zip(got._fields, got, want):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name
        else:
            assert x == y, name

