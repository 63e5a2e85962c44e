"""The port's detector, record and round-counter paths of the simulator
against ``repro.core.simulator`` (``detectors=``, ``record_detected=``,
``cfg.collect_stats``), and their own invariants.

Photon accounting is exact (``n_launched``, ``launched_w``, the stats'
``relaunched``).  Everything else sums over trajectories that are IEEE
float32 in the port and FMA-contracted in XLA's CPU code, and a
trajectory that diverges is an independent draw (see
test_torch_simulator.py).  Measured over seeds 1-4 on B1 and B2 at
these sizes (20^3, 2000 photons, 256 lanes, K = 4, 4 gates, two
detectors):

* per-detector detected weight: up to 1.16e-3 of the launched weight
  apart; held to ``DET_W_TOL`` = 3e-3 of it;
* per-detector path sums: up to 4.0e-3 of (launched weight x the
  detector's mean path) apart; held to ``DET_PPATH_TOL`` = 1e-2 of it;
* round counters: weights (deposited, escaped, timed out, detected) up
  to 1.3e-3 of the launched weight apart, held to 3e-3 like the run
  totals; live segments and regenerating rounds up to 1.7% apart, held
  to 5%; the number of rounds, set by the single longest photon, up to
  37% apart, held to 50%.

The port's own invariants are exact: recording and counting change no
physics output by one bit, and the counters reconcile with the result.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import detectors as JD  # noqa: E402
from repro.core import simulator as JS  # noqa: E402
from repro.core import volume as JV  # noqa: E402
from repro_torch.core import simulator as TS  # noqa: E402
from repro_torch.core import volume as TV  # noqa: E402

SHAPE = (20, 20, 20)
SRC = {"type": "pencil", "pos": [10.0, 10.0, 0.0]}
DETS = [{"x": 14.0, "y": 10.0, "radius": 3.0},
        {"x": 6.0, "y": 6.0, "radius": 2.0}]
DET_W_TOL = 3e-3
DET_PPATH_TOL = 1e-2
WEIGHT_TOL = 3e-3


def _bench(bench, shape=SHAPE, **cfg_kw):
    jv = JV.benchmark_b2(shape) if bench == "B2" else JV.benchmark_b1(shape)
    cfg = dataclasses.replace(
        JV.b2_config() if bench == "B2" else JV.b1_config(), **cfg_kw)
    tv = TV.volume_from_arrays(np.asarray(jv.labels), np.asarray(jv.media))
    return jv, tv, cfg, TV.SimConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("bench,seed", [("B1", 1), ("B2", 3)])
def test_detection_and_stats_match_reference(bench, seed):
    jv, tv, cfg, tcfg = _bench(bench, steps_per_round=4, n_time_gates=4,
                               collect_stats=True)
    ref = JS.simulate(jv, cfg, 2000, 256, seed, source=SRC,
                      detectors=JD.as_detectors(DETS), record_detected=4096)
    jax.block_until_ready(ref)
    got = TS.simulate(tv, tcfg, 2000, 256, seed, source=SRC, device="cpu",
                      detectors=DETS, record_detected=4096)
    assert int(got.n_launched) == int(ref.n_launched) == 2000
    assert float(got.launched_w) == float(ref.launched_w)
    L = float(ref.launched_w)
    assert got.det_w.shape == (2, 4)
    assert got.det_ppath.shape == (2, tv.media.shape[0])
    jw = np.asarray(ref.det_w, np.float64).sum(axis=1)
    tw = got.det_w.double().sum(dim=1).numpy()
    assert (jw > 10).all()
    assert np.abs(tw - jw).max() <= DET_W_TOL * L, (tw, jw)
    jp = np.asarray(ref.det_ppath, np.float64)
    tp = got.det_ppath.double().numpy()
    mean_path = jp.sum(axis=1) / jw
    assert (np.abs(tp - jp).sum(axis=1) <= DET_PPATH_TOL * L * mean_path).all()
    # record counts agree within 5% (measured: within 3 of ~250)
    assert abs(int(got.det_rec_n) - int(ref.det_rec_n)) <= 0.05 * int(
        ref.det_rec_n)
    # round counters
    js, ts = ref.stats, got.stats
    assert int(ts.relaunched) == int(js.relaunched) == 2000
    for f in ("deposited_w", "escaped_w", "timed_out_w", "detected_w"):
        assert abs(float(getattr(ts, f)) - float(getattr(js, f))) <= \
            WEIGHT_TOL * L, f
    for f in ("live_segments", "regen_rounds"):
        assert abs(float(getattr(ts, f)) - float(getattr(js, f))) <= \
            0.05 * float(getattr(js, f)), f
    assert 0.5 < float(ts.rounds) / float(js.rounds) < 1.5


def test_recording_and_stats_leave_physics_bit_equal():
    _, tv, _, tcfg = _bench("B2", (16, 16, 16), steps_per_round=4,
                            n_time_gates=3)
    src = {"type": "pencil", "pos": [8.0, 8.0, 0.0]}
    dets = [{"x": 11.0, "y": 8.0, "radius": 2.5},
            {"x": 8.0, "y": 8.0, "radius": 1.0}]

    def run(detectors=None, record=0, stats=False):
        cfg = dataclasses.replace(tcfg, collect_stats=stats)
        return TS.simulate(tv, cfg, 800, 128, 7, source=src, device="cpu",
                           detectors=detectors, record_detected=record)

    plain = run()
    det = run(dets)
    rec = run(dets, 4096)
    full = run(dets, 4096, True)
    for r in (det, rec, full):
        for name in ("energy", "exitance", "escaped_w", "timed_out_w",
                     "launched_w", "n_launched"):
            assert torch.equal(getattr(r, name), getattr(plain, name)), name
        assert r.steps == plain.steps
    for r in (rec, full):
        assert torch.equal(r.det_w, det.det_w)
        assert torch.equal(r.det_ppath, det.det_ppath)
    assert torch.equal(full.det_rec, rec.det_rec)
    assert plain.det_w.shape == (0, 3) and plain.stats is None
    # the records: unique photon ids, valid detectors and gates
    n = int(rec.det_rec_n)
    rows = rec.det_rec[:n].numpy()
    assert n > 20 and int(rec.det_rec_overflow) == 0
    assert rec.det_rec.shape == (4096, 4) and rec.det_rec.dtype == torch.int64
    ids = rows[:, 0] + (rows[:, 1] << 32)
    assert len(np.unique(ids)) == n and (ids < 800).all()
    assert set(rows[:, 2]) <= {0, 1}
    assert ((0 <= rows[:, 3]) & (rows[:, 3] < 3)).all()
    # every captured packet is a record: record counts per detector
    # follow the TPSF's nonzero weight
    assert (np.bincount(rows[:, 2], minlength=2) > 0).tolist() == (
        det.det_w.sum(dim=1) > 0).tolist()
    # the counters reconcile with the result
    s = full.stats
    assert int(s.relaunched) == int(full.n_launched) == 800
    assert s.escaped_w == np.float32(full.escaped_w.item())
    assert s.timed_out_w == np.float32(full.timed_out_w.item())
    assert int(s.rounds) == full.steps // 4
    assert float(s.lane_segments) == full.steps * 128
    assert 0 < s.lane_occupancy() <= 1
    np.testing.assert_allclose(float(s.deposited_w),
                               float(full.energy.double().sum()), rtol=1e-5)
    np.testing.assert_allclose(float(s.detected_w),
                               float(full.det_w.double().sum()), rtol=1e-5)
    assert 0 < int(s.regen_rounds) <= int(s.rounds)


def test_record_overflow_keeps_the_first_records():
    _, tv, _, tcfg = _bench("B1", (16, 16, 16), steps_per_round=2)
    src = {"type": "pencil", "pos": [8.0, 8.0, 0.0]}
    dets = [{"x": 8.0, "y": 8.0, "radius": 4.0}]

    def run(cap):
        return TS.simulate(tv, tcfg, 600, 64, 3, source=src, device="cpu",
                           detectors=dets, record_detected=cap)

    full, small = run(2048), run(25)
    n_full = int(full.det_rec_n)
    assert n_full > 40 and int(full.det_rec_overflow) == 0
    assert int(small.det_rec_n) == 25
    assert int(small.det_rec_overflow) == n_full - 25
    assert torch.equal(small.det_rec, full.det_rec[:25])
    assert torch.equal(small.det_w, full.det_w)


def test_gate_sum_equals_the_cw_run():
    # 5 gates over 0.3 ns spread the captures over several gates
    _, tv, _, tcfg = _bench("B2", (16, 16, 16), steps_per_round=4,
                            tmax_ns=0.3)
    src = {"type": "pencil", "pos": [8.0, 8.0, 0.0]}
    dets = [{"x": 11.0, "y": 8.0, "radius": 2.5}]

    def run(ntg):
        cfg = dataclasses.replace(tcfg, n_time_gates=ntg)
        return TS.simulate(tv, cfg, 600, 128, 5, source=src, device="cpu",
                           detectors=dets, record_detected=1024)

    cw, gated = run(1), run(5)
    assert gated.det_w.shape == (1, 5) and gated.energy.shape[-1] == 5
    np.testing.assert_allclose(gated.det_w.double().sum(dim=1).numpy(),
                               cw.det_w.double().sum(dim=1).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(gated.energy.double().sum(dim=-1).numpy(),
                               cw.energy.double().numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gated.det_ppath.numpy(), cw.det_ppath.numpy(),
                               rtol=1e-5)
    # the same captures, now with their gates
    n = int(cw.det_rec_n)
    assert n > 0 and int(gated.det_rec_n) == n
    assert torch.equal(gated.det_rec[:n, :3], cw.det_rec[:n, :3])
    assert int(gated.det_rec[:n, 3].max()) > 0 == int(cw.det_rec[:n, 3].max())


def test_detection_input_validation():
    tv = TV.benchmark_b1((8, 8, 8))
    cfg = TV.b1_config()
    with pytest.raises(ValueError, match="requires detectors"):
        TS.simulate(tv, cfg, 10, 16, device="cpu", record_detected=8)
    with pytest.raises(ValueError, match=">= 0"):
        TS.simulate(tv, cfg, 10, 16, device="cpu",
                    detectors=[(4.0, 4.0, 1.0)], record_detected=-1)
    with pytest.raises(ValueError, match="outside the z=0 face"):
        TS.make_simulator(tv, cfg, 16, device="cpu",
                          detectors=[(40.0, 4.0, 1.0)])


def test_detector_analysis_matches_reference():
    from repro.core import analysis as JA
    from repro_torch.core import analysis as TA

    rng = np.random.default_rng(4)
    det_w = rng.uniform(0, 5, (3, 6)).astype(np.float32)
    det_w[2] = 0.0  # a detector that caught nothing
    det_ppath = rng.uniform(0, 50, (3, 3)).astype(np.float32)
    common = dict(energy=np.zeros((4, 4, 4), np.float32),
                  exitance=np.zeros((4, 4), np.float32),
                  escaped_w=np.float32(0), n_launched=np.int32(900),
                  launched_w=np.float32(900.0), steps=8)
    jres = JS.SimResult(**common, det_w=det_w, det_ppath=det_ppath)
    tres = TS.SimResult(**common, det_w=torch.tensor(det_w),
                        det_ppath=torch.tensor(det_ppath))
    jcfg = JV.SimConfig(n_time_gates=6, tmax_ns=3.0)
    tcfg = TV.SimConfig(n_time_gates=6, tmax_ns=3.0)
    for a, b in zip(TA.tpsf(tres, tcfg), JA.tpsf(jres, jcfg)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        TA.tpsf(tres, TV.SimConfig(n_time_gates=2))
    np.testing.assert_array_equal(TA.detector_mean_ppath(tres),
                                  JA.detector_mean_ppath(jres))
    jv, tv, _, _ = _bench("B2", (12, 12, 12))
    new_mua = np.asarray(jv.media)[:, 0] * 1.1
    np.testing.assert_array_equal(TA.rescale_detected(tres, tv, new_mua),
                                  JA.rescale_detected(jres, jv, new_mua))
    jac = rng.uniform(0, 1, (12, 12, 12, 3, 6))
    for per_gate in (False, True):
        np.testing.assert_array_equal(
            TA.jacobian_medium_sums(jac, tv, per_gate=per_gate),
            JA.jacobian_medium_sums(jac, jv, per_gate=per_gate))
    np.testing.assert_array_equal(TA.jacobian_medium_sums(jac[..., 0], tv),
                                  JA.jacobian_medium_sums(jac[..., 0], jv))
    with pytest.raises(ValueError):
        TA.jacobian_medium_sums(jac[..., 0], tv, per_gate=True)
