"""The port's replay of detected photons (``repro_torch.replay``).

The port's own B2 forward run with Fresnel reflection (the set-up of the
reference's ``tests/test_replay.py::_b2_forward``: 20^3, 3000 photons,
512 lanes, K = 4, two detectors; here with 10 time gates over the same
5 ns) is replayed on the CPU.  The port computes every step with one
strict IEEE float32 code path, so the replay sees the forward
trajectories bit for bit:

* every record comes back at its detector and gate, exactly (the
  reference, whose forward and replay graphs XLA contracts differently,
  brings back 377 of 378 on this set-up);
* per-detector replayed exit weight equals the forward TPSF total
  within 1e-5 relative (float32 sums in another order);
* ``jacobian_medium_sums`` equals the forward ``det_ppath`` within 1e-5
  relative (measured: 2.7e-7);
* the Jacobian is int64 fixed point summed on the device (2**-36
  weight * mm units): the gate-resolved Jacobian's gate-sum equals the
  ungated one exactly in those units, two replays give the same bits,
  and a replay in launches of up to ``spec.MAX_STEPS`` segments gives
  the same bits of every output as one in rounds of K = 4, also where
  ``cfg.max_steps`` cuts the trajectories short.

Records of the JAX reference's B1 forward run replayed by the port land
at their detector on >= 99% of records (the two packages' float32
paths differ by XLA's FMA contraction; measured on seeds 5-7: all of
them, about 200 records each).  Without reflection both packages
replay every record of seed 5, at the same detector and gate; their
Jacobians agree cell by cell within 2e-4 of the largest cell and in
total within 1e-5 relative (measured on seeds 5-7: at most 3.7e-5 and
1.6e-7; a voxel's share of a path moves where FMA contraction moves a
crossing), and exit weights within 1e-5 relative (measured 1.1e-6).
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import detectors as JD  # noqa: E402
from repro.core import simulator as JS  # noqa: E402
from repro.core import volume as JV  # noqa: E402
from repro.replay import detected_records as jax_detected_records  # noqa: E402
from repro.replay import replay_jacobian as jax_replay_jacobian  # noqa: E402
from repro_torch.core import analysis as A  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402
from repro_torch import replay as R  # noqa: E402
from repro_torch.kernels.photon_step import spec  # noqa: E402
from repro_torch.kernels.photon_step.ref import photon_steps_ref  # noqa: E402
from repro_torch.replay import (ReplayResult, detected_records,  # noqa: E402
                                replay_jacobian)

SEED = 7
SRC = {"type": "pencil", "pos": (10.0, 10.0, 0.0)}
DETS = [(14.0, 10.0, 3.0), (6.0, 6.0, 2.0)]


@pytest.fixture(scope="module")
def b2_forward():
    vol = V.benchmark_b2((20, 20, 20))
    cfg = V.SimConfig(do_reflect=True, steps_per_round=4, n_time_gates=10)
    res = S.simulate(vol, cfg, 3000, 512, SEED, source=SRC, detectors=DETS,
                     record_detected=4096, device="cpu")
    return res, vol, cfg


@pytest.fixture(scope="module")
def b2_replay(b2_forward):
    res, vol, cfg = b2_forward
    return replay_jacobian(vol, cfg, detected_records(res), DETS, source=SRC,
                           seed=SEED, n_lanes=512, device="cpu")


def test_replay_brings_back_every_record_with_reflection(b2_forward,
                                                          b2_replay):
    res, _, _ = b2_forward
    rec = detected_records(res)
    assert rec.dtype == np.uint32 and rec.shape == (int(res.det_rec_n), 4)
    assert rec.shape[0] > 300 and int(res.det_rec_overflow) == 0
    rep = b2_replay
    assert isinstance(rep, ReplayResult) and rep.n_records == rec.shape[0]
    np.testing.assert_array_equal(rep.replayed_det, rep.det)
    np.testing.assert_array_equal(rep.det, rec[:, 2].astype(np.int32))
    np.testing.assert_array_equal(rep.gate, rec[:, 3].astype(np.int32))
    assert len(np.unique(rec[:, 3])) >= 2  # the gates are exercised
    per_det = np.zeros(len(DETS))
    np.add.at(per_det, rep.det, rep.w_exit.astype(np.float64))
    np.testing.assert_allclose(per_det, res.det_w.double().sum(dim=1).numpy(),
                               rtol=1e-5)


def test_jacobian_medium_sums_equal_det_ppath(b2_forward, b2_replay):
    res, vol, _ = b2_forward
    jac = b2_replay.jacobian
    assert jac.shape == (20, 20, 20, len(DETS)) and jac.dtype == np.float64
    assert jac.min() >= 0.0 and jac.sum() > 0.0
    med = A.jacobian_medium_sums(jac, vol)
    np.testing.assert_allclose(med, res.det_ppath.double().numpy(),
                               rtol=1e-5, atol=1e-9)
    # first order against the white-Monte-Carlo rescaling of det_w
    d_mua = 0.005 * 0.05
    w0 = res.det_w.double().sum(dim=1).numpy()
    new_mua = vol.media[:, 0].double().numpy().copy()
    new_mua[1] += d_mua
    np.testing.assert_allclose(-med[:, 1] * d_mua,
                               A.rescale_detected(res, vol, new_mua) - w0,
                               rtol=5e-2)


def test_gate_resolved_jacobian_partitions_the_ungated_one(b2_forward,
                                                           b2_replay):
    res, vol, cfg = b2_forward
    rec = detected_records(res)
    rg = replay_jacobian(vol, cfg, res, DETS, source=SRC, seed=SEED,
                         n_lanes=256, gate_resolved=True, device="cpu")
    assert rg.jacobian.shape == (20, 20, 20, len(DETS), 10)
    np.testing.assert_array_equal(rg.w_exit, b2_replay.w_exit)
    np.testing.assert_array_equal(rg.gate, rec[:, 3].astype(np.int32))
    # the same rounded deposits, in other cells: equal integer sums
    np.testing.assert_array_equal(_units(rg.jacobian).sum(axis=-1),
                                  _units(b2_replay.jacobian))
    per_gate = A.jacobian_medium_sums(rg.jacobian, vol, per_gate=True)
    assert per_gate.shape == (len(DETS), 10, vol.media.shape[0])
    np.testing.assert_allclose(per_gate.sum(axis=1),
                               res.det_ppath.double().numpy(), rtol=1e-5,
                               atol=1e-9)


def test_reference_records_replay_at_their_detector():
    shape = (16, 16, 16)
    src = {"type": "pencil", "pos": (8.0, 8.0, 0.0)}
    dets = [(11.0, 8.0, 3.0), (5.0, 5.0, 2.5)]
    jv = JV.benchmark_b1(shape)
    jcfg = JV.SimConfig(do_reflect=False, steps_per_round=2)
    ref = JS.simulate(jv, jcfg, 600, 128, 5, source=src,
                      detectors=JD.as_detectors(dets), record_detected=2048)
    jax.block_until_ready(ref)
    rec = jax_detected_records(ref)
    assert rec.dtype == np.uint32 and rec.shape[0] > 50
    tv = V.volume_from_arrays(np.asarray(jv.labels), np.asarray(jv.media))
    rep = replay_jacobian(tv, V.SimConfig(**dataclasses.asdict(jcfg)), rec,
                          dets, source=src, seed=5, n_lanes=128, device="cpu")
    assert (rep.replayed_det == rep.det).mean() >= 0.99
    assert (rep.gate == rec[:, 3].astype(np.int32)).mean() >= 0.99


def test_replay_input_validation(b2_forward):
    res, vol, cfg = b2_forward
    rec = detected_records(res)
    with pytest.raises(ValueError, match="detectors"):
        replay_jacobian(vol, cfg, rec, [], device="cpu")
    with pytest.raises(ValueError, match="refers to detector"):
        replay_jacobian(vol, cfg, rec, DETS[:1], device="cpu")
    bad = rec.copy()
    bad[0, 3] = 10
    with pytest.raises(ValueError, match="time gate"):
        replay_jacobian(vol, cfg, bad, DETS, gate_resolved=True,
                        device="cpu")
    with pytest.raises(ValueError, match="device or mesh"):
        replay_jacobian(vol, cfg, rec, DETS, device="cpu", mesh=["cpu"])
    with pytest.raises(ValueError, match="at least one device"):
        replay_jacobian(vol, cfg, rec, DETS, mesh=[])
    # a tracer gets one span a batch, tagged with the batch's records
    from repro_torch.telemetry import InMemorySink, Tracer
    tracer = Tracer(sinks=[InMemorySink()])
    part = rec[:100]
    traced = replay_jacobian(vol, cfg, part, DETS, device="cpu", n_lanes=64,
                             tracer=tracer)
    spans = [e for e in tracer.events if e.name == "replay_batch"]
    assert [e.args["records"] for e in spans] == [64, part.shape[0] - 64]
    assert [e.args["batch_start"] for e in spans] == [0, 64]
    assert traced.n_records == part.shape[0] and all(
        e.device == "cpu:0" and e.dur > 0 for e in spans)
    # no records: an empty, well-formed result
    empty = replay_jacobian(vol, cfg, rec[:0], DETS, device="cpu")
    assert empty.n_records == 0 and float(empty.jacobian.sum()) == 0.0
    # a forward result without records has none
    plain = S.simulate(vol, dataclasses.replace(cfg, n_time_gates=1), 50, 64,
                       SEED, source=SRC, device="cpu")
    assert detected_records(plain).shape == (0, 4)


def _units(jac):
    """A replay Jacobian in its int64 fixed-point units; raises unless
    every cell is a whole number of them."""
    units = jac * 2.0**spec.FIXED_SHIFT["jac"]
    assert np.array_equal(units, np.rint(units))
    return units.astype(np.int64)


def test_jacobian_is_fixed_point_and_bit_reproducible(b2_forward, b2_replay):
    res, vol, cfg = b2_forward
    again = replay_jacobian(vol, cfg, detected_records(res), DETS,
                            source=SRC, seed=SEED, n_lanes=512, device="cpu")
    assert _units(b2_replay.jacobian).sum() > 0
    for a, b in zip(b2_replay, again):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_steps", [None, 30])
def test_long_launches_match_rounds_of_k(b2_forward, b2_replay, max_steps,
                                         monkeypatch):
    """Launches of up to MAX_STEPS segments against rounds of K = 4, and
    launches of 7 (no multiple of K), set through the replay's builder;
    with max_steps = 30 the reference's loop stops at 32 segments, where
    every launch schedule stops too."""
    res, vol, cfg = b2_forward
    rec = detected_records(res)
    if max_steps is not None:
        cfg = dataclasses.replace(cfg, max_steps=max_steps)
    build = R._build_replay_fn
    runs = []
    for n in (None, cfg.steps_per_round, 7):
        monkeypatch.setattr(R, "_build_replay_fn", functools.partial(
            build, steps_per_launch=n))
        runs.append(replay_jacobian(vol, cfg, rec, DETS, source=SRC,
                                    seed=SEED, n_lanes=256,
                                    gate_resolved=True, device="cpu"))
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            np.testing.assert_array_equal(a, b)
    if max_steps is None:
        np.testing.assert_array_equal(runs[0].jacobian.sum(axis=-1),
                                      b2_replay.jacobian)
    else:
        # cut short: fewer records reach their detector
        assert (runs[0].replayed_det == runs[0].det).mean() < 1.0
    with pytest.raises(ValueError, match="steps_per_launch"):
        build(vol.shape, vol.unitinmm, cfg, 1, SRC, None, 1,
              steps_per_launch=spec.MAX_STEPS + 1)


def test_jacobian_out_of_range_raises(b2_forward):
    """A deposit of 2**44 units or more, or a sum past 2**63 - 1 units,
    raises in the plain version (the kernel flags it; the replay checks
    its total's sign)."""
    from repro_torch.kernels.photon_step import ops
    _, vol, cfg = b2_forward
    n = 64
    state = ops.fresh_state(vol, n, seed=3, source=SRC)
    args = (vol.labels.reshape(-1), vol.media, state, vol.shape, 1.0, cfg, 4)
    col = torch.zeros(n, dtype=torch.int32)
    ok = photon_steps_ref(*args, jac_w=torch.ones(n), jac_col=col,
                          jac_cols=2)
    assert ok[-1].dtype == torch.int64 and int(ok[-1].sum()) > 0
    with pytest.raises(OverflowError, match="2\\*\\*44"):
        photon_steps_ref(*args, jac_w=torch.full((n,), 1e6), jac_col=col,
                         jac_cols=2)
    grids = [torch.zeros_like(ok[1]), torch.zeros_like(ok[2]),
             torch.full_like(ok[-1], 2**63 - 1)]
    with pytest.raises(OverflowError, match="2\\*\\*63"):
        photon_steps_ref(*args, jac_w=torch.ones(n), jac_col=col,
                         jac_cols=2, totals=grids)


def test_jacobian_matches_the_reference_replay():
    """The JAX package's replay (jnp engine) and the port's, on the same
    records of the reference's B1 forward run without reflection."""
    shape = (16, 16, 16)
    src = {"type": "pencil", "pos": (8.0, 8.0, 0.0)}
    dets = [(11.0, 8.0, 3.0), (5.0, 5.0, 2.5)]
    jv = JV.benchmark_b1(shape)
    jcfg = JV.SimConfig(do_reflect=False, steps_per_round=2)
    ref = JS.simulate(jv, jcfg, 600, 128, 5, source=src,
                      detectors=JD.as_detectors(dets), record_detected=2048)
    jax.block_until_ready(ref)
    rec = jax_detected_records(ref)
    want = jax_replay_jacobian(jv, jcfg, rec, dets, source=src, seed=5,
                               n_lanes=128, engine="jnp")
    tv = V.volume_from_arrays(np.asarray(jv.labels), np.asarray(jv.media))
    got = replay_jacobian(tv, V.SimConfig(**dataclasses.asdict(jcfg)), rec,
                          dets, source=src, seed=5, n_lanes=128, device="cpu")
    assert rec.shape[0] > 150
    # both replay every record, at the same detector and gate
    np.testing.assert_array_equal(got.replayed_det, got.det)
    np.testing.assert_array_equal(np.asarray(want.replayed_det), got.det)
    np.testing.assert_array_equal(got.gate, np.asarray(want.gate))
    np.testing.assert_allclose(got.w_exit, np.asarray(want.w_exit),
                               rtol=1e-5)
    a, b = got.jacobian, np.asarray(want.jacobian, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 2e-4 * b.max()
    np.testing.assert_allclose(a.sum(axis=(0, 1, 2)), b.sum(axis=(0, 1, 2)),
                               rtol=1e-5)
