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
* the gate-resolved Jacobian's gate-sum equals the ungated one within
  1e-5 relative per cell (float32 atomics / index adds in another
  order).

Records of the JAX reference's B1 forward run replayed by the port land
at their detector on >= 99% of records (the two packages' float32
paths differ by XLA's FMA contraction; measured on seeds 5-7: all of
them, about 200 records each).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import detectors as JD  # noqa: E402
from repro.core import simulator as JS  # noqa: E402
from repro.core import volume as JV  # noqa: E402
from repro.replay import detected_records as jax_detected_records  # noqa: E402
from repro_torch.core import analysis as A  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402
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
    np.testing.assert_allclose(rg.jacobian.sum(axis=-1), b2_replay.jacobian,
                               rtol=1e-5, atol=1e-9)
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
    with pytest.raises(NotImplementedError):
        replay_jacobian(vol, cfg, rec, DETS, device="cpu", mesh=object())
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
