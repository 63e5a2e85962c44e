"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They skip on a machine without one.  On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed.  The kernel and its plain version run the
same IEEE float32 operations in the same order on the same device, so
the RNG words are bit-equal, lane states agree on >= 99.99% of lanes,
output totals agree to 1e-5 relative, and every fluence / exitance cell
and every lane's escaped / timed-out weight agrees to 4 sqrt(n) 2^-24
of its array's largest value, n the lane-segments that fed it.  The
fluence and exitance sums are float atomics in both, in an order that
changes from run to run: a cell of n deposits moves by about
sqrt(n) * 2^-24 of its value between two orders, while a deposit into a
wrong voxel, gate or bin moves cells by far more.

The optional output groups are held the same way: per-lane ``ppath``,
``cap_det``, ``cap_gate`` and the stats block bit-equal to the plain
version, TPSF, detector path sums and Jacobian cell by cell, and the
lane state and base outputs of the kernel bit-equal with any group on
or off.  Replay on the card brings back every record of a B2 forward
run with reflection at its detector and gate.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import analysis as A  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402
from repro_torch.detectors import as_detectors, det_geometry  # noqa: E402
from repro_torch.kernels.photon_step import ops  # noqa: E402
from repro_torch.kernels.photon_step import photon_step as kernel  # noqa: E402
from repro_torch.kernels.photon_step.ref import photon_steps_ref  # noqa: E402
from repro_torch.replay import detected_records, replay_jacobian  # noqa: E402

SHAPE = (24, 20, 16)
SRC = {"type": "pencil", "pos": [12.0, 10.0, 0.0]}


def assert_cells_close(a, b, n_segments):
    """Cell by cell, within 4 sqrt(n_segments) 2^-24 of ``b``'s largest
    value: four times the spread of a float32 sum of that many terms
    between two summation orders."""
    assert a.shape == b.shape
    tol = 4.0 * math.sqrt(n_segments) * 2.0**-24
    a, b = a.double(), b.double()
    assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("taylor", [False, True])
@pytest.mark.parametrize("bench", ["B1", "B2"])
def test_kernel_matches_plain_version(cuda_device, bench, taylor):
    vol = (V.benchmark_b2 if bench == "B2" else V.benchmark_b1)(
        SHAPE, cuda_device)
    cfg = dataclasses.replace(
        V.b2_config() if bench == "B2" else V.b1_config(), n_time_gates=4,
        tmax_ns=0.2, deposit_mode="taylor" if taylor else "exact")
    state = ops.fresh_state(vol, 4096, seed=3, source=SRC)
    args = (vol.labels.reshape(-1), vol.media, state, SHAPE, 1.0, cfg, 24)
    name = kernel.variant_name(0, cfg)
    before = kernel.photon_step_cuda.launches_by[name]
    got = kernel.photon_step_cuda(*args)
    torch.cuda.synchronize()
    assert kernel.photon_step_cuda.launches_by[name] == before + 1
    want = photon_steps_ref(*args)
    assert torch.equal(got[0].rng, want[0].rng)
    same = (got[0].alive == want[0].alive) & (
        got[0].ivox == want[0].ivox).all(dim=1)
    assert same.float().mean() >= 0.9999
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a.double().sum(), b.double().sum(),
                                   rtol=1e-5, atol=1e-6)
    # fluence (gate-major, ntg = 4) and exitance cell by cell
    for a, b in zip(got[1:3], want[1:3]):
        assert_cells_close(a, b, 4096 * 24)
    # escaped / timed-out weight lane by lane
    for a, b in zip(got[3:], want[3:]):
        assert_cells_close(a[same], b[same], 4096 * 24)


@pytest.mark.cuda
def test_general_step_matches_plain_version(cuda_device):
    vol = V.benchmark_b2(SHAPE, cuda_device)
    cfg = dataclasses.replace(V.b2_config(), specialize=False)
    state = ops.fresh_state(vol, 2048, seed=8, source=SRC)
    args = (vol.labels.reshape(-1), vol.media, state, SHAPE, 1.0, cfg, 16)
    got, want = kernel.photon_step_cuda(*args), photon_steps_ref(*args)
    assert torch.equal(got[0].rng, want[0].rng)
    assert (got[0].w == want[0].w).float().mean() >= 0.9999


@pytest.mark.cuda
def test_wrapper_checks_its_inputs(cuda_device):
    vol = V.benchmark_b1(SHAPE, cuda_device)
    state = ops.fresh_state(vol, 64, seed=1, source=SRC)
    labels = vol.labels.reshape(-1)
    bad = state._replace(w=state.w.double())
    with pytest.raises(TypeError):
        kernel.photon_step_cuda(labels, vol.media, bad, SHAPE, 1.0,
                                V.b1_config(), 2)
    with pytest.raises(ValueError):
        kernel.photon_step_cuda(labels[:-1], vol.media, state, SHAPE, 1.0,
                                V.b1_config(), 2)
    # zero lanes launch nothing and still return well-formed outputs
    empty = ops.fresh_state(vol, 0, seed=1, source=SRC)
    out = kernel.photon_step_cuda(labels, vol.media, empty, SHAPE, 1.0,
                                  V.b1_config(), 2)
    assert out[1].shape == (labels.numel(),) and float(out[1].sum()) == 0


@pytest.mark.cuda
def test_simulate_on_card_is_deterministic_and_conserves(cuda_device):
    vol = V.benchmark_b2((30, 30, 30))
    cfg = dataclasses.replace(V.b2_config(), steps_per_round=8)
    src = {"type": "pencil", "pos": [15.0, 15.0, 0.0]}
    a = S.simulate(vol, cfg, 50_000, 8192, 5, source=src)
    b = S.simulate(vol, cfg, 50_000, 8192, 5, source=src)
    assert a.energy.is_cuda
    assert int(a.n_launched) == 50_000 and float(a.launched_w) == 50_000
    assert a.steps == b.steps
    assert float(a.launched_w) == float(b.launched_w)
    bal = A.energy_balance(a)
    assert abs(bal["residue_frac"]) < 1e-5
    # fluence differs between runs only by the order of float atomics
    torch.testing.assert_close(a.energy.double().sum(),
                               b.energy.double().sum(), rtol=1e-5, atol=0)
    assert_cells_close(a.energy, b.energy, a.steps * 8192)
    assert_cells_close(a.exitance, b.exitance, a.steps * 8192)


DETS = [(12.0, 10.0, 3.0), (15.0, 10.0, 2.0), (9.0, 12.0, 2.0)]
DET, RECORD, JAC, STATS = (kernel.GROUP_BITS[g]
                           for g in ("n_det", "record", "jac_cols", "stats"))


def _group_kwargs(vol, n, groups, dev):
    gen = torch.Generator().manual_seed(11)
    kw = {}
    if groups & DET:
        kw.update(ppath=torch.zeros(n, vol.media.shape[0], device=dev),
                  det_geom=det_geometry(as_detectors(DETS), dev))
    if groups & RECORD:
        kw["record"] = True
    if groups & JAC:
        kw.update(jac_w=torch.rand(n, generator=gen).to(dev),
                  jac_col=torch.randint(0, 5, (n,), generator=gen,
                                        dtype=torch.int32).to(dev),
                  jac_cols=5)
    if groups & STATS:
        kw["stats"] = True
    return kw


@pytest.mark.cuda
@pytest.mark.parametrize("groups", kernel.VALID_GROUPS[1:])
def test_groups_match_plain_version_and_leave_state_alone(cuda_device,
                                                          groups):
    vol = V.benchmark_b2(SHAPE, cuda_device)
    cfg = dataclasses.replace(V.b2_config(), n_time_gates=4, tmax_ns=0.2)
    n = 4096
    state = ops.fresh_state(vol, n, seed=3, source=SRC)
    args = (vol.labels.reshape(-1), vol.media, state, SHAPE, 1.0, cfg, 24)
    kw = _group_kwargs(vol, n, groups, cuda_device)
    base = kernel.photon_step_cuda(*args)
    got = kernel.photon_step_cuda(*args, **kw)
    want = photon_steps_ref(*args, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(want) == 5 + sum(
        k for bit, k in ((DET, 3), (RECORD, 2), (JAC, 1), (STATS, 1))
        if groups & bit)
    for x, y in zip(got[0], base[0]):
        assert torch.equal(x, y)  # the groups leave the lane state alone
    assert torch.equal(got[3], base[3]) and torch.equal(got[4], base[4])
    assert torch.equal(got[0].rng, want[0].rng)
    cur = 5
    if groups & DET:
        assert torch.equal(got[cur], want[cur])  # ppath, lane by lane
        for a, b in zip(got[cur + 1:cur + 3], want[cur + 1:cur + 3]):
            assert_cells_close(a, b, n * 24)
        assert float(got[cur + 1].sum()) > 0
        cur += 3
    if groups & RECORD:
        assert torch.equal(got[cur], want[cur])
        assert torch.equal(got[cur + 1], want[cur + 1])
        cur += 2
    if groups & JAC:
        assert_cells_close(got[cur], want[cur], n * 24)
        cur += 1
    if groups & STATS:
        assert torch.equal(got[cur], want[cur])
    assert kernel.photon_step_cuda.launches_by[
        kernel.variant_name(groups, cfg)] >= 1


@pytest.mark.cuda
def test_jacobian_column_out_of_range_adds_nothing_and_raises(cuda_device):
    vol = V.benchmark_b2(SHAPE, cuda_device)
    cfg = dataclasses.replace(V.b2_config(), n_time_gates=4, tmax_ns=0.2)
    n = 4096
    state = ops.fresh_state(vol, n, seed=3, source=SRC)
    args = (vol.labels.reshape(-1), vol.media, state, SHAPE, 1.0, cfg, 24)
    kw = _group_kwargs(vol, n, JAC, cuda_device)
    kernel.check_errors(cuda_device)  # no flag left from earlier launches
    bad = kw["jac_col"].clone()
    bad[::7] = kw["jac_cols"]
    bad[3::7] = -1
    got = kernel.photon_step_cuda(*args, **dict(kw, jac_col=bad))
    with pytest.raises(ValueError, match="jac_col"):
        kernel.check_errors(cuda_device)
    kernel.check_errors(cuda_device)  # the check cleared the flag
    # the bad lanes add nothing: the plain version with their weight zeroed
    ok = (bad >= 0) & (bad < kw["jac_cols"])
    want = photon_steps_ref(*args, **dict(
        kw, jac_w=torch.where(ok, kw["jac_w"], 0.0), jac_col=bad.clamp(
            0, kw["jac_cols"] - 1)))
    assert_cells_close(got[-1], want[-1], n * 24)
    kernel.photon_step_cuda(*args, **kw)
    kernel.check_errors(cuda_device)  # columns in range raise nothing


@pytest.mark.cuda
def test_replay_on_card_brings_back_every_record(cuda_device):
    vol = V.benchmark_b2((30, 30, 30))
    cfg = dataclasses.replace(V.b2_config(), steps_per_round=8,
                              n_time_gates=10)
    src = {"type": "pencil", "pos": [15.0, 15.0, 0.0]}
    dets = [(20.0, 15.0, 2.0), (25.0, 15.0, 2.0)]
    res = S.simulate(vol, cfg, 200_000, 16384, 5, source=src,
                     detectors=dets, record_detected=65536)
    rec = detected_records(res)
    assert rec.shape[0] > 1000 and int(res.det_rec_overflow) == 0
    rep = replay_jacobian(vol, cfg, rec, dets, source=src, seed=5,
                          n_lanes=16384, gate_resolved=True)
    assert (rep.replayed_det == rep.det).all()
    assert (rep.gate == rec[:, 3].astype("int32")).all()
    med = A.jacobian_medium_sums(rep.jacobian, vol)
    want = res.det_ppath.double().cpu().numpy()
    assert abs(med - want).max() <= 1e-5 * abs(want).max()
