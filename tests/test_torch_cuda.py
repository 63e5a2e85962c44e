"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They skip on a machine without one.  On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed.  The kernel and its plain version run the
same IEEE float32 operations in the same order on the same device, so
the RNG words are bit-equal, lane states agree on >= 99.99% of lanes,
output totals agree to 1e-5 relative, and every lane's escaped /
timed-out weight agrees to 4 sqrt(n) 2^-24 of its array's largest
value, n the lane-segments that fed it.  Fluence, exitance, TPSF,
detector path sums and the replay Jacobian are int64 fixed point in
both, each deposit rounded the same way, so they are bit-equal to the
plain version and from run to run.

The redesigned launch is held on the cases that exercise it: every lane
dead at launch (each draws its 5 uniforms a segment and nothing else
changes), a ragged lane count with half-dead warps, every lane in one
voxel with one direction (the most deposits into one cell), and a
media table of six rows, whose per-medium paths the lanes carry.
There the lane state is bit-equal to the plain version on every lane.

The optional output groups are held the same way: per-lane ``ppath``,
``cap_det``, ``cap_gate`` and the stats block bit-equal to the plain
version, the Jacobian cell by cell, and the lane state and base
outputs of the kernel bit-equal with any group on or off.  Replay on
the card brings back every record of a B2 forward run with reflection
at its detector and gate; in launches of up to 4095 segments it gives
the bits of every output of a replay in rounds, of a second replay and
of the plain version's replay on the card, and a Jacobian launch adds
into the caller's totals and zeroes nothing.

A launch of several scenarios (a ``(S, n_media, 4)`` media table) is
bit-equal to the plain version and to each scenario launched alone,
also at a lane count that is no multiple of the block size; a deposit
beyond the fixed-point range adds nothing and raises through
``check_errors``; ``simulate_many`` gives each scenario the bits of
its own ``simulate_one``.

Above one device: two shards of one card (each in a process of its
own) give one run's int64 totals bit for bit; a CPU shard beside a card
shard is held to the same photons run on the card within the tolerance
between the two arithmetics (CPU and CUDA float32 functions differ in
the last bit, so a photon may take another path on each); a pool that
loses its CPU worker moves that worker's chunks to the card; a pool
whose card worker cannot build its kernel (in that worker's process)
fails instead of moving the work to the CPU; and two threads launching on one card at once each see
only their own error flags.

The round's tail in the step kernel's epilogue (``RoundTail``): launch
after launch it leaves the totals, round counts and work flags of the
plain version's tail, over one and eight scenarios and many blocks; a
run whose rounds are graphed with it gives the bits of the plain path
(``PlainRegeneration``, eager rounds, the tail in PyTorch operations,
the records appended by ``simulator._append_records``) for b1-,
b2.sweep-, skinvessel- and head5-shaped runs, the last with records, in
a buffer with room for all and in one that fills; and its range check
on the totals fires on a planted weight.

The records' append in the same epilogue (``RoundRecords``): a launch
given the record buffers leaves the rows, kept counts and overflow that
``simulator._append_records`` leaves from the same launch's per-lane
captures, bit for bit, at head5.td's mid-run shape, part-way past the
capacity, over two scenarios and in a round with no capture; a graphed
run with records appends in every step and gives the same bits twice.
"""

import collections
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import analysis as A  # noqa: E402
from repro_torch.core import photon as ph  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402
from repro_torch.detectors import as_detectors, det_geometry  # noqa: E402
from repro_torch.kernels.photon_step import ops  # noqa: E402
from repro_torch.kernels.photon_step import photon_step as kernel  # noqa: E402
from repro_torch.kernels.photon_step import ref as R  # noqa: E402
from repro_torch.kernels.photon_step.ref import photon_steps_ref  # noqa: E402
from repro_torch.launch.kernel_timing import kept_launch  # noqa: E402
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
    for a, b in zip(got[3:], want[3:]):
        torch.testing.assert_close(a.double().sum(), b.double().sum(),
                                   rtol=1e-5, atol=1e-6)
    # fluence (gate-major, ntg = 4) and exitance: fixed point, bit-equal
    for a, b in zip(got[1:3], want[1:3]):
        assert a.dtype == torch.int64 and torch.equal(a, b)
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
    # fixed-point sums: two runs give the same bits
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)


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
            assert torch.equal(a, b)  # TPSF and path sums, fixed point
        assert float(got[cur + 1].sum()) > 0
        cur += 3
    if groups & RECORD:
        assert torch.equal(got[cur], want[cur])
        assert torch.equal(got[cur + 1], want[cur + 1])
        cur += 2
    if groups & JAC:
        assert got[cur].dtype == torch.int64
        assert torch.equal(got[cur], want[cur])
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
    assert torch.equal(got[-1], want[-1])
    kernel.photon_step_cuda(*args, **kw)
    kernel.check_errors(cuda_device)  # columns in range raise nothing


@pytest.mark.cuda
def test_replay_on_card_brings_back_every_record(cuda_device, monkeypatch):
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
    # launches of up to 4095 segments: the bits of a replay in rounds
    # of K (set through the replay's builder) and of a second replay
    from repro_torch import replay as R
    build = R._build_replay_fn
    for n in (cfg.steps_per_round, None):
        monkeypatch.setattr(R, "_build_replay_fn", functools.partial(
            build, steps_per_launch=n))
        other = replay_jacobian(vol, cfg, rec, dets, source=src, seed=5,
                                n_lanes=16384, gate_resolved=True)
        for a, b in zip(rep, other):
            assert np.array_equal(a, b)


@pytest.mark.cuda
def test_replay_kernel_matches_plain_replay(cuda_device):
    """The replay's two passes through the kernel and through the plain
    version on the card, in launches of 4095 segments and of 100 (the
    lanes cross a launch boundary): the same bits of every output."""
    from repro_torch import replay as R
    vol = V.benchmark_b2((30, 30, 30), cuda_device)
    cfg = dataclasses.replace(V.b2_config(), steps_per_round=8,
                              n_time_gates=10)
    src = {"type": "pencil", "pos": [15.0, 15.0, 0.0]}
    dets = [(20.0, 15.0, 2.0), (25.0, 15.0, 2.0)]
    res = S.simulate(vol, cfg, 20_000, 4096, 5, source=src,
                     detectors=dets, record_detected=8192,
                     device=cuda_device)
    rec = detected_records(res)[:512]
    nb, id_lo, id_hi, col, active = R._batch_arrays(rec, 0, 512, True, 10)
    ins = [torch.tensor(x, device=cuda_device) for x in (
        id_lo.astype("int64"), id_hi.astype("int64"), col, active)]
    geom = det_geometry(as_detectors(dets), cuda_device)
    for steps in (None, 100):
        outs = []
        for step in (ops.photon_steps, photon_steps_ref):
            jac = torch.zeros(vol.labels.numel() * 20, dtype=torch.int64,
                              device=cuda_device)
            scratch = [torch.zeros(n, dtype=torch.int64, device=cuda_device)
                       for n in (vol.labels.numel() * 10, 30 * 30, 20)] + [
                torch.zeros((2, vol.media.shape[0]), dtype=torch.int64,
                            device=cuda_device)]
            fn = R._build_replay_fn(vol.shape, 1.0, cfg, 512, src, geom, 20,
                                    step=step, steps_per_launch=steps)
            outs.append(fn(vol.labels.reshape(-1), vol.media, *ins, 5, jac,
                           scratch) + (jac, *scratch))
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        assert int(outs[0][3].sum()) > 0
        assert (outs[0][2][:nb].cpu().numpy() == rec[:, 2]).all()


@pytest.mark.cuda
def test_jacobian_launch_adds_into_totals(cuda_device):
    vol = V.benchmark_b2(SHAPE, cuda_device)
    cfg = dataclasses.replace(V.b2_config(), n_time_gates=4, tmax_ns=0.2)
    n = 4096
    state = ops.fresh_state(vol, n, seed=3, source=SRC)
    args = (vol.labels.reshape(-1), vol.media, state, SHAPE, 1.0, cfg, 24)
    kw = _group_kwargs(vol, n, JAC, cuda_device)
    own = kernel.photon_step_cuda(*args, **kw)
    totals = [torch.full_like(own[i], 7) for i in (1, 2, 5)]
    got = kernel.photon_step_cuda(*args, **kw, totals=totals)
    torch.cuda.synchronize()
    for t, i in zip(totals, (1, 2, 5)):
        assert got[i] is t and torch.equal(t, own[i] + 7)
    kernel.check_errors(cuda_device)


def _assert_matches_plain(args, kw):
    """Lane state, per-lane weights, per-lane group outputs and the
    fixed-point grids bit-equal to the plain version."""
    got = kernel.photon_step_cuda(*args, **kw)
    want = photon_steps_ref(*args, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for name, x, y in zip(got[0]._fields, got[0], want[0]):
        assert torch.equal(x, y), name
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    for a, b in zip(got[1:3], want[1:3]):
        assert torch.equal(a, b)
    # ppath, det_w, det_ppath, cap_det, cap_gate, stats
    for a, b in zip(got[5:], want[5:]):
        assert torch.equal(a, b)
    return got


def _forward_kwargs(vol, n, dev):
    return dict(ppath=torch.zeros(n, vol.media.shape[0], device=dev),
                det_geom=det_geometry(as_detectors(DETS), dev), record=True,
                stats=True)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [0, DET | RECORD | STATS])
def test_lanes_dead_at_launch_only_draw(cuda_device, groups):
    vol = V.benchmark_b2(SHAPE, cuda_device)
    cfg = dataclasses.replace(V.b2_config(), n_time_gates=4, tmax_ns=0.2)
    n = 4096 + 77
    state = ops.fresh_state(vol, n, seed=4, source=SRC)
    state = state._replace(alive=torch.zeros_like(state.alive))
    kw = _forward_kwargs(vol, n, cuda_device) if groups else {}
    if kw:
        kw["ppath"] = torch.rand(n, vol.media.shape[0], device=cuda_device)
    args = (vol.labels.reshape(-1), vol.media, state, SHAPE, 1.0, cfg, 24)
    got = _assert_matches_plain(args, kw)
    for name, x, y in zip(got[0]._fields, got[0], state):
        if name != "rng":
            assert torch.equal(x, y), name
    assert not torch.equal(got[0].rng, state.rng)  # 5 x 24 draws a lane
    for x in got[1:5]:
        assert float(x.abs().sum()) == 0
    if kw:
        assert torch.equal(got[5], kw["ppath"])
        assert bool((got[8] == -1).all()) and float(got[10].sum()) == 0


@pytest.mark.cuda
def test_ragged_lanes_with_half_dead_warps_match_plain(cuda_device):
    vol = V.benchmark_b2(SHAPE, cuda_device)
    cfg = dataclasses.replace(V.b2_config(), n_time_gates=4, tmax_ns=0.2)
    n = 8192 + 77
    state = ops.fresh_state(vol, n, seed=6, source=SRC)
    lane = torch.arange(n, device=cuda_device)
    state = state._replace(alive=state.alive & (lane % 32 < 16))
    args = (vol.labels.reshape(-1), vol.media, state, SHAPE, 1.0, cfg, 24)
    _assert_matches_plain(args, {})
    _assert_matches_plain(args, _forward_kwargs(vol, n, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("bench", ["B1", "B2"])
def test_every_lane_in_one_voxel_matches_plain(cuda_device, bench):
    # a pencil launches every lane at one point with one direction: the
    # first segments of all of them deposit into one cell
    vol = (V.benchmark_b2 if bench == "B2" else V.benchmark_b1)(
        SHAPE, cuda_device)
    cfg = V.b2_config() if bench == "B2" else V.b1_config()
    n = 65536
    state = ops.fresh_state(vol, n, seed=9, source=SRC)
    assert bool((state.ivox == state.ivox[:1]).all())
    args = (vol.labels.reshape(-1), vol.media, state, SHAPE, 1.0, cfg, 16)
    got = _assert_matches_plain(args, {})
    assert float(got[1].max()) > 0.01 * float(got[1].sum())


@pytest.mark.cuda
def test_ppath_over_six_media_matches_plain(cuda_device):
    vol = V.benchmark_b2(SHAPE, cuda_device)
    media = torch.cat([vol.media] + [vol.media[1:2]] * 3)
    n = 4096
    state = ops.fresh_state(vol, n, seed=3, source=SRC)
    cfg = dataclasses.replace(V.b2_config(), n_time_gates=4, tmax_ns=0.2)
    kw = dict(_forward_kwargs(vol, n, cuda_device),
              ppath=torch.zeros(n, media.shape[0], device=cuda_device))
    args = (vol.labels.reshape(-1), media, state, SHAPE, 1.0, cfg, 24)
    got = _assert_matches_plain(args, kw)
    assert float(got[6].sum()) > 0


def _stacked(vol, S, dev):
    """S scenarios of one volume: media tables scaled apart, so that a
    lane reading another scenario's row would show."""
    media = vol.media.to(dev)[None].repeat(S, 1, 1)
    for i in range(S):
        media[i, 1:, 0] *= 1.0 + 0.25 * i  # absorption differs
    return media


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 300])
def test_batched_launch_matches_plain_and_each_scenario_alone(cuda_device,
                                                              n):
    # 300 lanes a scenario is no multiple of the 256-thread block: a
    # block never spans two scenarios, so each keeps its own cache
    vol = V.benchmark_b2(SHAPE, cuda_device)
    cfg = dataclasses.replace(V.b2_config(), n_time_gates=4, tmax_ns=0.2)
    S = 3
    media = _stacked(vol, S, cuda_device)
    states = [ops.fresh_state(vol, n, seed=10 + i, source=SRC)
              for i in range(S)]
    state = type(states[0])(*(torch.cat(xs) for xs in zip(*states)))
    geom = det_geometry(as_detectors(DETS), cuda_device)[None].repeat(S, 1, 1)
    geom[1, :, 0] += 1.0  # the second scenario's disks moved
    labels = vol.labels.reshape(-1)
    kw = dict(ppath=torch.zeros(S * n, media.shape[1], device=cuda_device),
              det_geom=geom, record=True, stats=True)
    args = (labels, media, state, SHAPE, 1.0, cfg, 24)
    got = _assert_matches_plain(args, kw)
    assert got[1].shape == (S, labels.numel() * 4)
    for i in range(S):
        one = kernel.photon_step_cuda(
            labels, media[i], states[i], SHAPE, 1.0, cfg, 24,
            ppath=torch.zeros(n, media.shape[1], device=cuda_device),
            det_geom=geom[i], record=True, stats=True)
        rows = slice(i * n, (i + 1) * n)
        for x, y in zip(got[0], one[0]):
            assert torch.equal(x[rows], y)
        for k in (1, 2, 6, 7):  # the scenario's grids
            assert torch.equal(got[k][i], one[k])
        for k in (3, 4, 5, 8, 9, 10):  # per-lane outputs
            assert torch.equal(got[k][rows], one[k])


@pytest.mark.cuda
def test_grids_bit_equal_run_to_run(cuda_device):
    vol = V.benchmark_b1(SHAPE, cuda_device)
    cfg = dataclasses.replace(V.b1_config(), n_time_gates=4, tmax_ns=0.2)
    n = 65536
    state = ops.fresh_state(vol, n, seed=9, source=SRC)
    args = (vol.labels.reshape(-1), vol.media, state, SHAPE, 1.0, cfg, 16)
    kw = _forward_kwargs(vol, n, cuda_device)
    runs = [kernel.photon_step_cuda(*args, **kw) for _ in range(3)]
    for other in runs[1:]:
        for k in (1, 2, 6, 7):
            assert torch.equal(runs[0][k], other[k])


@pytest.mark.cuda
def test_fixed_point_overflow_adds_nothing_and_raises(cuda_device):
    vol = V.benchmark_b1(SHAPE, cuda_device)
    cfg = V.b1_config()
    n = 4096
    state = ops.fresh_state(vol, n, seed=3, source=SRC)
    args = (vol.labels.reshape(-1), vol.media)
    kernel.check_errors(cuda_device)  # no flag left from earlier launches
    # a weight of 1e12 deposits far more than the 2**27 a cell can hold
    heavy = state._replace(w=torch.where(
        torch.arange(n, device=cuda_device) == 5,
        torch.full_like(state.w, 1e12), state.w))
    got = kernel.photon_step_cuda(*args, heavy, SHAPE, 1.0, cfg, 4)
    with pytest.raises(OverflowError):
        kernel.check_errors(cuda_device)
    kernel.check_errors(cuda_device)  # the check cleared the flag
    with pytest.raises(OverflowError):
        photon_steps_ref(*args, heavy, SHAPE, 1.0, cfg, 4)
    assert int(got[1].min()) >= 0  # nothing wrapped
    # an in-range launch raises nothing
    kernel.photon_step_cuda(*args, state, SHAPE, 1.0, cfg, 4)
    kernel.check_errors(cuda_device)
    # run totals one unit short of 2**63: the blocks' cached sums take
    # them past it, which the flush sees; the plain version raises too
    full = [torch.full((labels_n,), 2**63 - 1, dtype=torch.int64,
                       device=cuda_device) for labels_n in (
                           vol.labels.numel(), SHAPE[0] * SHAPE[1])]
    kernel.photon_step_cuda(*args, state, SHAPE, 1.0, cfg, 4, totals=full)
    with pytest.raises(OverflowError):
        kernel.check_errors(cuda_device)
    with pytest.raises(OverflowError):
        photon_steps_ref(*args, state, SHAPE, 1.0, cfg, 4, totals=[
            torch.full_like(t, 2**63 - 1) for t in full])


@pytest.mark.cuda
def test_simulate_many_on_card_is_bit_identical_to_simulate_one(cuda_device):
    from repro_torch import scenarios as SC
    cfg = dataclasses.replace(V.b2_config(), steps_per_round=8,
                              n_time_gates=4, tmax_ns=0.5)
    vol = V.benchmark_b2((30, 30, 30))
    dets = [(20.0, 15.0, 2.0), (25.0, 15.0, 2.0)]
    fleet = [SC.Scenario(vol, cfg, 20_000 + 5_000 * i, seed=3 + i,
                         source={"type": "disk", "pos": [10.0 + 3 * i, 15.0,
                                                         0.0], "radius": 3},
                         detectors=dets, id_offset=(i << 33))
             for i in range(4)]
    many = SC.simulate_many(fleet, n_lanes=4096)
    for sc, got in zip(fleet, many):
        want = SC.simulate_one(sc, n_lanes=4096)
        for name, x, y in zip(got._fields, got, want):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), name
            else:
                assert x == y, name


def _int64_totals(fixed):
    return {f: getattr(fixed, f).cpu() for f in (
        "fluence", "exitance", "det_w", "det_ppath", "escaped", "timed_out",
        "launched_w", "n_launched")}


@pytest.mark.cuda
def test_two_shards_of_one_card_are_bit_identical_to_one_run(cuda_device):
    from repro_torch.core import multidevice as M
    vol = V.benchmark_b2((30, 30, 30))
    cfg = dataclasses.replace(V.b2_config(), steps_per_round=8,
                              n_time_gates=4, tmax_ns=0.5)
    dets = [(20.0, 15.0, 2.0), (25.0, 15.0, 2.0)]
    src = {"type": "pencil", "pos": [15.0, 15.0, 0.0]}
    kw = dict(source=src, detectors=dets, record_detected=8192)
    one = S.simulate_fixed(vol, cfg, 60_000, 8192, 5, device=cuda_device,
                           **kw)
    counts = [42_000, 18_000]
    parts = M.sharded_sim_fn(vol, cfg, [8192, 2048], [cuda_device] * 2,
                             **kw)(counts, M.shard_offsets(counts), 5)
    merged = S.merge_fixed(parts)
    want, got = _int64_totals(one), _int64_totals(merged)
    for f in want:
        assert torch.equal(got[f], want[f]), f
    res = S.to_sim_result(merged)
    assert sorted(map(tuple, detected_records(res))) == sorted(
        map(tuple, detected_records(S.to_sim_result(one))))


@pytest.mark.cuda
def test_concurrent_runs_see_only_their_own_error_flags(cuda_device):
    """One thread's launch puts a Jacobian column out of range while
    another thread's launch is clean: only the first thread's check
    raises, and the clean thread's check clears nothing of it."""
    import threading
    vol = V.benchmark_b2(SHAPE, cuda_device)
    cfg = V.b2_config()
    n = 4096
    state = ops.fresh_state(vol, n, seed=3, source=SRC)
    args = (vol.labels.reshape(-1), vol.media, state, SHAPE, 1.0, cfg, 8)
    barrier = threading.Barrier(2, timeout=60)
    raised = {}

    def run(name, bad):
        col = torch.zeros(n, dtype=torch.int32, device=cuda_device)
        if bad:
            col[7] = 5  # outside [0, 3)
        kernel.photon_step_cuda(*args, jac_w=torch.ones(n, device=cuda_device),
                                jac_col=col, jac_cols=3)
        barrier.wait()  # both launched
        if not bad:
            try:
                kernel.check_errors(cuda_device)
            except ValueError as e:
                raised[name] = e
        barrier.wait()  # the clean thread has checked
        if bad:
            try:
                kernel.check_errors(cuda_device)
            except ValueError as e:
                raised[name] = e

    threads = [threading.Thread(target=run, args=(name, bad))
               for name, bad in (("bad", True), ("clean", False))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert set(raised) == {"bad"}


@pytest.mark.cuda
def test_pool_rebinds_the_chunks_of_a_lost_device_type(cuda_device):
    """A card worker and a CPU worker: the chunks are bound to the two
    device types in turn; the CPU worker leaves before its first chunk,
    so its chunks are re-bound to the card, and the merged totals are
    one run on the card, bit for bit."""
    from repro_torch.resilience import DevicePool, DeviceSpec, FaultInjector
    vol = V.benchmark_b2((30, 30, 30))
    cfg = dataclasses.replace(V.b2_config(), steps_per_round=8,
                              n_time_gates=4, tmax_ns=0.5)
    src = {"type": "pencil", "pos": [15.0, 15.0, 0.0]}
    specs = [DeviceSpec(device=cuda_device, n_lanes=8192, label="card"),
             DeviceSpec(device="cpu", n_lanes=256, label="cpu")]
    pool = DevicePool(vol, cfg, specs, source=src,
                      fault_injector=FaultInjector(dropout={"cpu": 0}))
    got, rep = pool.run_fixed(40_000, 5_000, seed=5, deadline_s=300)
    want = S.simulate_fixed(vol, cfg, 40_000, 8192, 5, source=src,
                            device=cuda_device)
    for f, x in _int64_totals(want).items():
        assert torch.equal(_int64_totals(got)[f], x), f
    assert rep.rebound == 4 and rep.workers_quarantined == 1
    assert rep.merged == rep.n_chunks == 8


def _library_cannot_build():
    """In a worker's process: every kernel library fails to build."""
    from repro_torch.kernels.photon_step import photon_step as K

    def fail(groups):
        raise K.KernelError("nvcc failed (1): injected by the test")

    K._LIBRARIES.clear()
    K._load_library = fail


@pytest.mark.cuda
def test_pool_fails_when_the_card_kernel_cannot_build(cuda_device):
    """A card worker and a CPU worker, and the kernel's library cannot
    be built in the card worker's process: the run raises the build
    error from that process instead of retrying the card's chunks and
    rebinding them to the CPU's plain version."""
    from repro_torch.core import procs
    from repro_torch.resilience import DevicePool, DeviceSpec

    vol = V.benchmark_b1((16, 16, 16))
    cfg = dataclasses.replace(V.b1_config(), steps_per_round=8,
                              n_time_gates=3, tmax_ns=0.3)
    specs = [DeviceSpec(device=cuda_device, n_lanes=256, label="card"),
             DeviceSpec(device="cpu", n_lanes=256, label="cpu")]
    pool = DevicePool(vol, cfg, specs)
    card = procs.child(cuda_device, pool.workers[0].slot)
    try:
        card.call(_library_cannot_build, timeout=120)
        with pytest.raises(kernel.KernelError,
                           match="injected by the test") as ei:
            pool.run_fixed(2_000, 250, seed=5, deadline_s=120)
        assert f"pid {card.pid}" in "".join(ei.value.__notes__)
        assert pool.workers[0].health != "quarantined"
    finally:
        card.close()


@pytest.mark.cuda
def test_card_and_cpu_shards_hold_the_tolerance_of_two_arithmetics(
        cuda_device):
    """CPU and CUDA float32 functions differ in the last bit for some
    arguments, so a photon may take another path on each (the chip smoke
    run measured 37.6% of the fluence cells and 70.3% of the exitance
    bins equal on 12,208 photons of B1 at 60^3).  A ``[cuda:0, cpu]``
    run is held to the tolerance between two arithmetics, share by
    share: the card's shard bit-equal to its photons run alone on the
    card, and the CPU's shard against its photons run on the card,
    photons and launched weight exact, totals within 2e-3 of the
    share's launched weight, fluence within 1e-3 of the share's largest
    cell; the merged run adds the two shares."""
    from repro_torch.core import multidevice as M
    vol = V.benchmark_b1((30, 30, 30))
    cfg = dataclasses.replace(V.b1_config(), steps_per_round=8)
    src = {"type": "pencil", "pos": [15.0, 15.0, 0.0]}
    counts = [60_000, 2_000]
    parts = M.sharded_sim_fn(vol, cfg, [8192, 512], [cuda_device, "cpu"],
                             source=src)(counts, M.shard_offsets(counts), 5)
    # each share crossed from its device's process as CPU int64 totals
    assert not parts[0].fluence.is_cuda and not parts[1].fluence.is_cuda
    card = S.simulate_fixed(vol, cfg, 60_000, 8192, 5, source=src,
                            device=cuda_device)
    for f, x in _int64_totals(card).items():
        assert torch.equal(_int64_totals(parts[0])[f], x), f
    again = S.simulate_fixed(vol, cfg, 2_000, 8192, 5, source=src,
                             device=cuda_device, id_offset=60_000)
    got, want = (S.to_sim_result(S.merge_fixed([p])) for p in (
        parts[1], again))
    assert int(got.n_launched) == int(want.n_launched) == 2_000
    assert float(got.launched_w) == float(want.launched_w)
    for k in ("escaped_w", "timed_out_w"):
        assert abs(float(getattr(got, k)) - float(getattr(want, k))) <= \
            2e-3 * float(want.launched_w), k
    assert float((got.energy - want.energy).abs().max()) <= \
        1e-3 * float(want.energy.max())
    merged = S.merge_fixed(parts)
    assert int(merged.n_launched) == 62_000
    assert torch.equal(merged.fluence, parts[0].fluence.cpu()
                       + parts[1].fluence)


@pytest.mark.cuda
def test_examples_run_on_the_card(cuda_device, tmp_path):
    """quickstart and fault_tolerant_campaign at a small size on the
    card: exact accounting, the conservation residue, the axial decay
    fitted, and the campaign's own bit-identity checks (which raise)
    with the chaos drill merging every chunk after a retry."""
    from repro_torch.examples import fault_tolerant_campaign as campaign
    from repro_torch.examples import quickstart

    kernel.reset_launches()
    out = quickstart.run(size=30, photons=20_000, lanes=4096)
    assert sum(kernel.photon_step_cuda.launches_by.values()) > 0
    assert out["result"].energy.is_cuda
    assert int(out["result"].n_launched) == 20_000
    assert abs(out["balance"]["residue_frac"]) < 1e-4
    assert math.isfinite(out["mu_fit"]) and out["mu_fit"] > 0
    out = campaign.run(size=16, photons=4000, chunk=500, lanes=512,
                       checkpoint_dir=str(tmp_path))
    rep = out["report"]
    assert rep.n_chunks == rep.merged == 8 and rep.retries >= 1
    assert out["crash"] is not None and out["restored"] == (4, 4)
    assert int(out["resumed"].n_launched) == 4000


# --- the regeneration kernel (csrc/regenerate.cu) -------------------------

def _regen_sources():
    """The seven source types, planar with and without a pattern, line
    as a slit and isotropic; a scenario's parameters differ by ``i``, and
    some launch positions fall outside the volume (clamped)."""
    from repro_torch import sources as SR

    return {
        "pencil": lambda i: SR.Pencil(pos=(12.0 + i, 10.0, 0.0),
                                      dir=(0.0, 0.1 * i, 1.0)),
        "isotropic": lambda i: SR.IsotropicPoint(pos=(12.0, 10.0 + i, 8.0)),
        "cone": lambda i: SR.Cone(pos=(12.0, 10.0, 0.0),
                                  dir=(0.1 * i, 0.2, 1.0),
                                  half_angle_deg=10.0 + 3 * i),
        "gaussian": lambda i: SR.GaussianBeam(pos=(2.0 + i, 10.0, 0.0),
                                              dir=(0.0, 0.1, 1.0),
                                              waist=2.0 + 0.25 * i),
        "disk": lambda i: SR.Disk(pos=(1.0 + 2 * i, 10.0, 0.0), radius=3.0),
        "planar": lambda i: SR.Planar(pos=(-2.0, 4.0, 0.0),
                                      v1=(10.0 + i, 0.0, 0.0),
                                      v2=(0.0, 8.0, 1.0)),
        "planar+pattern": lambda i: SR.Planar(
            pos=(4.0, 4.0, 0.0), v1=(12.0, 0.0, 0.0), v2=(0.0, 8.0, 0.0),
            pattern=((1.0, 0.1 * (i + 1), 1.0), (0.5, 1.0, 0.25))),
        "line (slit)": lambda i: SR.Line(start=(-2.0 + i, 10.0, 0.0),
                                         end=(30.0, 10.0, 0.0)),
        "line (isotropic)": lambda i: SR.Line(start=(4.0, 10.0, 8.0),
                                              end=(20.0, 10.0 - i, 8.0),
                                              dir=None),
    }


def _staged_sampler(name, n_sc, dev):
    """A ``StagedSampler`` of ``n_sc`` scenarios of one source type, stacked as
    ``simulate_many`` stacks them."""
    from repro_torch.sources.base import StagedSampler, stage_source

    staged = [stage_source(_regen_sources()[name](i)) for i in range(n_sc)]
    return StagedSampler(staged[0][0], {
        k: torch.as_tensor(np.stack([np.asarray(s[k], np.float32)
                                     for _, s in staged]), device=dev)
        for k in staged[0][1]})


def _bits(x):
    """A tensor's bits: float32 as int32 words, so -0.0 != 0.0."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _regen_inputs(n_sc, n, extras, dev, seed):
    """A round's inputs: lanes dead at random, launch counts around
    their quotas, budgets below, above and at zero, id low words that
    carry across 2**32 (and a high word that wraps), seeds above 2**31."""
    g = torch.Generator().manual_seed(seed)
    N = n_sc * n
    state = ph.PhotonState(
        pos=torch.rand((N, 3), generator=g) * 10,
        dir=torch.rand((N, 3), generator=g) - 0.5,
        ivox=torch.randint(0, 9, (N, 3), generator=g, dtype=torch.int32),
        w=torch.rand((N,), generator=g),
        s_left=torch.rand((N,), generator=g),
        t=torch.rand((N,), generator=g),
        rng=torch.randint(0, 2**32, (N, 4), generator=g),
        alive=torch.rand((N,), generator=g) < 0.6)
    dead = (~state.alive).view(n_sc, n).sum(1)
    remaining = torch.stack([dead[s] // 2 if s % 3 == 0 else (
        dead[s] + 7 if s % 3 == 1 else torch.zeros_like(dead[s]))
        for s in range(n_sc)])
    launched = torch.randint(0, 3, (n_sc, n), generator=g)
    quota = torch.randint(0, 4, (n_sc, n), generator=g)
    next_id = (torch.tensor([2**32 - 40 - s for s in range(n_sc)]),
               torch.tensor([5] + [2**32 - 1 if s == 1 else 7 * s
                                   for s in range(1, n_sc)]))
    seeds = torch.randint(2**31, 2**32, (n_sc, 1), generator=g)
    launched_w = torch.randint(0, 2**40, (n_sc,), generator=g)
    ppath = torch.rand((N, 3), generator=g) if extras else None
    lane_ids = torch.randint(0, 2**32, (N, 2), generator=g) if extras else None

    def on(x):
        return None if x is None else x.to(dev)

    return (ph.PhotonState(*map(on, state)), on(remaining), on(launched),
            tuple(map(on, next_id)), on(quota), on(launched_w), on(seeds),
            on(ppath), on(lane_ids))


@pytest.mark.cuda
@pytest.mark.parametrize("extras", [False, True])
@pytest.mark.parametrize("scenarios", [1, 8])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("source", list(_regen_sources()))
def test_regeneration_kernel_matches_plain_regenerate(cuda_device, source,
                                                      mode, scenarios,
                                                      extras):
    """One kernel call gives every field and counter the plain
    ``PlainRegeneration`` gives on the card, bit for bit, each bound to
    clones of the same lanes and counters, at a lane count that is no
    multiple of the block size, and counts one launch."""
    from repro_torch.kernels.photon_step import regenerate as RG

    n = 300
    (state, remaining, launched, next_id, quota, launched_w, seeds, ppath,
     lane_ids) = _regen_inputs(scenarios, n, extras, cuda_device,
                               seed=scenarios + 3)
    sample = _staged_sampler(source, scenarios, cuda_device)
    ids_before = tuple(x.clone() for x in next_id)

    def call(cls):
        clone = (lambda x: None if x is None else x.clone())
        st = ph.PhotonState(*map(clone, state))
        rem, lau, lw, pp, ids = map(clone, (remaining, launched, launched_w,
                                            ppath, lane_ids))
        regen = cls(sample, mode, SHAPE, rem, lau, quota, lw, seeds,
                    3 if extras else 0, ids)
        new_id = tuple(x.clone() for x in regen(st, next_id, pp))
        return st, rem, lau, lw, pp, ids, new_id

    want = call(S.PlainRegeneration)
    key = RG.source_key(sample.source_cls, scenarios)
    before = kernel.photon_step_cuda.launches_by[key]
    got = call(RG.Regeneration)
    assert kernel.photon_step_cuda.launches_by[key] == before + 1
    for name, x, y in zip(ph.PhotonState._fields, got[0], want[0]):
        assert torch.equal(_bits(x), _bits(y)), name
    for name, x, y in zip(("remaining", "launched", "launched_w", "ppath",
                           "lane_ids"), got[1:6], want[1:6]):
        if x is None:
            assert y is None and not extras, name
        else:
            assert torch.equal(_bits(x), _bits(y)), name
    for x, y in zip(got[6], want[6]):
        assert torch.equal(x, y)
    # the old ids are left as they were; some lanes did relaunch
    assert all(torch.equal(x, y) for x, y in zip(next_id, ids_before))
    assert int((want[6][0] - next_id[0]).abs().sum()) > 0
    assert not torch.equal(want[3], launched_w)


def _fleet(vol, cfg, photons, sources, dets):
    from repro_torch import scenarios as SC

    return [SC.Scenario(vol, cfg, photons, seed=2**31 + 11, source=src,
                        detectors=dets, id_offset=2**32 - 3000 + k * photons)
            for k, src in enumerate(sources)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["b1", "b2-detect-static", "fleet"])
def test_runs_with_the_regeneration_kernel_match_the_plain_path(
        cuda_device, case, monkeypatch):
    """A whole run regenerating with the kernel gives every field of the
    plain path's run (``PlainRegeneration`` on the card) bit for bit, and calls
    the kernel once a round: a small B1 pencil run whose ids cross
    2**32, a B2 detection forward in static mode with records and
    counters, and a b2.sweep-shaped fleet of 8 disks in one batch."""
    from repro_torch import scenarios as SC

    def run():
        kernel.reset_launches()
        if case == "b1":
            vol = V.benchmark_b1(SHAPE)
            cfg = dataclasses.replace(V.b1_config(), steps_per_round=8)
            out = [S.simulate_fixed(vol, cfg, 20_000, 2048, seed=7,
                                    source=SRC, device=cuda_device,
                                    id_offset=2**32 - 5_000)]
        elif case == "b2-detect-static":
            vol = V.benchmark_b2(SHAPE)
            cfg = dataclasses.replace(V.b2_config(), steps_per_round=8,
                                      n_time_gates=4, tmax_ns=1.0,
                                      collect_stats=True)
            out = [S.simulate_fixed(
                vol, cfg, 12_000, 1000, seed=2**31 + 5, mode="static",
                source={"type": "disk", "pos": [12.0, 10.0, 0.0],
                        "radius": 3}, device=cuda_device, detectors=DETS,
                record_detected=4096)]
        else:
            vol = V.benchmark_b2((30, 30, 30))
            cfg = dataclasses.replace(V.b2_config(), steps_per_round=16,
                                      n_time_gates=50, tmax_ns=5.0)
            fleet = _fleet(vol, cfg, 4000, [
                {"type": "disk", "pos": [8.0 + 2 * k, 15.0, 0.0],
                 "radius": 2} for k in range(8)],
                [(18.0, 15.0, 2.0), (21.0, 15.0, 2.0), (24.0, 15.0, 2.0)])
            out = SC.simulate_many(fleet, n_lanes=1024, device=cuda_device,
                                   cache=SC.CompileCache())
        return out, dict(kernel.photon_step_cuda.launches_by)

    got, launches = run()
    rounds = max(int(torch.as_tensor(r.steps).max()) for r in got) // (
        16 if case == "fleet" else 8)
    key = {"b1": "regenerate/pencil", "b2-detect-static": "regenerate/disk",
           "fleet": "regenerate/disk/x8"}[case]
    # once a round issued: the rounds with work, then no-op rounds up to
    # the next host read
    every = S.ROUNDS_PER_READ
    assert launches[key] == -(-rounds // every) * every
    monkeypatch.setattr(S, "supports", lambda *a: False)
    want, plain = run()
    assert not any(k.startswith("regenerate/") for k in plain)
    for a, b in zip(got, want):
        for name, x, y in zip(a._fields, a, b):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), name
            else:
                assert x == y, name


# ---------------------------------------------------------------------------
# the round as one CUDA graph, replayed between host reads
# ---------------------------------------------------------------------------

GRAPH_CASES = ("dynamic", "static", "pencil", "fleet", "capped", "cancel")


def _graph_case_run(case, dev, cancel=None):
    """One run of a case through the round loop; returns its
    ``FixedResult``s and K."""
    disk = {"type": "disk", "pos": [12.0, 10.0, 0.0], "radius": 3}
    if case in ("dynamic", "static", "capped", "cancel"):
        vol = V.benchmark_b2(SHAPE)
        cfg = dataclasses.replace(
            V.b2_config(), steps_per_round=8, n_time_gates=4, tmax_ns=1.0,
            max_steps=203 if case == "capped" else V.b2_config().max_steps)
        run = S.build_fixed_fn(vol.shape, vol.unitinmm, cfg, 2048,
                               "static" if case == "static" else "dynamic",
                               disk, dev)
        return [run(vol.labels.reshape(-1), vol.media, 20_000, 2**31 + 7,
                    2**32 - 5_000, 0, cancel)], 8
    if case == "pencil":
        vol = V.benchmark_b1(SHAPE)
        cfg = dataclasses.replace(V.b1_config(), steps_per_round=16)
        return [S.simulate_fixed(vol, cfg, 30_000, 4096, seed=11,
                                 source=SRC, device=dev,
                                 id_offset=2**32 - 7_000)], 16
    # 8 scenarios in one launch a round: detectors, ppath, records, stats
    vol = V.benchmark_b2(SHAPE)
    cfg = dataclasses.replace(V.b2_config(), steps_per_round=16,
                              n_time_gates=10, tmax_ns=2.0,
                              collect_stats=True)
    n_sc = 8
    geom = det_geometry(as_detectors(DETS), dev)[None].repeat(n_sc, 1, 1)
    loop = S.build_round_loop(vol.shape, vol.unitinmm, cfg, 1024,
                              "dynamic", _staged_sampler("disk", n_sc, dev),
                              dev, len(DETS), 2048)
    return loop(vol.labels.reshape(-1), vol.media[None].repeat(n_sc, 1, 1),
                geom, [3000 + 500 * k for k in range(n_sc)],
                [2**31 + k for k in range(n_sc)],
                [2**32 - 1000 * (k + 1) for k in range(n_sc)], [0] * n_sc,
                cancel), 16


@pytest.mark.cuda
@pytest.mark.parametrize("case", GRAPH_CASES)
def test_graphed_loop_gives_the_eager_loops_bits(cuda_device, case,
                                                  monkeypatch):
    """The loop on the card (the round captured once as a CUDA graph and
    replayed) gives every ``FixedResult`` field of the same loop issuing
    each round eagerly, bit for bit: dynamic and static mode, a pencil
    beam whose ids cross 2**32, 8 scenarios with detectors, records and
    stats, a ``max_steps`` cap of 203 segments at K = 8 (26 rounds, no
    multiple of ROUNDS_PER_READ), runs that end inside a batch of
    replays, and a cancel set before the run.  The replays count as the
    launches the device ran: the step and regeneration keys of
    ``launches_by`` read what the eager loop's read, and ``round_graph``
    one a replay."""
    import threading

    cancel = threading.Event()
    if case == "cancel":
        cancel.set()

    def run():
        kernel.reset_launches()
        if case == "cancel":
            with pytest.raises(S.RunCancelled, match="after 0 steps"):
                _graph_case_run(case, cuda_device, cancel)
            out, k = [], 8
        else:
            out, k = _graph_case_run(case, cuda_device)
        torch.cuda.synchronize()
        return out, k, collections.Counter(kernel.photon_step_cuda.launches_by)

    got, k, graphed = run()
    monkeypatch.setattr(S, "graph_applies", lambda *a: False)
    want, _, eager = run()
    assert eager["round_graph"] == 0
    issued = sum(v for key, v in eager.items() if key.startswith(
        ("noreflect/", "reflect/")))
    if case == "cancel":
        assert graphed == eager == collections.Counter()
        return
    every = S.ROUNDS_PER_READ
    rounds = max(int(torch.as_tensor(r.steps).max()) for r in got) // k
    if case == "capped":
        assert rounds == issued == 26 and got[0].steps == 208
        assert int(got[0].timed_out) > 0
    else:
        # the work ends inside a batch; the batch's last rounds are no-ops
        assert rounds % every and issued == -(-rounds // every) * every
    assert graphed["round_graph"] == issued - 1
    graphed.pop("round_graph")
    assert graphed == eager
    assert len(got) == len(want) == (8 if case == "fleet" else 1)
    for a, b in zip(got, want):
        for name, x, y in zip(a._fields, a, b):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), name
            else:
                assert x == y, name
    if case == "fleet":
        assert all(int(r.det_rec_n) > 0 for r in got)
        steps = [r.steps for r in got]
        assert len(set(steps)) > 1  # scenarios freeze rounds apart


@pytest.mark.cuda
def test_profiler_sees_the_round_graphs_kernels(cuda_device):
    """Under ``torch.profiler`` the graph's kernels show by name, one step
    kernel a round issued, and the ``run`` span says how the loop went:
    replays cover all rounds but the first, and the host read the device
    once every ROUNDS_PER_READ rounds."""
    import json
    import os
    import tempfile

    from repro_torch import telemetry as T
    from repro_torch.launch import profile_run as P

    vol = V.benchmark_b1((40, 40, 40), cuda_device)
    cfg = dataclasses.replace(V.b1_config(), steps_per_round=16)
    src = {"type": "pencil", "pos": [20.0, 20.0, 0.0]}

    def solve():
        return S.simulate_fixed(vol, cfg, 200_000, 16384, seed=3,
                                source=src, device=cuda_device)

    solve()
    torch.cuda.synchronize()
    T.capture_tracer().events.clear()
    kernel.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            got = solve()
            torch.cuda.synchronize()
        events = T.capture_tracer().events
        (run,) = [e for e in events if e.name == "run"]
        replays = sum(1 for e in events if e.name == "round.replay")
    finally:
        T.capture_tracer().events.clear()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    steps = [name for grp, name, *_ in P.device_events_of(trace)
             if grp == "photon_step"]
    rounds = got.steps // 16
    every = S.ROUNDS_PER_READ
    issued = -(-rounds // every) * every
    launches = kernel.photon_step_cuda.launches_by
    assert launches[kernel.variant_name(0, cfg)] == issued == len(steps)
    assert all("photon_step_kernel" in name for name in steps)
    assert run.args["replays"] == replays == launches["round_graph"]
    assert replays == issued - 1 and replays >= 0.95 * rounds
    assert run.args["host_reads"] <= rounds / every + 2


# ---------------------------------------------------------------------------
# the round's tail in the step kernel's epilogue
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mid-run", "all die"])
@pytest.mark.parametrize("S_,n", [(1, 300), (8, 300), (8, 40_000)])
def test_the_kernels_tail_matches_the_plain_tail(cuda_device, S_, n, case):
    """Two launches in a row given a tail (the second reads the flags
    and ticket the first cleared) leave the escaped and timed-out totals,
    the round counts, the work flags and ``more`` that the plain
    version's tail leaves (``_total_rows`` of its per-lane weights, the
    rounds where work held, a lane alive or budget left), with the lane
    state and grids of a launch without one; 300 lanes a scenario is no
    multiple of the block size, 8 x 40000 lanes 1256 blocks."""
    g = torch.Generator().manual_seed(S_ + n)
    vol = V.benchmark_b2(SHAPE, cuda_device)
    cfg = dataclasses.replace(V.b2_config(), n_time_gates=3,
                              tmax_ns=0.5 if case == "mid-run" else 1e-4)
    disk = {"type": "disk", "pos": [12.0, 10.0, 0.0], "radius": 3}
    state = ops.fresh_state(vol, S_ * n, seed=S_, source=disk)
    state = state._replace(alive=(torch.rand(S_ * n, generator=g)
                                  < 0.67).to(cuda_device))
    media = vol.media[None].repeat(S_, 1, 1).contiguous()
    remaining = torch.randint(0, 40, (S_,), generator=g)
    remaining[1::3] = 0

    def tail_on(dev):
        h = torch.Generator().manual_seed(1)
        t = kernel.round_tail(torch.randint(0, 2**40, (S_,), generator=h),
                              torch.randint(0, 2**40, (S_,), generator=h),
                              remaining.clone())
        t.work.copy_(torch.rand(S_, generator=h) < 0.7)
        return kernel.RoundTail(*(x.to(dev) for x in t))

    got, want = tail_on(cuda_device), tail_on(cuda_device)
    st_got = st_want = state
    for _ in range(2):
        args = (vol.labels.reshape(-1), media)
        rest = (SHAPE, 1.0, cfg, 4)
        plain = kernel.photon_step_cuda(*args, st_want, *rest)
        R.round_tail_ref(want, plain[3], plain[4], plain[0].alive)
        outs = kernel.photon_step_cuda(*args, st_got, *rest, tail=got)
        assert outs[3] is None and outs[4] is None
        for x, y in zip(outs[0], plain[0]):
            assert torch.equal(x, y)
        assert torch.equal(outs[1], plain[1])
        assert torch.equal(outs[2], plain[2])
        for name, x, y in zip(kernel.RoundTail._fields, got, want):
            assert torch.equal(x, y), name
        st_got, st_want = outs[0], plain[0]
    kernel.check_errors(cuda_device)
    assert bool(want.more) == bool(want.work.any())
    if case == "all die":
        assert not bool(st_want.alive.any())
        assert torch.equal(want.work, want.remaining > 0)


def _plain_tail_path(monkeypatch):
    """The loop's plain path: ``PlainRegeneration`` in eager rounds (no
    graph), and each photon step given no tail and no records, its tail
    done after it in PyTorch operations (``ref.round_tail_ref``) and its
    records appended by ``simulator._append_records``."""
    step = S.photon_steps

    def step_then_tail(*args, tail=None, records=None, **kw):
        outs = step(*args, **kw)
        R.round_tail_ref(tail, outs[3], outs[4], outs[0].alive)
        if records is not None:
            S._append_records(records.rec, records.kept, records.overflow,
                              records.lane_ids, outs[8], outs[9],
                              records.rec.shape[1] - 1)
        return outs

    monkeypatch.setattr(S, "supports", lambda *a: False)
    monkeypatch.setattr(S, "photon_steps", step_then_tail)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["b1", "sweep", "skinvessel", "head5",
                                  "head5-overflow"])
def test_graphed_runs_with_the_fused_tail_give_the_plain_paths_bits(
        cuda_device, case, monkeypatch):
    """A run on the card (the regeneration kernel, the round a CUDA
    graph, the tail in the step's epilogue, counted once a round issued
    under ``TAIL_KEY``, and with records their append there too, under
    ``RECORDS_KEY``) gives every ``FixedResult`` field of the plain
    path's run bit for bit, the records in slot order: a B1 pencil run
    whose ids cross 2**32, a b2.sweep-shaped fleet of 8 disks with 3
    detectors and 50 gates in one batch, a skin-vessel-shaped run (five
    media, 5 um voxels, a disk beam to 50 ns), and a head5-shaped run
    with records (a 40 x 40 x 30 mm cut of the head, three detectors,
    50 gates), once with room for every record and once with a buffer
    that fills part-way through a round."""
    from repro_torch import scenarios as SC

    def run():
        kernel.reset_launches()
        if case == "b1":
            vol = V.benchmark_b1(SHAPE)
            cfg = dataclasses.replace(V.b1_config(), steps_per_round=16)
            out = [S.simulate_fixed(vol, cfg, 30_000, 4096, seed=2**31 + 1,
                                    source=SRC, device=cuda_device,
                                    id_offset=2**32 - 7_000)]
        elif case == "sweep":
            vol = V.benchmark_b2((30, 30, 30))
            cfg = dataclasses.replace(V.b2_config(), steps_per_round=16,
                                      n_time_gates=50, tmax_ns=5.0)
            fleet = _fleet(vol, cfg, 4000, [
                {"type": "disk", "pos": [8.0 + 2 * k, 15.0, 0.0],
                 "radius": 2} for k in range(8)],
                [(18.0, 15.0, 2.0), (21.0, 15.0, 2.0), (24.0, 15.0, 2.0)])
            out = SC.simulate_many(fleet, n_lanes=1024, device=cuda_device,
                                   cache=SC.CompileCache())
        elif case == "skinvessel":
            vol = V.volume_from_shapes(
                [{"Grid": {"Tag": 1, "Size": [24, 24, 24]}},
                 {"ZLayers": [[1, 3, 1], [4, 5, 4], [6, 24, 3]]},
                 {"Cylinder": {"Tag": 2, "C0": [0, 12.5, 12.5],
                               "C1": [24, 12.5, 12.5], "R": 3}}],
                list(V.SKINVESSEL_MEDIA), V.SKINVESSEL_UNITINMM)
            cfg = dataclasses.replace(V.skinvessel_config(),
                                      steps_per_round=16)
            out = [S.simulate_fixed(
                vol, cfg, 20_000, 4096, seed=2**31 + 3,
                source={"type": "disk", "pos": [12.0, 12.0, 3.0],
                        "dir": [0.0, 0.0, 1.0], "radius": 6.0},
                device=cuda_device, id_offset=2**32 - 9_000)]
        else:
            vol, cfg, src, dets = _head5_cut(cuda_device)
            out = [S.simulate_fixed(
                vol, cfg, 60_000, 8192, seed=2**31 + 5, source=src,
                device=cuda_device, detectors=dets,
                record_detected=1 << 16 if case == "head5" else 300,
                id_offset=2**32 - 20_000)]
        torch.cuda.synchronize()
        return out, collections.Counter(kernel.photon_step_cuda.launches_by)

    got, graphed = run()
    issued = sum(v for key, v in graphed.items()
                 if key.startswith(("noreflect/", "reflect/")))
    assert graphed["round_graph"] == issued - 1 > 0
    assert graphed[kernel.TAIL_KEY] == issued
    assert graphed[kernel.RECORDS_KEY] == (
        issued if case.startswith("head5") else 0)
    if case == "head5":
        assert 0 < int(got[0].det_rec_n) < 1 << 16
        assert int(got[0].det_rec_overflow) == 0
    elif case == "head5-overflow":
        assert int(got[0].det_rec_n) == 300
        assert int(got[0].det_rec_overflow) > 0
    _plain_tail_path(monkeypatch)
    want, plain = run()
    assert (plain["round_graph"] == plain[kernel.TAIL_KEY]
            == plain[kernel.RECORDS_KEY] == 0)
    for a, b in zip(got, want):
        for name, x, y in zip(a._fields, a, b):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), name
            else:
                assert x == y, name


@pytest.mark.cuda
def test_the_kernels_tail_range_check_fires(cuda_device):
    """A lane of weight 1e7 timed out in a medium that absorbs nothing
    (so no deposit is out of range) holds 2**44 units of the totals: the
    tail adds nothing for it and flags the launch, which
    ``check_errors`` raises; the same launch without a tail flags
    nothing.  A total pushed past 2**63 - 1 is flagged too."""
    vol = V.benchmark_b1(SHAPE, cuda_device)
    media = vol.media.clone()
    media[:, 0] = 0.0
    cfg = dataclasses.replace(V.b1_config(), tmax_ns=1.0)
    n = 4096
    state = ops.fresh_state(vol, n, seed=3, source=SRC)
    lane5 = torch.arange(n, device=cuda_device) == 5
    heavy = state._replace(
        w=torch.where(lane5, torch.full_like(state.w, 1e7), state.w),
        t=torch.where(lane5, torch.full_like(state.t, 2.0), state.t))
    args = (vol.labels.reshape(-1), media[None], heavy, SHAPE, 1.0, cfg, 1)
    kernel.check_errors(cuda_device)  # no flag left from earlier launches
    out = kernel.photon_step_cuda(*args)
    assert float(out[4][5]) == 1e7
    kernel.check_errors(cuda_device)
    zero = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    tail = kernel.round_tail(zero.clone(), zero.clone(), zero.clone())
    kernel.photon_step_cuda(*args, tail=tail)
    with pytest.raises(OverflowError):
        kernel.check_errors(cuda_device)
    assert int(tail.timed_out) == 0
    full = kernel.round_tail(zero.clone(),
                             torch.full_like(zero, 2**63 - 1), zero.clone())
    kernel.photon_step_cuda(vol.labels.reshape(-1), media[None], state,
                            SHAPE, 1.0, dataclasses.replace(cfg, tmax_ns=1e-4),
                            1, tail=full)
    with pytest.raises(OverflowError):
        kernel.check_errors(cuda_device)


# ---------------------------------------------------------------------------
# the records' append in the step kernel's epilogue
# ---------------------------------------------------------------------------


def _head5_cut(dev):
    """A 40 x 40 x 30 mm cut of the five-layer head with head5.td's
    media and gates (K = 16), a pencil at its centre and three 2 mm
    detectors 5, 10 and 15 mm from it: ``(vol, cfg, source, dets)``."""
    vol = V.volume_from_shapes(
        [{"Grid": {"Tag": 5, "Size": [40, 40, 30]}},
         {"ZLayers": [[1, 3, 1], [4, 10, 2], [11, 12, 3], [13, 16, 4]]}],
        list(V.HEAD5_MEDIA), V.HEAD5_UNITINMM, dev)
    cfg = dataclasses.replace(V.head5_config(), steps_per_round=16)
    src = {"type": "pencil", "pos": [20.0, 20.0, 0.0], "dir": [0.0, 0.0, 1.0]}
    dets = [{"x": 20 + d, "y": 20, "radius": 2} for d in (5, 10, 15)]
    return vol, cfg, src, dets


def _head5_launch(dev, round_no=40):
    """A mid-run launch of head5.td's shape: the five-layer head, its
    probe (four detectors, 50 gates), 262144 lanes, K = 16, records."""
    vol = V.benchmark_head5(dev)
    cfg = dataclasses.replace(V.head5_config(), steps_per_round=16)
    return kept_launch(lambda: S.simulate_fixed(
        vol, cfg, 3_000_000, 262_144, seed=2**31 + 29,
        source=V.HEAD5_SOURCE, device=dev, detectors=V.HEAD5_DETECTORS,
        record_detected=V.HEAD5_RECORD_SLOTS), round_no)


def _fleet_launch(dev, n_sc=2, n=40_000, round_no=6):
    """A mid-run batched launch of ``n_sc`` disk scenarios of ``n`` lanes
    (157 blocks each) with three detectors and records."""
    vol = V.benchmark_b2(SHAPE, dev)
    cfg = dataclasses.replace(V.b2_config(), steps_per_round=16,
                              n_time_gates=10, tmax_ns=2.0)
    geom = det_geometry(as_detectors(DETS), dev)[None].repeat(n_sc, 1, 1)
    loop = S.build_round_loop(vol.shape, vol.unitinmm, cfg, n, "dynamic",
                              _staged_sampler("disk", n_sc, dev), dev,
                              len(DETS), 4096)
    return kept_launch(lambda: loop(
        vol.labels.reshape(-1), vol.media[None].repeat(n_sc, 1, 1), geom,
        [200_000] * n_sc, [2**31 + k for k in range(n_sc)],
        [2**32 - 1000 * (k + 1) for k in range(n_sc)], [0] * n_sc),
        round_no)


def _records_on(dev, S_, N, capacity, kept, seed=0):
    """Record buffers of S_ scenarios: rows and ids of random words (the
    append must leave the rows it does not write as they are), the given
    kept counts and some overflow already counted."""
    g = torch.Generator().manual_seed(seed)
    i64 = dict(dtype=torch.int64)
    buffers = (torch.randint(0, 2**32, (S_, capacity + 1, 4), generator=g),
               torch.as_tensor(kept, **i64).reshape(S_),
               torch.randint(0, 5, (S_,), generator=g),
               torch.randint(0, 2**32, (N, 2), generator=g))
    return kernel.RoundRecords(*(x.to(dev) for x in buffers),
                               *kernel.record_scratch(S_, N // S_, dev))


def _append_matches_plain(dev, args, kw, capacity, kept):
    """The launch given records against the same launch without them and
    ``_append_records`` on its per-lane captures: the captures, the rows
    ``rec[:, :capacity]``, the kept and overflow counts bit for bit, and
    the scratch zero again.  Returns the round's captures a scenario."""
    media = args[1]
    S_ = media.shape[0] if media.ndim == 3 else 1
    N = args[2].w.shape[0]
    i64 = dict(dtype=torch.int64, device=dev)

    def launch(**extra):
        kwc = dict(kw, totals=[t.clone() for t in kw["totals"]])
        tail = kernel.round_tail(torch.zeros(S_, **i64),
                                 torch.zeros(S_, **i64),
                                 torch.zeros(S_, **i64))
        return kernel.photon_step_cuda(*args, **kwc, tail=tail, **extra)

    got = _records_on(dev, S_, N, capacity, kept)
    want = kernel.RoundRecords(*(x.clone() for x in got))
    outs = launch(records=got)
    plain = launch()
    kernel.check_errors(dev)
    capd, capg = plain[8], plain[9]
    assert torch.equal(outs[8], capd) and torch.equal(outs[9], capg)
    S._append_records(want.rec, want.kept, want.overflow, want.lane_ids,
                      capd, capg, capacity)
    assert torch.equal(got.rec[:, :capacity], want.rec[:, :capacity])
    assert torch.equal(got.kept, want.kept)
    assert torch.equal(got.overflow, want.overflow)
    assert not bool(got.counts.any())
    return (capd >= 0).view(S_, -1).sum(1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mid-run", "overflow", "no capture"])
def test_the_kernels_append_matches_append_records(cuda_device, case):
    """head5.td's mid-run launch (262144 lanes, 1024 blocks, 50 gates,
    four detectors) appends in its epilogue what ``_append_records``
    appends from the same launch's per-lane captures: mid-run into a
    buffer of 2**20 slots already holding rows, part-way past the
    capacity (2 slots left for more captures, the rest dropped and
    counted), and, with every lane dead, nothing."""
    args, kw = _head5_launch(cuda_device)
    if case == "no capture":
        st = args[2]
        args = (*args[:2], st._replace(alive=torch.zeros_like(st.alive)),
                *args[3:])
    capacity = 64 if case == "overflow" else 1 << 20
    kept = capacity - 2 if case == "overflow" else 12_345
    n_cap = _append_matches_plain(cuda_device, args, kw, capacity, kept)
    if case == "no capture":
        assert int(n_cap.sum()) == 0
    else:
        assert int(n_cap.sum()) > 2


@pytest.mark.cuda
@pytest.mark.parametrize("overflow", [False, True])
def test_the_kernels_append_over_two_scenarios(cuda_device, overflow):
    """A launch of two scenarios of 40000 lanes appends each scenario's
    captures to its own buffer at its own kept count, as
    ``_append_records`` does; one scenario's buffer may fill while the
    other's does not."""
    args, kw = _fleet_launch(cuda_device)
    kept = [10, 4096 - 1] if overflow else [0, 100]
    n_cap = _append_matches_plain(cuda_device, args, kw, 4096, kept)
    assert bool((n_cap > 1).all())


@pytest.mark.cuda
def test_graphed_runs_with_records_append_in_the_step(cuda_device):
    """A head5-shaped run on the card (a 40 x 40 x 30 mm cut of the head,
    its probe, 16384 lanes) appends in every step it issues
    (``RECORDS_KEY`` counts one a step launch), keeps every record it
    captured, and gives the same bits run after run."""
    vol, cfg, src, dets = _head5_cut(cuda_device)

    def run():
        kernel.reset_launches()
        out = S.simulate_fixed(vol, cfg, 200_000, 16_384, seed=2**31 + 3,
                               source=src, device=cuda_device,
                               detectors=dets, record_detected=1 << 16,
                               id_offset=2**32 - 50_000)
        torch.cuda.synchronize()
        return out, collections.Counter(kernel.photon_step_cuda.launches_by)

    (got, launches), (again, _) = run(), run()
    issued = sum(v for key, v in launches.items()
                 if key.startswith(("noreflect/", "reflect/")))
    assert launches["round_graph"] == issued - 1 > 0
    assert launches[kernel.RECORDS_KEY] == launches[kernel.TAIL_KEY] == issued
    assert 0 < int(got.det_rec_n) < 1 << 16
    assert int(got.det_rec_overflow) == 0
    for name, x, y in zip(got._fields, got, again):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name
        else:
            assert x == y, name
