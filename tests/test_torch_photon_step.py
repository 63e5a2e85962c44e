"""The port's photon-step kernel module against the reference.

The plain PyTorch version (``repro_torch...ref.photon_steps_ref``, what
the CUDA kernel is held against on the card) is compared with the JAX
oracle ``ref.photon_steps_ref`` and with the Pallas kernel in interpret
mode, K = 8 steps from fresh pencil photons on (24, 20, 16) B1 and B2
with 1 and 4 time gates.

Tolerances: the RNG words never depend on the float physics, so they
are bit-equal.  The float state is IEEE float32 in the port and
FMA-contracted in XLA's CPU code (see test_torch_photon.py), and B1's
HG cancellation can turn that into a different voxel crossing, so
alive/ivox must agree on >= 99% of lanes; fluence and exitance totals
(sums over all lanes) agree to 1e-4 relative.  The port's grids are
int64 fixed point (``spec.FIXED_SHIFT``), compared as the float32
values ``core.fixed.from_fixed`` gives, the replay Jacobian too.

The optional output groups are held the same way, with two detectors
at and beside the pencil so that backscattered photons are captured:
``cap_det`` / ``cap_gate`` equal on >= 99% of lanes, the TPSF,
detector path sums and replay Jacobian totals within 1e-4 relative,
and the stats block's live-segment column exact on lanes that agree.
Measured on these inputs: every lane agrees, ``det_w`` totals are
equal, ``det_ppath`` and ``jac`` totals differ by <= 3.9e-7 relative.
"""

import ast
import dataclasses
import pathlib
import types

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import detectors as JD  # noqa: E402
from repro import sources as JS  # noqa: E402
from repro.core import photon as jph  # noqa: E402
from repro.core import volume as JV  # noqa: E402
from repro.kernels.photon_step import ref as jref  # noqa: E402
from repro.kernels.photon_step.photon_step import \
    photon_step_pallas  # noqa: E402
from repro_torch.core import photon as tph  # noqa: E402
from repro_torch.core.fixed import from_fixed  # noqa: E402
from repro_torch import detectors as TD  # noqa: E402
from repro_torch.core import volume as TV  # noqa: E402
from repro_torch.kernels.photon_step import ops  # noqa: E402
from repro_torch.kernels.photon_step import photon_step as tkernel  # noqa: E402
from repro_torch.kernels.photon_step import ref as tref  # noqa: E402
from repro_torch.kernels.photon_step import spec as tspec  # noqa: E402

SHAPE = (24, 20, 16)
N, K, SEED = 256, 8, 5
REPO = pathlib.Path(__file__).resolve().parents[1]


def _setup(bench, ntg):
    jv = JV.benchmark_b2(SHAPE) if bench == "B2" else JV.benchmark_b1(SHAPE)
    cfg = dataclasses.replace(
        JV.b2_config() if bench == "B2" else JV.b1_config(),
        n_time_gates=ntg, tmax_ns=0.02)
    tv = TV.volume_from_arrays(np.asarray(jv.labels), np.asarray(jv.media))
    src = JS.Pencil(pos=(12.0, 10.0, 0.0))
    pos, d, w0, rng = src.sample(jnp.arange(N, dtype=jnp.uint32),
                                 jnp.uint32(SEED))
    jst = jph.launch(pos, d, w0, rng, jnp.ones((N,), bool), SHAPE)
    tst = tph.state_from_arrays(*[np.asarray(x) for x in jst])
    return jv, tv, cfg, TV.SimConfig(**dataclasses.asdict(cfg)), jst, tst


def _float_grids(got):
    """The port's fixed-point fluence, exitance, TPSF, path sums and, in
    a call of every group, Jacobian as float32, by their positions in a
    call's outputs."""
    got = list(got)
    for i, name in ((1, "fluence"), (2, "exitance"), (6, "det_w"),
                    (7, "det_ppath"), (10, "jac")):
        if i < len(got) and (i < 5 or len(got) > 7) and \
                (i < 10 or len(got) == 12) and got[i].dtype == torch.int64:
            got[i] = from_fixed(got[i], tspec.FIXED_SHIFT[name])
    return got


def _compare(got, ref):
    st, flu, exi, esc, timed = _float_grids(got)
    rst, rflu, rexi, resc, rtimed = (np.asarray(x) if i else x
                                     for i, x in enumerate(ref))
    g = tph.state_to_numpy(st)
    np.testing.assert_array_equal(g["rng"], np.asarray(rst.rng))
    assert (g["alive"] == np.asarray(rst.alive)).mean() >= 0.99
    assert (g["ivox"] == np.asarray(rst.ivox)).all(axis=1).mean() >= 0.99
    for a, b in ((flu, rflu), (exi, rexi), (esc, resc), (timed, rtimed)):
        a = float(a.double().sum())
        b = float(np.asarray(b, np.float64).sum())
        assert abs(a - b) <= 1e-4 * max(abs(b), 1e-6), (a, b)
    assert flu.shape == rflu.shape and exi.shape == rexi.shape


@pytest.mark.parametrize("ntg", [1, 4])
@pytest.mark.parametrize("bench", ["B1", "B2"])
def test_plain_version_matches_jax_oracle_and_pallas(bench, ntg):
    jv, tv, cfg, tcfg, jst, tst = _setup(bench, ntg)
    labels = jv.labels.reshape(-1)
    got = tref.photon_steps_ref(tv.labels.reshape(-1), tv.media, tst, SHAPE,
                                1.0, tcfg, K)
    assert got[1].shape == (np.prod(SHAPE) * ntg,)
    _compare(got, jref.photon_steps_ref(labels, jv.media, jst, SHAPE, 1.0,
                                        cfg, K))
    _compare(got, photon_step_pallas(labels, jv.media, jst, SHAPE, 1.0, cfg,
                                     K, block_lanes=128, interpret=True))
    # a short tmax gate makes both time-gate paths and timed-out weight
    # part of the comparison
    assert float(got[4].sum()) > 0


DETS = [{"x": 12.0, "y": 10.0, "radius": 3.0},
        {"x": 15.0, "y": 10.0, "radius": 2.0}]
JAC_COLS = 3


def _group_args(jv, n_media):
    """The optional-group inputs, for the port and for JAX."""
    rng = np.random.default_rng(3)
    jac_w = rng.uniform(0.1, 1.0, N).astype(np.float32)
    jac_col = rng.integers(0, JAC_COLS, N).astype(np.int32)
    t = dict(ppath=torch.zeros(N, n_media),
             det_geom=TD.det_geometry(TD.as_detectors(DETS)))
    j = dict(ppath=jnp.zeros((N, n_media)),
             det_geom=JD.det_geometry(JD.as_detectors(DETS)))
    tj = dict(jac_w=torch.tensor(jac_w), jac_col=torch.tensor(jac_col),
              jac_cols=JAC_COLS)
    jj = dict(jac_w=jnp.asarray(jac_w), jac_col=jnp.asarray(jac_col),
              jac_cols=JAC_COLS)
    return t, j, tj, jj


def _compare_groups(got, ref, lanes_agree):
    """Groups after the base outputs: (ppath, det_w, det_ppath, cap_det,
    cap_gate[, jac][, stats])."""
    ref = [np.asarray(x) for x in ref]
    np.testing.assert_allclose(got[0].numpy()[lanes_agree],
                               ref[0][lanes_agree], rtol=1e-4, atol=1e-3)
    for i in (1, 2) + ((5,) if len(got) > 6 else ()):
        a, b = float(got[i].double().sum()), float(ref[i].astype(
            np.float64).sum())
        assert abs(a - b) <= 1e-4 * max(abs(b), 1e-6), (i, a, b)
    assert got[1].shape == ref[1].shape and got[2].shape == ref[2].shape
    for i in (3, 4):
        assert got[i].dtype == torch.int32
        assert (got[i].numpy() == ref[i]).mean() >= 0.99
    assert (got[3].numpy() >= 0).sum() > 20  # the detectors caught photons
    stats, rstats = got[-1].numpy(), ref[-1]
    np.testing.assert_array_equal(stats[lanes_agree, 0],
                                  rstats[lanes_agree, 0])
    np.testing.assert_allclose(stats[:, 1].sum(), rstats[:, 1].sum(),
                               rtol=1e-4)


@pytest.mark.parametrize("ntg", [1, 4])
@pytest.mark.parametrize("bench", ["B1", "B2"])
def test_plain_version_groups_match_jax_oracle_and_pallas(bench, ntg):
    jv, tv, cfg, tcfg, jst, tst = _setup(bench, ntg)
    labels = jv.labels.reshape(-1)
    t, j, tj, jj = _group_args(jv, jv.media.shape[0])
    targs = (tv.labels.reshape(-1), tv.media, tst, SHAPE, 1.0, tcfg, K)
    jargs = (labels, jv.media, jst, SHAPE, 1.0, cfg, K)
    # every group at once against the oracle
    got = _float_grids(tref.photon_steps_ref(*targs, **t, record=True, **tj,
                                             stats=True))
    ref = jref.photon_steps_ref(*jargs, **j, record=True, **jj, stats=True)
    assert len(got) == len(ref) == tspec.output_arity(2, True, JAC_COLS, True)
    _compare(got[:5], ref[:5])
    agree = (got[0].alive.numpy() == np.asarray(ref[0].alive)) & (
        got[0].ivox.numpy() == np.asarray(ref[0].ivox)).all(axis=1)
    assert got[10].shape == (np.prod(SHAPE) * JAC_COLS,)
    _compare_groups(got[5:], ref[5:], agree)
    # detectors and records against the Pallas kernel in interpret mode
    pal = photon_step_pallas(*jargs, block_lanes=128, interpret=True, **j,
                             record=True, stats=True)
    _compare_groups(got[5:10] + got[11:], pal[5:], agree)


def test_spec_constants_equal_reference():
    src = (REPO / "src/repro/kernels/photon_step/spec.py").read_text()
    ref_consts = {}
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Name):
            name = node.targets[0].id
            if name in ("STATE_FIELDS", "BASE_OUTPUTS", "OUTPUT_GROUPS",
                        "CORE_PARAMS", "EXT_PARAMS", "STATE_LANE_BYTES"):
                ref_consts[name] = ast.literal_eval(node.value)
    assert len(ref_consts) == 6
    for name, value in ref_consts.items():
        assert getattr(tspec, name) == value, name
    from repro.kernels.photon_step import spec as jspec
    for args in ((0, False, 0, False), (2, True, 0, True), (1, False, 3, False)):
        for packed in (True, False):
            assert tspec.output_arity(*args, packed_state=packed) == \
                jspec.output_arity(*args, packed_state=packed)


def test_cpu_dispatch_is_the_plain_version():
    """CPU tensors run the host kernel (its launch is counted), which
    gives the plain version's bits."""
    _, tv, _, tcfg, _, tst = _setup("B2", 1)
    args = (tv.labels.reshape(-1), tv.media, tst, SHAPE, 1.0, tcfg, K)
    tkernel.reset_launches()
    a = ops.photon_steps(*args)
    assert tkernel.photon_step_cuda.launches_by == {
        "host/reflect/exact/base": 1}
    b = tref.photon_steps_ref(*args)
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)


def test_cuda_tensor_goes_to_the_kernel_and_never_falls_back(monkeypatch):
    _, tv, _, tcfg, _, tst = _setup("B1", 1)
    fake = tst._replace(w=types.SimpleNamespace(device=torch.device("cuda"),
                                                shape=(N,)))
    seen = []
    monkeypatch.setattr(ops, "photon_step_cuda",
                        lambda *a, **k: seen.append(a) or "kernel")
    monkeypatch.setattr(ops, "photon_step_host",
                        lambda *a, **k: pytest.fail("fell back to the CPU"))
    monkeypatch.setattr(tref, "photon_steps_ref",
                        lambda *a, **k: pytest.fail("fell back to plain"))
    assert ops.photon_steps(tv.labels.reshape(-1), tv.media, fake, SHAPE,
                            1.0, tcfg, K) == "kernel"
    assert len(seen) == 1
    monkeypatch.undo()
    # the real wrapper raises on what it cannot launch
    with pytest.raises(ValueError):
        tkernel.photon_step_cuda(tv.labels.reshape(-1), tv.media, fake,
                                 SHAPE, 1.0, tcfg, K)
    with pytest.raises(ValueError):
        tkernel.photon_step_cuda(tv.labels.reshape(-1), tv.media, tst,
                                 SHAPE, 1.0, tcfg, K)


def test_cuda_requested_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.simulate_kernel(TV.benchmark_b1((8, 8, 8)), TV.b1_config(), 16, 2)
    with pytest.raises(RuntimeError):
        ops.resolve_device("cuda")
    assert ops.resolve_device("cpu") == torch.device("cpu")


def test_optional_groups_arity_and_invalid_combinations():
    _, tv, _, tcfg, _, tst = _setup("B2", 2)
    args = (tv.labels.reshape(-1), tv.media, tst, SHAPE, 1.0, tcfg, 1)
    n_media = tv.media.shape[0]
    det = dict(ppath=torch.zeros(N, n_media),
               det_geom=TD.det_geometry(TD.as_detectors(DETS)))
    jac = dict(jac_w=torch.ones(N), jac_col=torch.zeros(N, dtype=torch.int32),
               jac_cols=2)
    for n_det in (0, 2):
        for record in ((False, True) if n_det else (False,)):
            for jac_cols in (0, 2):
                for stats in (False, True):
                    kw = dict(record=record, stats=stats)
                    kw.update(det if n_det else {})
                    kw.update(jac if jac_cols else {})
                    outs = ops.photon_steps(*args, **kw)
                    assert len(outs) == tspec.output_arity(
                        n_det, record, jac_cols, stats)
                    if stats:  # always last
                        assert outs[-1].shape == (N, 2)
                    if jac_cols:
                        assert outs[-1 - stats].shape == (
                            np.prod(SHAPE) * jac_cols,)
    for kw in ({"ppath": torch.zeros(N, n_media)},
               {"det_geom": det["det_geom"]},
               {"record": True},
               {"jac_w": torch.ones(N), "jac_col": jac["jac_col"]},
               {"jac_cols": 2},
               {"jac_w": torch.ones(N), "jac_cols": 2},
               {"jac_col": jac["jac_col"], "jac_cols": 2}):
        with pytest.raises(ValueError):
            ops.photon_steps(*args, **kw)
        with pytest.raises(ValueError):
            tkernel.photon_step_cuda(*args, **kw)


def test_simulate_kernel_matches_reference_ops():
    from repro.kernels.photon_step import ops as jops
    jv = JV.benchmark_b1((12, 12, 12))
    tv = TV.benchmark_b1((12, 12, 12))
    src = {"type": "pencil", "pos": [6.0, 6.0, 0.0]}
    id_offset = 2**32 - 40
    ref = jops.simulate_kernel(jv, JV.b1_config(), 128, 3, seed=9,
                               source=src, interpret=True,
                               id_offset=id_offset, block_lanes=128)
    got = ops.simulate_kernel(tv, TV.b1_config(), 128, 3, seed=9,
                              source=src, device="cpu", id_offset=id_offset)
    np.testing.assert_array_equal(tph.state_to_numpy(got[0])["rng"],
                                  np.asarray(ref[0].rng))


def test_launch_counter_and_build_key_are_static():
    # the counts are plain integers on the wrapper, by variant; the
    # library name is keyed by the kernel source and the nvcc flags
    tkernel.reset_launches()
    assert sum(tkernel.photon_step_cuda.launches_by.values()) == 0
    cfg = TV.b2_config()
    groups = tkernel.group_mask(n_det=3, record=True, stats=True)
    assert tkernel.variant_name(groups, cfg) == "reflect/exact/det+record+stats"
    path = tkernel.library_path()
    assert path.parent == tkernel.BUILD_DIR and path.suffix == ".so"
    assert "--fmad=false" in tkernel.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in tkernel.NVCC_FLAGS


@pytest.mark.parametrize("groups", [
    {}, {"record": True, "stats": True, "jac": True}])
def test_plain_version_stops_once_every_lane_is_dead(groups):
    """Once every lane is dead the plain version leaves its loop and
    moves each lane's RNG words past the remaining segments' 5 draws at
    once (``rng.skip``), as the kernel's dead warps draw them: the same
    outputs, bit for bit, as stepping every segment with
    ``photon.step``, dead-lane RNG words included."""
    tv = TV.benchmark_b2((10, 10, 10))
    cfg = dataclasses.replace(TV.b2_config(), n_time_gates=2, tmax_ns=0.2)
    n, n_steps = 64, 400
    st0 = ops.fresh_state(tv, n, seed=4, source={
        "type": "pencil", "pos": [5.0, 5.0, 0.0]})
    # lanes dead at launch among live ones
    st0 = st0._replace(alive=st0.alive & (torch.arange(n) % 5 != 0))
    kw = {}
    if groups:
        kw = dict(ppath=torch.zeros(n, tv.media.shape[0]),
                  det_geom=TD.det_geometry(TD.as_detectors(
                      [{"x": 6.0, "y": 5.0, "radius": 2.0}])),
                  record=True, stats=True, jac_w=torch.rand(
                      n, generator=torch.Generator().manual_seed(2)),
                  jac_col=torch.zeros(n, dtype=torch.int32), jac_cols=1)
    got = tref.photon_steps_ref(tv.labels.reshape(-1), tv.media, st0,
                                tv.shape, 1.0, cfg, n_steps, **kw)
    st, steps_alive = st0, 0
    for _ in range(n_steps):
        steps_alive += bool(st.alive.any())
        st = tph.step(st, tv.labels.reshape(-1), tv.media, tv.shape, 1.0,
                      cfg).state
    assert 0 < steps_alive < n_steps // 2  # the loop did stop early
    for name, x, y in zip(st._fields, got[0], st):
        assert torch.equal(x, y), name
    if groups:
        # against the same call cut to the segments any lane lived
        short = tref.photon_steps_ref(tv.labels.reshape(-1), tv.media, st0,
                                      tv.shape, 1.0, cfg, steps_alive, **kw)
        for i, (x, y) in enumerate(zip(got[1:], short[1:])):
            assert torch.equal(x, y), i
        assert int(got[10].sum()) > 0 and int((got[8] >= 0).sum()) > 0


def test_plain_version_split_launches_add_into_totals():
    """The replay's launches add into totals zeroed once a replay: K
    segments as launches of 3 and K - 3 adding into the same int64
    totals give one launch's fluence, exitance, TPSF, path sums and
    Jacobian bit for bit, and its lane state, paths and escaped weight."""
    _, tv, _, tcfg, _, tst = _setup("B2", 4)
    t, _, tj, _ = _group_args(None, tv.media.shape[0])
    args = (tv.labels.reshape(-1), tv.media)
    one = tref.photon_steps_ref(*args, tst, SHAPE, 1.0, tcfg, K, **t, **tj)
    grids = (1, 2, 6, 7, 8)  # fluence, exitance, TPSF, path sums, jac
    totals = [torch.zeros_like(one[i]) for i in grids]
    first = tref.photon_steps_ref(*args, tst, SHAPE, 1.0, tcfg, 3, **t,
                                  **tj, totals=totals)
    second = tref.photon_steps_ref(*args, first[0], SHAPE, 1.0, tcfg, K - 3,
                                   **dict(t, ppath=first[5]), **tj,
                                   totals=totals)
    for x, y in zip(second[0], one[0]):
        assert torch.equal(x, y)
    assert torch.equal(second[5], one[5])
    assert torch.equal(first[3] + second[3], one[3])
    for i, total in zip(grids, totals):
        assert second[i] is total and torch.equal(total, one[i]), i
        assert int(total.sum()) > 0, i
