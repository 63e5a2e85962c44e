"""The host (CPU) photon-step kernel against the plain version.

``photon_step_cpu.photon_step_host`` (``csrc/photon_step_cpu.cpp``,
built with ``g++`` at first use) is what CPU tensors run.  It is held
against ``ref.photon_steps_ref`` on the same inputs: photon states made
from a numpy seed (positions anywhere in the volume, random directions,
scattering lengths left and not, weights, times, RNG words, a tenth of
the lanes dead), on volumes of at most 24^3 voxels and at most 4096
lanes.

Tolerance: none.  The kernel computes each lane's float32 arithmetic in
the plain version's order, its log, exp, sin, cos and sqrt by the
functions PyTorch's CPU operators call (MKL's VML, or at::vec without
MKL), and its grids in int64 fixed point with integer atomics, so every
output (the RNG words, ``ivox``, ``alive``, every float state field,
every per-lane output and every int64 grid) is bit-equal to the plain
version's, and the same at any thread count.

``simulate(device="cpu")``, which runs the host kernel, is also held
against the JAX package at ``tests/test_torch_simulator.py``'s
tolerance, and the plain version's own JAX parity by a direct call (the
dispatcher no longer reaches it).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import analysis as JA  # noqa: E402
from repro.core import simulator as JS  # noqa: E402
from repro.core import volume as JV  # noqa: E402
from repro.kernels.photon_step import ref as jref  # noqa: E402
from repro_torch import detectors as TD  # noqa: E402
from repro_torch.core import analysis as TA  # noqa: E402
from repro_torch.core import photon as tph  # noqa: E402
from repro_torch.core import simulator as TS  # noqa: E402
from repro_torch.core import volume as TV  # noqa: E402
from repro_torch.kernels.photon_step import ops  # noqa: E402
from repro_torch.kernels.photon_step import photon_step as K  # noqa: E402
from repro_torch.kernels.photon_step import photon_step_cpu as H  # noqa: E402
from repro_torch.kernels.photon_step import ref as tref  # noqa: E402

SHAPE = (24, 20, 16)
N = 1024
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the optional groups of each valid output-group mask
GROUPS = {
    "base": {}, "det": {"det": True}, "det+record": {"det": True,
                                                     "record": True},
    "jac": {"jac": True}, "stats": {"stats": True},
    "det+record+jac+stats": {"det": True, "record": True, "jac": True,
                             "stats": True},
}


def _state(vol, n, seed, dead=0.1):
    """A photon state made from a numpy seed: anywhere in the volume,
    any direction, some lanes mid-flight (a scattering length left, a
    lower weight, a time) and some dead."""
    rng = np.random.default_rng(seed)
    shape = np.asarray(vol.shape, np.float32)
    pos = (rng.uniform(0.02, 0.98, (n, 3)) * shape).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # a few lanes along an axis or near the pole
    d[::17] = [0.0, 0.0, 1.0]
    d[5::23] = [0.0, -1.0, 0.0]
    ivox = np.floor(pos).astype(np.int32)
    w = rng.uniform(0.05, 1.0, n).astype(np.float32)
    s_left = np.where(rng.uniform(size=n) < 0.5, 0.0,
                      rng.exponential(1.0, n)).astype(np.float32)
    t = rng.uniform(0.0, 0.05, n).astype(np.float32)
    words = rng.integers(1, 2**32, (n, 4), dtype=np.uint64).astype(np.uint32)
    alive = rng.uniform(size=n) >= dead
    return tph.state_from_arrays(pos, d, ivox, w, s_left, t, words, alive)


def _vol(bench, shape=SHAPE):
    return TV.benchmark_b2(shape) if bench == "B2" else TV.benchmark_b1(shape)


def _cfg(bench, **kw):
    base = TV.b2_config() if bench == "B2" else TV.b1_config()
    return dataclasses.replace(base, **{"n_time_gates": 3, "tmax_ns": 0.3,
                                        **kw})


def _group_kwargs(groups, n, n_media, shape, seed=0):
    rng = np.random.default_rng(seed + 100)
    kw = {}
    if groups.get("det"):
        kw["ppath"] = torch.tensor(rng.uniform(0, 2, (n, n_media)),
                                   dtype=torch.float32)
        cx, cy = shape[0] / 2, shape[1] / 2
        kw["det_geom"] = TD.det_geometry(TD.as_detectors(
            [(cx, cy, 4.0), (cx + 5, cy, 3.0), (cx - 6, cy - 3, 5.0)]))
    if groups.get("record"):
        kw["record"] = True
    if groups.get("jac"):
        kw["jac_w"] = torch.tensor(rng.uniform(0, 1, n), dtype=torch.float32)
        kw["jac_col"] = torch.tensor(rng.integers(0, 3, n), dtype=torch.int32)
        kw["jac_cols"] = 3
    if groups.get("stats"):
        kw["stats"] = True
    return kw


def _assert_equal(got, want):
    """Every output bit-equal: the state field by field, then each
    output of each group."""
    assert len(got) == len(want)
    for name, a, b in zip(tph.PhotonState._fields, got[0], want[0]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    for i, (a, b) in enumerate(zip(got[1:], want[1:]), 1):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a, b), i


def _args(bench, n_steps, n=N, seed=1, **cfg_kw):
    vol = _vol(bench)
    st = _state(vol, n, seed)
    return (vol.labels.reshape(-1), vol.media, st, vol.shape,
            vol.unitinmm, _cfg(bench, **cfg_kw), n_steps)


@pytest.mark.parametrize("n_steps", [1, 40])
@pytest.mark.parametrize("groups", list(GROUPS))
@pytest.mark.parametrize("bench", ["B1", "B2"])
def test_every_group_is_bit_equal_to_the_plain_version(bench, groups,
                                                       n_steps):
    args = _args(bench, n_steps)
    kw = _group_kwargs(GROUPS[groups], N, args[1].shape[0], SHAPE)
    K.reset_launches()
    got = H.photon_step_host(*args, **kw)
    assert dict(K.photon_step_cuda.launches_by) == {
        H.host_key(K.group_mask(len(kw.get("det_geom", ())),
                                kw.get("record", False),
                                kw.get("jac_cols", 0),
                                kw.get("stats", False)), args[5]): 1}
    _assert_equal(got, tref.photon_steps_ref(*args, **kw))
    # something happened: lanes moved and weight was deposited
    assert not torch.equal(got[0].pos, args[2].pos)
    assert int(got[1].sum()) > 0


@pytest.mark.parametrize("cfg_kw", [{"deposit_mode": "taylor"},
                                    {"specialize": False},
                                    {"do_reflect": False},
                                    {"n_time_gates": 1, "tmax_ns": 5.0}])
def test_physics_variants_are_bit_equal(cfg_kw):
    args = _args("B2", 40, seed=2, **cfg_kw)
    kw = _group_kwargs(GROUPS["det+record+jac+stats"], N, 3, SHAPE)
    _assert_equal(H.photon_step_host(*args, **kw),
                  tref.photon_steps_ref(*args, **kw))


def test_long_launch_and_dead_lanes_rng():
    """Lanes that die early, and lanes dead at launch, leave their RNG
    words past every remaining segment's 5 draws (the jump past 64
    draws), as the plain version's ``rng.skip`` does; an empty launch
    and a launch of 0 segments return the state as it was."""
    args = list(_args("B1", 300, n=512, seed=3))
    args[2] = args[2]._replace(alive=args[2].alive & (torch.arange(512) % 3
                                                      != 0))
    got = H.photon_step_host(*args)
    _assert_equal(got, tref.photon_steps_ref(*args))
    assert not bool(got[0].alive.any())
    args[6] = 0
    _assert_equal(H.photon_step_host(*args), tref.photon_steps_ref(*args))
    empty = tph.PhotonState(*[x[:0] for x in args[2]])
    args[2], args[6] = empty, 4
    out = H.photon_step_host(*args)
    assert out[0].w.shape == (0,) and int(out[1].abs().sum()) == 0


def test_batched_scenarios_equal_each_scenario_alone():
    """S = 3 scenarios in one launch (scenario-major lanes, a leading
    scenario axis on every grid, stacked labels) equal the plain
    version's batched call and each scenario's own launch."""
    S, n = 3, 512
    vol = _vol("B2")
    media = []
    for s in range(S):
        m = vol.media.clone()
        m[1:, 0] *= 1.0 + s
        m[1:, 3] = 1.37 + 0.1 * s
        media.append(m)
    labels = [vol.labels.reshape(-1)] * S
    states = [_state(vol, n, 10 + s) for s in range(S)]
    cfg = _cfg("B2")
    kw = [_group_kwargs(GROUPS["det+record+jac+stats"], n, 3, SHAPE, s)
          for s in range(S)]
    batched_kw = {k: (torch.stack([x[k] for x in kw]) if k == "det_geom"
                      else torch.cat([x[k] for x in kw])
                      if isinstance(kw[0][k], torch.Tensor) else kw[0][k])
                  for k in kw[0]}
    args = (torch.stack(labels), torch.stack(media),
            tph.PhotonState(*[torch.cat(x) for x in zip(*states)]), SHAPE,
            1.0, cfg, 40)
    K.reset_launches()
    got = H.photon_step_host(*args, **batched_kw)
    assert K.photon_step_cuda.launches_by == {
        "host/reflect/exact/det+record+jac+stats/x3": 1}
    _assert_equal(got, tref.photon_steps_ref(*args, **batched_kw))
    lanes = (3, 4, 5, 8, 9, 11)      # per-lane outputs of every group
    grids = (1, 2, 6, 7, 10)         # grids with a leading scenario axis
    for s in range(S):
        one = H.photon_step_host(labels[s], media[s], states[s], SHAPE, 1.0,
                                 cfg, 40, **kw[s])
        for a, b in zip(one[0], got[0]):
            assert torch.equal(a, b[s * n:(s + 1) * n])
        for i in lanes:
            assert torch.equal(one[i], got[i][s * n:(s + 1) * n]), i
        for i in grids:
            assert torch.equal(one[i], got[i][s]), i


def test_totals_are_added_into():
    args = _args("B2", 40, seed=4)
    kw = _group_kwargs(GROUPS["det+record+jac+stats"], N, 3, SHAPE)
    first = H.photon_step_host(*args, **kw)
    grids = [first[i] for i in (1, 2, 6, 7, 10)]
    totals = [g.clone() for g in grids]
    second = H.photon_step_host(*args, **kw, totals=totals)
    for g, t, out in zip(grids, totals, (second[i] for i in (1, 2, 6, 7,
                                                             10))):
        assert out is t
        assert torch.equal(t, 2 * g)
    want = tref.photon_steps_ref(*args, **kw, totals=[g.clone()
                                                      for g in grids])
    _assert_equal(second, want)


def test_bits_do_not_depend_on_the_thread_count():
    args = _args("B1", 60, n=4096, seed=5)
    kw = _group_kwargs(GROUPS["det+record+jac+stats"], 4096, 2, SHAPE)
    saved = torch.get_num_threads()
    try:
        runs = {}
        for threads in (1, 4):
            torch.set_num_threads(threads)
            assert H.kernel_threads() == threads
            runs[threads] = H.photon_step_host(*args, **kw)
    finally:
        torch.set_num_threads(saved)
    _assert_equal(runs[1], runs[4])
    _assert_equal(runs[1], tref.photon_steps_ref(*args, **kw))


def test_the_comparison_catches_an_index_mutation():
    """A kernel that put a lane's deposits in the wrong voxel, or moved a
    lane to the wrong voxel, fails the comparison: the comparison is
    bit-exact, so a mutated index shows."""
    args = _args("B2", 40, seed=6)
    want = tref.photon_steps_ref(*args)
    got = list(H.photon_step_host(*args))
    _assert_equal(got, want)
    nx, ny, nz = SHAPE
    flu = got[1].view(nx, ny, nz, -1)
    for wrong in (flu.roll(1, dims=2), flu.flip(0)):
        bad = list(got)
        bad[1] = wrong.reshape(-1)
        with pytest.raises(AssertionError):
            _assert_equal(bad, want)
    lane = int(torch.nonzero(got[0].alive)[0])
    ivox = got[0].ivox.clone()
    ivox[lane, 2] += 1
    with pytest.raises(AssertionError):
        _assert_equal([got[0]._replace(ivox=ivox)] + got[1:], want)


def test_launch_errors_raise_at_once():
    """A ``jac_col`` out of range adds nothing for its lane and raises
    ``ValueError``; a deposit past the fixed-point range raises
    ``OverflowError``; the error word is cleared for the next launch."""
    args = _args("B2", 8, n=256, seed=7)
    kw = _group_kwargs(GROUPS["jac"], 256, 3, SHAPE)
    bad = kw["jac_col"].clone()
    bad[3] = 7
    with pytest.raises(ValueError, match="jac_col"):
        H.photon_step_host(*args, **{**kw, "jac_col": bad})
    H.photon_step_host(*args, **kw)  # nothing left flagged
    with pytest.raises(OverflowError):
        H.photon_step_host(*args, **{**kw, "jac_w": torch.full((256,),
                                                               1e6)})
    full = H.photon_step_host(*args, **kw)
    totals = [torch.zeros_like(full[1]), torch.zeros_like(full[2]),
              torch.full_like(full[-1], 2**63 - 1)]
    with pytest.raises(OverflowError):
        H.photon_step_host(*args, **kw, totals=totals)
    with pytest.raises(ValueError, match="CPU tensors"):
        H.photon_step_host(*args[:2], args[2]._replace(
            w=torch.empty(0, device="meta")), *args[3:])


def test_cpu_tensors_run_the_host_kernel_and_never_the_plain_version(
        monkeypatch):
    args = _args("B1", 4, n=256, seed=8)
    monkeypatch.setattr(tref, "photon_steps_ref",
                        lambda *a, **k: pytest.fail("ran the plain version"))
    K.reset_launches()
    ops.photon_steps(*args)
    assert K.photon_step_cuda.launches_by == {H.host_key(0, args[5]): 1}


def test_without_gxx_the_build_raises_and_nothing_runs(tmp_path):
    """With no ``g++`` on ``PATH`` (and an empty build directory) a CPU
    launch raises ``KernelError``; the plain version never runs in its
    place."""
    script = textwrap.dedent(f"""
        import pathlib, torch
        from repro_torch.core import volume as TV
        from repro_torch.kernels.photon_step import ops, ref
        from repro_torch.kernels.photon_step import photon_step as K
        from repro_torch.kernels.photon_step import photon_step_cpu as H
        H.BUILD_DIR = K.BUILD_DIR = pathlib.Path({str(tmp_path)!r})
        ref.photon_steps_ref = None  # a call would raise TypeError
        vol = TV.benchmark_b1((8, 8, 8))
        try:
            ops.simulate_kernel(vol, TV.b1_config(), 16, 2, device="cpu")
        except K.KernelError as e:
            assert "g++" in str(e), e
            assert sum(K.photon_step_cuda.launches_by.values()) == 0
            print("KernelError")
    """)
    env = dict(os.environ, PATH=str(tmp_path),
               PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "KernelError"


@pytest.mark.parametrize("bench,k", [("B1", 1), ("B2", 4)])
def test_simulate_on_the_cpu_matches_the_reference(bench, k):
    """``simulate(device="cpu")`` runs the host kernel (its launch count
    moves) and agrees with the JAX package at test_torch_simulator.py's
    tolerance: exact photon accounting, the absorbed / escaped /
    timed-out split within 2e-3 of the launched weight."""
    shape = (20, 20, 20)
    src = {"type": "pencil", "pos": [10.0, 10.0, 0.0]}
    jv = JV.benchmark_b2(shape) if bench == "B2" else JV.benchmark_b1(shape)
    cfg = dataclasses.replace(
        JV.b2_config() if bench == "B2" else JV.b1_config(),
        steps_per_round=k)
    tv = TV.volume_from_arrays(np.asarray(jv.labels), np.asarray(jv.media))
    ref = JS.simulate(jv, cfg, 2000, 256, 1, source=src)
    jax.block_until_ready(ref)
    K.reset_launches()
    got = TS.simulate(tv, TV.SimConfig(**dataclasses.asdict(cfg)), 2000,
                      256, 1, source=src, device="cpu")
    launches = K.photon_step_cuda.launches_by
    assert launches and all(key.startswith(H.HOST_PREFIX)
                            for key in launches)
    assert int(got.n_launched) == int(ref.n_launched) == 2000
    assert float(got.launched_w) == float(ref.launched_w)
    jb, tb = JA.energy_balance(ref), TA.energy_balance(got)
    for key in ("absorbed", "escaped", "timed_out"):
        assert abs(tb[key] - jb[key]) <= 2e-3 * jb["launched"], key
    assert abs(tb["residue_frac"]) < 1e-5


def test_the_plain_version_still_matches_the_reference():
    """The plain version's own JAX parity, by a direct call (the
    dispatcher sends CPU tensors to the host kernel): the JAX oracle on
    the same numpy-seeded state, at test_torch_photon_step.py's
    tolerance (RNG words bit-equal, alive and ivox on >= 99% of lanes,
    fluence and exitance totals within 1e-4 relative)."""
    import jax.numpy as jnp
    from repro.core import photon as jph

    jv = JV.benchmark_b2(SHAPE)
    cfg = dataclasses.replace(JV.b2_config(), n_time_gates=3, tmax_ns=0.3)
    tv = TV.volume_from_arrays(np.asarray(jv.labels), np.asarray(jv.media))
    st = _state(tv, N, 9)
    host = tph.state_to_numpy(st)
    jst = jph.PhotonState(
        pos=jnp.asarray(host["pos"]), dir=jnp.asarray(host["dir"]),
        ivox=jnp.asarray(host["ivox"]), w=jnp.asarray(host["w"]),
        s_left=jnp.asarray(host["s_left"]), t=jnp.asarray(host["t"]),
        rng=jnp.asarray(host["rng"]), alive=jnp.asarray(host["alive"]))
    want = jref.photon_steps_ref(jv.labels.reshape(-1), jv.media, jst, SHAPE,
                                 1.0, cfg, 8)
    got = tref.photon_steps_ref(tv.labels.reshape(-1), tv.media, st, SHAPE,
                                1.0, TV.SimConfig(**dataclasses.asdict(cfg)),
                                8)
    g = tph.state_to_numpy(got[0])
    np.testing.assert_array_equal(g["rng"], np.asarray(want[0].rng))
    assert (g["alive"] == np.asarray(want[0].alive)).mean() >= 0.99
    assert (g["ivox"] == np.asarray(want[0].ivox)).all(axis=1).mean() >= 0.99
    from repro_torch.core.fixed import from_fixed
    for i, name in ((1, "fluence"), (2, "exitance")):
        a = float(from_fixed(got[i], 36).double().sum())
        b = float(np.asarray(want[i], np.float64).sum())
        assert abs(a - b) <= 1e-4 * max(abs(b), 1e-6), (name, a, b)
