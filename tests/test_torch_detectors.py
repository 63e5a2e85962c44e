"""The port's detectors module against ``repro.detectors``.

Every function gets the same arrays, made with numpy from a seed.  The
capture test ``dx*dx + dy*dy <= r^2`` is strict IEEE float32 in the port
and may be FMA-contracted in XLA's CPU code, which can decide a point
within a few ulp of a disk edge differently.  So detector indices and
credited weights are held equal on every lane whose squared distance is
more than 1e-3 voxel^2 from every r^2, and on >= 99.9% of all lanes, edge
points included (measured over seeds 1-4: all 4000 lanes agree, the ~200
edge points among them).  The sums of
``accumulate_capture`` (float32 scatter-adds in another order) are held
to 1e-6 relative; per-lane paths and capture records are equal.  Into
int64 grids it adds the same deposits in fixed point, each rounded once,
so those sums are within half a unit a deposit of the float ones.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import detectors as JD  # noqa: E402
from repro_torch import detectors as TD  # noqa: E402
from repro_torch.core.fixed import from_fixed  # noqa: E402
from repro_torch.kernels.photon_step.spec import FIXED_SHIFT  # noqa: E402

SPEC = [{"x": 10.0, "y": 10.0, "radius": 3.0},
        {"x": 12.5, "y": 9.0, "radius": 2.0},   # overlaps detector 0
        {"x": 4.0, "y": 15.0, "radius": 1.5}]
N = 4000


def _escapes(seed):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0, 20, N), rng.uniform(0, 20, N),
                    rng.choice([0.0, 0.1, 0.3, 5.0], N)], 1).astype(np.float32)
    # a share of the lanes exactly on or next to a disk edge
    edge = rng.random(N) < 0.05
    ang = rng.uniform(0, 2 * np.pi, N)
    pos[edge, 0] = (10.0 + 3.0 * np.cos(ang[edge])).astype(np.float32)
    pos[edge, 1] = (10.0 + 3.0 * np.sin(ang[edge])).astype(np.float32)
    w = np.where(rng.random(N) < 0.2, 0.0, rng.uniform(0.1, 1.0, N))
    return pos, w.astype(np.float32)


def _away_from_edges(pos, geom):
    d2 = ((pos[:, None, 0] - geom[None, :, 0]) ** 2
          + (pos[:, None, 1] - geom[None, :, 1]) ** 2)
    return (np.abs(d2 - geom[None, :, 2]) > 1e-3).all(axis=1)


def test_detector_specs_and_geometry_match_reference():
    jd, td = JD.as_detectors(SPEC), TD.as_detectors(SPEC)
    assert TD.to_dicts(td) == JD.to_dicts(jd) == SPEC
    assert TD.as_detectors(None) == ()
    assert TD.as_detectors([(1, 2, 3)]) == (TD.Detector(1.0, 2.0, 3.0),)
    assert TD.as_detectors(td) == td
    np.testing.assert_array_equal(TD.det_geometry(td).numpy(),
                                  np.asarray(JD.det_geometry(jd)))
    assert TD.det_geometry(td).dtype == torch.float32
    assert TD.det_geometry(()).shape == (0, 3)
    with pytest.raises(ValueError):
        TD.Detector(1.0, 1.0, 0.0)
    shape = (20, 20, 20)
    TD.validate_detectors(td, shape)
    for bad in ([(-5.0, 10.0, 2.0)], [(10.0, 25.0, 5.0)], [(-2.0, -2.0, 2.0)]):
        with pytest.raises(ValueError):
            JD.validate_detectors(JD.as_detectors(bad), shape)
        with pytest.raises(ValueError, match="outside the z=0 face"):
            TD.validate_detectors(TD.as_detectors(bad), shape)


@pytest.mark.parametrize("seed", [1, 2])
def test_detector_bins_first_match_as_reference(seed):
    pos, w = _escapes(seed)
    geom = TD.det_geometry(TD.as_detectors(SPEC))
    ti, tw = TD.detector_bins(torch.tensor(pos), torch.tensor(w), geom)
    ji, jw = JD.detector_bins(jnp.asarray(pos), jnp.asarray(w),
                              JD.det_geometry(JD.as_detectors(SPEC)))
    ti, tw, ji, jw = ti.numpy(), tw.numpy(), np.asarray(ji), np.asarray(jw)
    away = _away_from_edges(pos, geom.numpy())
    assert (~away).sum() > 50 and (tw > 0).sum() > 100
    np.testing.assert_array_equal(ti[away], ji[away])
    np.testing.assert_array_equal(tw[away], jw[away])
    assert ((ti == ji) & (tw == jw)).mean() >= 0.999
    # first match: a point inside disks 0 and 1 goes to 0
    both = torch.tensor([[11.5, 9.5, 0.0]])
    idx, wt = TD.detector_bins(both, torch.tensor([0.5]), geom)
    assert int(idx[0]) == 0 and float(wt[0]) == 0.5
    # above the z=0 face, or with no weight, nothing is credited
    for p, ww in (([10.0, 10.0, 0.3], 0.5), ([10.0, 10.0, 0.0], 0.0)):
        _, wt = TD.detector_bins(torch.tensor([p]), torch.tensor([ww]), geom)
        assert float(wt[0]) == 0.0


def _step_results(seed, n_media=3):
    """The fields of a StepResult the capture functions read, for both
    packages, from the same arrays."""
    pos, w = _escapes(seed)
    rng = np.random.default_rng(seed + 10)
    seg_med = rng.integers(0, n_media, N)
    seg_len = np.where(rng.random(N) < 0.1, 0.0,
                       rng.uniform(0, 2, N)).astype(np.float32)
    gate = rng.integers(0, 4, N)
    pp = rng.uniform(0, 30, (N, n_media)).astype(np.float32)
    t = types.SimpleNamespace(
        esc_pos=torch.tensor(pos), esc_w=torch.tensor(w),
        seg_med=torch.tensor(seg_med), seg_len=torch.tensor(seg_len))
    j = types.SimpleNamespace(
        esc_pos=jnp.asarray(pos), esc_w=jnp.asarray(w),
        seg_med=jnp.asarray(seg_med, jnp.int32), seg_len=jnp.asarray(seg_len))
    return t, j, gate, pp, _away_from_edges(
        pos, TD.det_geometry(TD.as_detectors(SPEC)).numpy())


def test_accumulate_and_update_capture_match_reference():
    ntg, n_det, n_media = 4, len(SPEC), 3
    t, j, gate, pp, away = _step_results(3, n_media)
    tgeom = TD.det_geometry(TD.as_detectors(SPEC))
    jgeom = JD.det_geometry(JD.as_detectors(SPEC))
    tpp, tdw, tdp = TD.accumulate_capture(
        torch.tensor(pp), torch.zeros(n_det * ntg),
        torch.zeros(n_det, n_media),
        t, torch.tensor(gate), tgeom, ntg)
    jpp, jdw, jdp = JD.accumulate_capture(
        jnp.asarray(pp), jnp.zeros(n_det * ntg), jnp.zeros((n_det, n_media)),
        j, jnp.asarray(gate, jnp.int32), jgeom, ntg)
    # the path is added before the capture test, column by medium
    np.testing.assert_array_equal(tpp.numpy(), np.asarray(jpp))
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), rtol=1e-6)
    np.testing.assert_allclose(tdp.numpy(), np.asarray(jdp), rtol=1e-6)
    assert float(tdw.sum()) > 0
    # int64 grids take the same deposits in fixed point, in place: within
    # half a unit a deposit of the float sums
    fdw = torch.zeros(n_det * ntg, dtype=torch.int64)
    fdp = torch.zeros(n_det, n_media, dtype=torch.int64)
    fpp, fdw2, fdp2 = TD.accumulate_capture(
        torch.tensor(pp), fdw, fdp, t, torch.tensor(gate), tgeom, ntg)
    assert fdw2 is fdw and fdp2 is fdp and torch.equal(fpp, tpp)
    for fixed, flt, name in ((fdw, tdw, "det_w"), (fdp, tdp, "det_ppath")):
        shift = FIXED_SHIFT[name]
        err = (from_fixed(fixed, shift).double() - flt.double()).abs().max()
        assert float(err) <= N * 2.0**-shift + 1e-6 * float(flt.abs().max())
    capd0 = torch.full((N,), -1, dtype=torch.int32)
    capg0 = torch.zeros(N, dtype=torch.int32)
    tcd, tcg = TD.update_capture(capd0, capg0, t, torch.tensor(gate), tgeom)
    jcd, jcg = JD.update_capture(jnp.full((N,), -1, jnp.int32),
                                 jnp.zeros((N,), jnp.int32), j,
                                 jnp.asarray(gate, jnp.int32), jgeom)
    assert tcd.dtype == torch.int32 and tcg.dtype == torch.int32
    np.testing.assert_array_equal(tcd.numpy()[away], np.asarray(jcd)[away])
    np.testing.assert_array_equal(tcg.numpy()[away], np.asarray(jcg)[away])
    assert (tcd.numpy() >= 0).sum() > 100
    # a lane that captures nothing keeps what it had
    keep = torch.full((N,), 7, dtype=torch.int32)
    tcd2, _ = TD.update_capture(keep, capg0, t, torch.tensor(gate), tgeom)
    missed = tcd.numpy() < 0
    assert (tcd2.numpy()[missed] == 7).all()
