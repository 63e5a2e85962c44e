"""One transport step of the port against repro.core.photon.step.

Both packages start from the same photon state (random-walked lanes
plus hand-placed lanes on voxel walls, with zero direction components,
near the pole, at low weight, near the time gate, dead) and take one
step, for B1 and B2 x specialize x deposit_mode.

Tolerances: the integer results (rng, ivox, alive, deposit index) are
exact.  Floats agree to rtol 1e-5, atol 1e-6: the port evaluates every
operation in IEEE float32 like the CUDA kernel, while XLA's CPU backend
contracts multiply-adds into FMAs, and the library log/exp/sin/cos
differ by an ulp or two.  The direction is the exception: at B1's
g = 0.01 the Henyey-Greenstein cosine (1 + g^2 - frac^2) / (2 g) loses
two digits to cancellation and sqrt(1 - cos^2) amplifies that near
cos = +-1, so one FMA-vs-IEEE rounding of frac moves a direction
component by up to ~1e-3 (8.5e-4 measured over 1e5 random lanes on the
CPU); dir is held to atol 2e-3.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import sources as JS  # noqa: E402
from repro.core import photon as jph  # noqa: E402
from repro.core import volume as JV  # noqa: E402
from repro_torch.core import photon as tph  # noqa: E402
from repro_torch.core import volume as TV  # noqa: E402

SHAPE = (20, 20, 20)
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
DIR_TOL = dict(rtol=1e-5, atol=2e-3)


def _volumes(bench):
    jv = JV.benchmark_b2(SHAPE) if bench == "B2" else JV.benchmark_b1(SHAPE)
    tv = TV.volume_from_arrays(np.asarray(jv.labels), np.asarray(jv.media))
    return jv, tv


def _unit(v):
    v = np.asarray(v, np.float64)
    return (v / np.linalg.norm(v)).astype(np.float32)


def _hand_placed(rng_words):
    """Lanes on walls, axis-aligned, near the pole, low weight, near
    tmax, on the sphere and domain boundaries, and dead."""
    rows = [
        # pos, dir, ivox, w, s_left, t, alive
        ((5.0, 6.0, 7.0), (1, 0, 0), (5, 6, 7), 1.0, 0.0, 0.1, True),
        ((5.0, 6.0, 7.0), (-1, 0, 0), (5, 6, 7), 1.0, 0.3, 0.1, True),
        ((5.0, 6.5, 7.5), (-0.6, 0.8, 0), (4, 6, 7), 0.7, 2.0, 0.2, True),
        ((3.5, 3.5, 3.5), (0, 0, 1), (3, 3, 3), 1.0, 0.0, 0.0, True),
        ((3.5, 3.5, 3.5), (0, -1, 0), (3, 3, 3), 1.0, 5.0, 0.0, True),
        ((8.2, 9.1, 2.3), (1e-3, 0, 1), (8, 9, 2), 0.9, 0.0, 0.5, True),
        ((8.2, 9.1, 2.3), (0, 2e-3, -1), (8, 9, 2), 0.9, 0.0, 0.5, True),
        ((10.5, 10.5, 4.999), (0, 0, 1), (10, 10, 4), 1.0, 40.0, 0.3, True),
        ((10.5, 10.5, 15.001), (0, 0, -1), (10, 10, 15), 1.0, 40.0, 0.3,
         True),
        ((12.3, 4.4, 6.6), (0.3, 0.4, -0.866), (12, 4, 6), 5e-5, 0.0, 1.0,
         True),
        ((12.3, 4.4, 6.6), (0.3, 0.4, 0.866), (12, 4, 6), 9e-5, 0.0, 1.0,
         True),
        ((7.7, 7.7, 7.7), (0.5, 0.5, 0.7071), (7, 7, 7), 0.8, 0.0, 4.9999,
         True),
        ((0.2, 11.0, 11.0), (-1, 0, 0), (0, 11, 11), 0.6, 30.0, 0.4, True),
        ((10.0, 10.0, 0.0), (0, 0, -1), (10, 10, 0), 0.6, 30.0, 0.4, True),
        ((1.0, 2.0, 3.0), (0, 0, 1), (1, 2, 3), 0.0, 0.0, 0.0, False),
    ]
    n = len(rows)
    return dict(
        pos=np.array([r[0] for r in rows], np.float32),
        dir=np.stack([_unit(r[1]) for r in rows]),
        ivox=np.array([r[2] for r in rows], np.int32),
        w=np.array([r[3] for r in rows], np.float32),
        s_left=np.array([r[4] for r in rows], np.float32),
        t=np.array([r[5] for r in rows], np.float32),
        rng=rng_words[:n],
        alive=np.array([r[6] for r in rows], bool),
    )


@pytest.fixture(scope="module")
def start_states():
    """Per benchmark: 256 pencil lanes random-walked 25 steps by the
    reference, plus the hand-placed lanes."""
    out = {}
    for bench in ("B1", "B2"):
        jv, _ = _volumes(bench)
        cfg = JV.SimConfig(do_reflect=bench == "B2")
        ids = jnp.arange(256, dtype=jnp.uint32)
        pos, d, w0, rng = JS.Pencil(pos=(10.0, 10.0, 0.0)).sample(
            ids, jnp.uint32(17))
        st = jph.launch(pos, d, w0, rng, jnp.ones((256,), bool), SHAPE)
        labels = jv.labels.reshape(-1)
        stepf = jax.jit(lambda s: jph.step(s, labels, jv.media, SHAPE, 1.0,
                                           cfg).state)
        for _ in range(25):
            st = stepf(st)
        walked = {k: np.asarray(v) for k, v in st._asdict().items()}
        extra_rng = np.asarray(
            JS.flight_stream(jnp.uint32(3), jnp.arange(32, dtype=jnp.uint32)))
        hand = _hand_placed(extra_rng)
        out[bench] = {k: np.concatenate([walked[k], hand[k]]) for k in walked}
    return out


def _jax_state(a):
    return jph.PhotonState(**{k: jnp.asarray(v) for k, v in a.items()})


@pytest.mark.parametrize("deposit_mode", ["exact", "taylor"])
@pytest.mark.parametrize("specialize", [True, False])
@pytest.mark.parametrize("bench", ["B1", "B2"])
def test_one_step_matches_reference(start_states, bench, specialize,
                                    deposit_mode):
    jv, tv = _volumes(bench)
    cfg = JV.SimConfig(do_reflect=bench == "B2", specialize=specialize,
                       deposit_mode=deposit_mode)
    tcfg = TV.SimConfig(**dataclasses.asdict(cfg))
    a = start_states[bench]
    labels = jv.labels.reshape(-1)
    ref = jax.jit(lambda s: jph.step(s, labels, jv.media, SHAPE, 1.0,
                                     cfg))(_jax_state(a))
    got = tph.step(tph.state_from_arrays(**{
        ("direc" if k == "dir" else k): v for k, v in a.items()}),
        tv.labels.reshape(-1), tv.media, SHAPE, 1.0, tcfg)

    ref_state = {k: np.asarray(v) for k, v in ref.state._asdict().items()}
    got_state = tph.state_to_numpy(got.state)
    for k in ("rng", "ivox", "alive"):
        np.testing.assert_array_equal(got_state[k], ref_state[k], err_msg=k)
    for k in ("pos", "w", "s_left", "t"):
        np.testing.assert_allclose(got_state[k], ref_state[k], **FLOAT_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(got_state["dir"], ref_state["dir"], **DIR_TOL)
    np.testing.assert_array_equal(got.dep_idx.numpy(), np.asarray(ref.dep_idx))
    np.testing.assert_array_equal(got.seg_med.numpy(), np.asarray(ref.seg_med))
    for k in ("dep_w", "esc_w", "esc_pos", "dep_t", "seg_len", "timed_w"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), **FLOAT_TOL,
                                   err_msg=k)


def test_hand_placed_lanes_cover_the_branches(start_states):
    """The B1 hand-placed lanes reach roulette, the time gate, escapes
    and pole scattering, so the parity test above exercises them."""
    jv, _ = _volumes("B1")
    cfg = JV.SimConfig()
    a = {k: v[-15:] for k, v in start_states["B1"].items()}
    res = jph.step(_jax_state(a), jv.labels.reshape(-1), jv.media, SHAPE,
                   1.0, cfg)
    assert float(res.timed_w[11]) > 0          # killed by the tmax gate
    assert float(res.esc_w[12]) > 0            # escapes through x = 0
    assert float(res.esc_w[13]) > 0            # escapes through z = 0
    low = np.asarray(res.state.w)[9:11]
    assert np.all((low == 0) | (low > 1e-4))   # roulette decided both


def test_exitance_and_gate_bins_match():
    r = np.random.default_rng(3)
    esc_pos = r.uniform(-0.5, 20.5, size=(500, 3)).astype(np.float32)
    esc_pos[:200, 2] = r.uniform(0, 0.3, 200)
    esc_w = np.where(r.random(500) < 0.5, r.random(500), 0).astype(np.float32)
    ji, jw = jph.exitance_bins(jnp.asarray(esc_pos), jnp.asarray(esc_w),
                               SHAPE)
    ti, tw = tph.exitance_bins(torch.as_tensor(esc_pos),
                               torch.as_tensor(esc_w), SHAPE)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    dep_t = r.uniform(0, 6, 1000).astype(np.float32)
    for ntg, tmax in ((1, 5.0), (4, 5.0), (7, 3.3)):
        np.testing.assert_array_equal(
            tph.time_gate_bins(torch.as_tensor(dep_t), tmax, ntg).numpy(),
            np.asarray(jph.time_gate_bins(jnp.asarray(dep_t), tmax, ntg)))


def test_state_round_trip():
    a = {
        "pos": np.ones((4, 3), np.float32), "direc": np.zeros((4, 3)),
        "ivox": np.arange(12).reshape(4, 3), "w": np.ones(4),
        "s_left": np.zeros(4), "t": np.zeros(4),
        "rng": np.array([[2**32 - 1, 0, 1, 2**31]] * 4, np.uint32),
        "alive": np.array([True, False, True, False]),
    }
    st = tph.state_from_arrays(**a)
    assert st.rng.dtype == torch.int64 and st.alive.dtype == torch.bool
    back = tph.state_to_numpy(st)
    np.testing.assert_array_equal(back["rng"], a["rng"])
    np.testing.assert_array_equal(back["ivox"], a["ivox"])
