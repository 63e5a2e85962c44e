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
(sums over all lanes) agree to 1e-4 relative.
"""

import ast
import dataclasses
import pathlib
import types

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import sources as JS  # noqa: E402
from repro.core import photon as jph  # noqa: E402
from repro.core import volume as JV  # noqa: E402
from repro.kernels.photon_step import ref as jref  # noqa: E402
from repro.kernels.photon_step.photon_step import \
    photon_step_pallas  # noqa: E402
from repro_torch.core import photon as tph  # noqa: E402
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


def _compare(got, ref):
    st, flu, exi, esc, timed = got
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
    _, tv, _, tcfg, _, tst = _setup("B2", 1)
    args = (tv.labels.reshape(-1), tv.media, tst, SHAPE, 1.0, tcfg, K)
    a = ops.photon_steps(*args)
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
    monkeypatch.setattr(ops, "photon_steps_ref",
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


def test_optional_groups_raise_until_ported():
    _, tv, _, tcfg, _, tst = _setup("B1", 1)
    args = (tv.labels.reshape(-1), tv.media, tst, SHAPE, 1.0, tcfg, 1)
    for kw in ({"stats": True}, {"record": True}, {"jac_cols": 2},
               {"ppath": torch.zeros(N, 2), "det_geom": torch.zeros(1, 3)}):
        with pytest.raises(NotImplementedError):
            ops.photon_steps(*args, **kw)


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
    # the counter is a plain integer on the wrapper; the library name is
    # keyed by the kernel source and the nvcc flags
    assert isinstance(tkernel.photon_step_cuda.launches, int)
    path = tkernel.library_path()
    assert path.parent == tkernel.BUILD_DIR and path.suffix == ".so"
    assert "--fmad=false" in tkernel.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in tkernel.NVCC_FLAGS
