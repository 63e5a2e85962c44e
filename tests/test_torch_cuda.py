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
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import analysis as A  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402
from repro_torch.kernels.photon_step import ops  # noqa: E402
from repro_torch.kernels.photon_step import photon_step as kernel  # noqa: E402
from repro_torch.kernels.photon_step.ref import photon_steps_ref  # noqa: E402

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
    before = kernel.photon_step_cuda.launches
    got = kernel.photon_step_cuda(*args)
    torch.cuda.synchronize()
    assert kernel.photon_step_cuda.launches == before + 1
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
