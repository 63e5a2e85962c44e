"""The port's simulator and CLI against repro.core.simulator.

Photon accounting is exact: the port launches the same photon ids with
the same RNG words, so ``n_launched`` and ``launched_w`` are equal.
Absorbed / escaped / timed-out weight are sums over trajectories that
are IEEE float32 in the port and FMA-contracted in XLA's CPU code (see
test_torch_photon.py); once a trajectory has diverged its outcome is an
independent draw, so the totals differ statistically.  Over seeds 1-4
at these sizes the largest difference measured was 8.8e-4 of the
launched weight, so the tolerance is 2e-3 of the launched weight (the
quantity the three totals partition).  The roulette residue of each
run must stay below 1e-5 of the launched weight.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import analysis as JA  # noqa: E402
from repro.core import simulator as JS  # noqa: E402
from repro.core import volume as JV  # noqa: E402
from repro_torch.core import analysis as TA  # noqa: E402
from repro_torch.core import simulator as TS  # noqa: E402
from repro_torch.core import volume as TV  # noqa: E402
from repro_torch.launch import simulate as tlaunch  # noqa: E402

SHAPE = (20, 20, 20)
SRC = {"type": "pencil", "pos": [10.0, 10.0, 0.0]}
TOTALS_TOL = 2e-3


@pytest.mark.parametrize("bench,mode,k", [("B1", "dynamic", 1),
                                          ("B2", "dynamic", 4),
                                          ("B2", "static", 4)])
def test_simulate_matches_reference(bench, mode, k):
    jv = JV.benchmark_b2(SHAPE) if bench == "B2" else JV.benchmark_b1(SHAPE)
    cfg = dataclasses.replace(
        JV.b2_config() if bench == "B2" else JV.b1_config(),
        steps_per_round=k)
    tv = TV.volume_from_arrays(np.asarray(jv.labels), np.asarray(jv.media))
    ref = JS.simulate(jv, cfg, 2000, 256, 1, source=SRC, mode=mode)
    jax.block_until_ready(ref)
    got = TS.simulate(tv, TV.SimConfig(**dataclasses.asdict(cfg)), 2000,
                      256, 1, source=SRC, mode=mode, device="cpu")
    assert int(got.n_launched) == int(ref.n_launched) == 2000
    assert float(got.launched_w) == float(ref.launched_w)
    assert got.energy.shape == SHAPE and got.exitance.shape == SHAPE[:2]
    jb, tb = JA.energy_balance(ref), TA.energy_balance(got)
    for key in ("absorbed", "escaped", "timed_out"):
        assert abs(tb[key] - jb[key]) <= TOTALS_TOL * jb["launched"], key
    assert abs(tb["residue_frac"]) < 1e-5
    assert got.steps % k == 0


def test_same_seed_is_bit_identical_and_ids_carry_past_2_32():
    vol = TV.benchmark_b2((16, 16, 16))
    cfg = dataclasses.replace(TV.b2_config(), steps_per_round=4,
                              n_time_gates=3)
    sim = TS.make_simulator(vol, cfg, 128, source={"type": "pencil",
                                                   "pos": [8.0, 8.0, 0.0]},
                            device="cpu")
    args = (vol.labels.reshape(-1), vol.media, 400, 9)
    a, b = sim(*args), sim(*args)
    for name in ("energy", "exitance", "escaped_w", "timed_out_w",
                 "n_launched", "launched_w"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.steps == b.steps
    assert a.energy.shape == (16, 16, 16, 3)
    # an id range straddling 2**32: exact count, different photons
    c = sim(*args, id_offset=2**32 - 300, id_offset_hi=0)
    assert int(c.n_launched) == 400
    assert not torch.equal(c.energy, a.energy)
    # the high word selects another range of photons
    d = sim(*args, id_offset=2**32 - 300, id_offset_hi=1)
    assert int(d.n_launched) == 400
    assert not torch.equal(d.energy, c.energy)


def test_max_steps_cap_retires_in_flight_weight():
    vol = TV.benchmark_b1((16, 16, 16))
    cfg = dataclasses.replace(TV.b1_config(), max_steps=6,
                              steps_per_round=3)
    res = TS.simulate(vol, cfg, 300, 64, 2, device="cpu")
    assert res.steps == 6
    bal = TA.energy_balance(res)
    assert bal["timed_out"] > 0
    assert abs(bal["residue_frac"]) < 1e-5


def test_simulate_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = TV.benchmark_b1((8, 8, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.simulate(vol, TV.b1_config(), 10, 16)
    with pytest.raises(RuntimeError):
        tlaunch.main(["--photons", "10", "--size", "8"])
    with pytest.raises(NotImplementedError):
        TS.simulate(vol, dataclasses.replace(TV.b1_config(),
                                             collect_stats=True),
                    10, 16, device="cpu")
    with pytest.raises(ValueError):
        TS.simulate(vol, TV.b1_config(), 10, 16, mode="greedy", device="cpu")


def test_cli_prints_the_reference_lines(capsys):
    res = tlaunch.main(["--bench", "B2", "--photons", "800", "--size", "16",
                        "--lanes", "128", "--steps-per-round", "4",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "B2: 800 photons in " in out
    assert "energy balance: absorbed=" in out and "residue=" in out
    assert "fluence: max=" in out
    assert int(res.n_launched) == 800
    phi = TA.fluence_cw(res, tlaunch.get_bench("B2", 16)[0])
    assert phi.shape == (16, 16, 16) and np.isfinite(phi).all()


def test_analysis_matches_reference_helpers():
    assert TA.mu_eff_theory(0.005, 1.0, 0.01) == JA.mu_eff_theory(
        0.005, 1.0, 0.01)
    cfg = TV.SimConfig(n_time_gates=5, tmax_ns=2.0)
    np.testing.assert_allclose(
        TA.gate_times_ns(cfg),
        JA.gate_times_ns(JV.SimConfig(n_time_gates=5, tmax_ns=2.0)))
    vol = TV.benchmark_b1((12, 12, 30))
    res = TS.simulate(vol, TV.b1_config(), 1500, 256, 4,
                      source={"type": "pencil", "pos": [6.0, 6.0, 0.0]},
                      device="cpu")
    mu = TA.fit_axial_decay(res, vol, (2, 12), axis_xy=(6, 6))
    assert np.isfinite(mu) and mu > 0


def test_profile_run_reads_device_intervals(tmp_path, monkeypatch):
    from repro_torch.launch import profile_run as P

    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "void photon_step_kernel<true>",
         "ts": 10.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "cumsum", "ts": 12.0, "dur": 6.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 30.0,
         "dur": 1.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0,
         "dur": 100.0},
    ]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    ev = P.device_events(str(path))
    assert [e[0] for e in ev] == ["photon_step", "other_kernels", "memcpy"]
    # overlapping kernels count once: [10, 18] and [30, 31]
    assert P.busy_us([(a, b) for _, _, a, b in ev]) == 9.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        P.main(["--photons", "10"])
