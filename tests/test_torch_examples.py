"""The port's example modules (``repro_torch.examples``) against the
reference's calls through ``repro``, at a small size with the same
seeds, on the CPU.

Photon accounting is exact: ``n_launched`` equal, ``launched_w`` to
1e-6 relative (the port adds launch weights in int64 fixed point, the
reference in float32: the planar source's 1000 patterned weights sum to
595.0 and 595.00006); absorbed
and escaped weight are sums over trajectories whose float32 arithmetic
differs between XLA's CPU code and the port, so they are held to 2e-3
of the launched weight, as in ``test_torch_simulator.py``.  The fitted
axial decay of quickstart's B1 at 20^3 (2000 photons, 256 lanes, seed
42) differs from the reference's by 0.29% (2.1% at most over seeds 1-3,
measured on the CPU); the tolerance is 5%.  The partitions of
heterogeneous_lb are pure host arithmetic and equal; the chunk
scheduler's and the campaign's int64 totals equal one run's bit for bit
(the port's own contract, ``test_torch_multidevice.py``), the
campaign's against one run at the reference's one segment a round (the
examples run ``STEPS_PER_ROUND``).
"""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import sources as JSRC  # noqa: E402
from repro.core import analysis as JA  # noqa: E402
from repro.core import loadbalance as JLB  # noqa: E402
from repro.core import simulator as JS  # noqa: E402
from repro.core import volume as JV  # noqa: E402
from repro_torch.core import loadbalance as TLB  # noqa: E402
from repro_torch.core import simulator as TS  # noqa: E402
from repro_torch.core import volume as TV  # noqa: E402
from repro_torch.examples import fault_tolerant_campaign as campaign  # noqa: E402
from repro_torch.examples import (heterogeneous_lb, quickstart,  # noqa: E402
                                  source_gallery)

REPO = pathlib.Path(__file__).resolve().parents[1]
TOTALS_TOL = 2e-3
MU_FIT_RTOL = 0.05
GALLERY = dict(size=16, photons=1000, lanes=1024)
INT64_TOTALS = ("fluence", "exitance", "escaped", "timed_out", "launched_w",
                "n_launched")


def _reference_module(name):
    """The reference's ``examples/<name>.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_totals_close(got, ref):
    """Exact accounting, absorbed / escaped within TOTALS_TOL of the
    launched weight, and a residue below 1e-4."""
    jb, tb = JA.energy_balance(ref), got["balance"]
    assert int(got["result"].n_launched) == int(ref.n_launched)
    assert float(got["result"].launched_w) == pytest.approx(
        float(ref.launched_w), rel=1e-6)
    for key in ("absorbed", "escaped"):
        assert abs(tb[key] - jb[key]) <= TOTALS_TOL * jb["launched"], key
    assert abs(tb["residue_frac"]) < 1e-4


def _assert_same_totals(a, b):
    for f in INT64_TOTALS:
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        assert x.dtype == y.dtype == torch.int64 and torch.equal(x, y), f


def test_quickstart_matches_reference(capsys):
    out = quickstart.main(["--size", "20", "--photons", "2000", "--lanes",
                           "256", "--device", "cpu"])
    jv = JV.benchmark_b1((20,) * 3)
    ref = JS.simulate(jv, JV.b1_config(), 2000, 256, 42,
                      source={"type": "pencil", "pos": [10.0, 10.0, 0.0]})
    jax.block_until_ready(ref)
    assert int(out["result"].n_launched) == 2000
    _assert_totals_close(out, ref)
    mu_ref = JA.fit_axial_decay(ref, jv, (3, 11), axis_xy=(10, 10))
    assert out["mu_fit"] == pytest.approx(mu_ref, rel=MU_FIT_RTOL)
    assert out["mu_theory"] == JA.mu_eff_theory(0.005, 1.0, 0.01)
    assert out["profile"].shape == (15,) and (out["profile"] > 0).all()
    printed = capsys.readouterr().out
    assert "energy balance: launched=2000" in printed
    assert sum(ln.startswith("  z=") for ln in printed.splitlines()) == 15


def test_quickstart_at_60_is_the_reference_beam():
    """At the reference's 60^3 the beam is the default pencil of
    examples/quickstart.py."""
    from repro_torch import sources as TSRC

    assert TSRC.Pencil(pos=(30.0, 30.0, 0.0)) == TSRC.as_source(None)


@pytest.fixture(scope="module")
def gallery():
    out = source_gallery.main(
        ["--size", str(GALLERY["size"]), "--photons", str(GALLERY["photons"]),
         "--lanes", str(GALLERY["lanes"]), "--device", "cpu"])
    return {row["name"]: row for row in out}


@pytest.mark.parametrize("name", list(JSRC.demo_menu(16)))
def test_source_gallery_matches_reference(gallery, name):
    size = GALLERY["size"]
    src = JSRC.demo_menu(size)[name]
    row = gallery[name]
    assert row["source"] == JSRC.to_dict(src)
    ref = JS.simulate(JV.benchmark_b1((size,) * 3), JV.b1_config(),
                      GALLERY["photons"], GALLERY["lanes"], 42, source=src)
    jax.block_until_ready(ref)
    assert int(row["result"].n_launched) == GALLERY["photons"]
    _assert_totals_close(row, ref)
    assert row["exitance"].shape == (size, size)


def test_source_gallery_ascii_map_equals_reference(gallery):
    ref = _reference_module("source_gallery")
    rng = np.random.default_rng(0)
    images = [row["exitance"] for row in gallery.values()] + [
        np.zeros((40, 40), np.float32),
        rng.exponential(size=(60, 60)).astype(np.float32),
        rng.exponential(size=(20, 24)) * (rng.random((20, 24)) < 0.3)]
    for img in images:
        assert source_gallery.ascii_map(img) == ref.ascii_map(img)
        assert (source_gallery.ascii_map(img, width=8)
                == ref.ascii_map(img, width=8))


def test_heterogeneous_lb_partitions_and_chunks_match():
    model = TLB.DeviceModel("local", a=2.5e-5, t0=0.05)
    n = 1600   # the reference's beam at (30, 30, 0) lies inside 32^3
    out = heterogeneous_lb.run(size=32, photons=n, lanes=256,
                               chunk_lanes=256, device="cpu", model=model)
    # the reference's synthetic mix (examples/heterogeneous_lb.py:43-47)
    jm = JLB.DeviceModel("local", a=model.a, t0=model.t0)
    jmix = [JLB.DeviceModel("gpu-fast", a=jm.a / 4, t0=jm.t0, cores=4096),
            JLB.DeviceModel("gpu-slow", a=jm.a / 2, t0=jm.t0 * 2, cores=2048),
            JLB.DeviceModel("cpu", a=jm.a, t0=jm.t0 / 2, cores=16)]
    for strat, fn in JLB.PARTITIONERS.items():
        want = fn(n, jmix)
        got = out["partitions"][strat]
        assert got["partition"] == want and sum(want) == n, strat
        assert got["makespan"] == JLB.makespan(want, jmix), strat
    assert out["partitions"]["ideal"] == JLB.ideal_makespan(n, jmix)
    assert out["devices"] == ["cpu:0"]
    assert sum(out["local_photons"].values()) == n
    assert sum(out["chunk_photons"].values()) == n
    assert int(out["local"].n_launched) == n
    _assert_same_totals(out["chunked"], out["local"])


def test_campaign_chaos_and_restart_are_bit_identical(tmp_path):
    out = campaign.main(["--size", "12", "--photons", "4000", "--chunk",
                         "500", "--lanes", "512", "--device", "cpu",
                         "--checkpoint-dir", str(tmp_path)])
    rep = out["report"]
    assert rep.n_chunks == rep.merged == 8 and rep.retries >= 1
    assert out["crash"] is not None and out["latest_step"] == 4
    assert out["restored"] == (4, 4)
    _assert_same_totals(out["chaos"], out["reference"])
    _assert_same_totals(out["resumed"], out["reference"])
    # and the bits of one run over the same photons at the reference's
    # one segment a round (the examples run STEPS_PER_ROUND)
    one = TS.simulate_fixed(TV.benchmark_b2((12,) * 3), TV.b2_config(), 4000,
                            512, 5, device="cpu")
    assert TV.b2_config().steps_per_round == 1
    _assert_same_totals(out["reference"], one)
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == [
        "step_0000000003.npz", "step_0000000004.npz"]


def test_campaign_totals_differ_raises(monkeypatch):
    """A restart whose totals differ from the clean run's raises."""
    monkeypatch.setattr(campaign, "same_totals", lambda a, b: False)
    with pytest.raises(RuntimeError, match="chaos drill"):
        campaign.run(size=8, photons=200, chunk=100, lanes=128,
                     device="cpu")


@pytest.mark.parametrize("module", [quickstart, source_gallery,
                                    heterogeneous_lb, campaign],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_examples_need_a_card_by_default(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        module.main([])
