"""The plain reference against the port, at tiny sizes on the CPU.

The port's host kernel is bit-equal to its plain version, so every
int64 output of a solution has to equal the reference's exactly; the
control (the reference's fixed-point inputs in bfloat16) has to be
rejected by at least one of the numbers compared.
"""

import pytest

from perfbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_reference_matches_port(root, cell):
    drv = tiny.driver(root, cell)
    sol = drv.solve(0)
    stats = drv.stats(sol)
    assert stats["photons"] > 0 and stats["rounds"] > 0
    if cell == "tiny.detect":
        assert stats["records"] > 100
    checks = drv.compare(sol, drv.reference(sol))
    assert checks and all(v == 0 for v in checks.values()), checks


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_reference_in_small_batches(root, cell, monkeypatch):
    """Batches far smaller than the photons, and a tail that shrinks
    many times: many refills and compactions, the same bits."""
    from perfbench.reference import transport

    drv = tiny.driver(root, cell, seed=8)
    sol = drv.solve(0)
    monkeypatch.setattr(transport, "BATCH", 300)
    monkeypatch.setattr(transport, "TAIL", 200)
    monkeypatch.setattr(transport, "GRAPH_MIN_LANES", 8)
    checks = drv.compare(sol, drv.reference(sol))
    assert all(v == 0 for v in checks.values()), checks


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_is_rejected(root, cell):
    """``perfbench/control.py``'s two readings: 0 for the sound
    reference, more for the control on at least one number."""
    from perfbench import control

    (out,) = control.readings(cell, [6], device="cpu", root=root)
    assert all(v == 0 for v in out["sound"].values()), out
    assert max(out["control"].values()) > 0, out
    assert out["live_segments_per_photon"] > 1


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_run_is_correct_and_prints_checks_last(root, cell):
    out = tiny.run(root, cell)
    assert out["correct"] is True, out
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) == 2
    assert list(out)[-1] == "checks"
    assert all(c["limit"] == 0 and c["value"] == 0
               for c in out["checks"].values())
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}


def test_reference_ids_cross_the_32_bit_boundary(root):
    """Solutions start at 64-bit ids; one that straddles 2**32 carries
    into the high word as the port does."""
    from perfbench.reference import rng

    lo, hi = rng.id_words(2**32 - 2, 4, "cpu")
    assert lo.tolist() == [2**32 - 2, 2**32 - 1, 0, 1]
    assert hi.tolist() == [0, 0, 1, 1]


def test_trace_reduction_on_a_made_up_trace():
    """``profiling.reduce``: busy time as the union of device intervals,
    idle stretches charged to the outermost host operation running."""
    from perfbench import profiling

    ev = [{"ph": "X", "cat": "kernel", "name": "photon_step_kernel",
           "ts": 10, "dur": 5},
          {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 12,
           "dur": 6},
          {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 30,
           "dur": 2},
          {"ph": "X", "cat": "cpu_op", "name": "aten::where", "ts": 18,
           "dur": 8},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 19,
           "dur": 2},
          {"ph": "X", "cat": "cpu_op", "name": "aten::sum", "ts": 33,
           "dur": 20}]
    t = profiling.reduce(ev, 0, 40)
    assert t.busy_s == pytest.approx(10e-6)
    assert t.window_s == pytest.approx(40e-6)
    assert t.device_events == 3
    assert t.step_s == pytest.approx(5e-6)
    assert t.other_s == pytest.approx(8e-6)
    idle = dict(t.idle_gaps)
    assert idle == pytest.approx({profiling.BETWEEN: 15e-6,
                                  "aten::where": 8e-6, "aten::sum": 7e-6})
