"""A run with the timed path broken underneath comes out not correct.

Each fault is planted in the port, in this process, and a whole tiny
run is driven on the CPU (the look for a card skipped): a step that
returns its state unchanged, half of the photons simulated and their
totals doubled, a deposit altered where it is made, a record altered
where it is read off, a scenario's answer replaced by another's.  The
cells run on one card, so there is no exchange between cards to leave
out.
"""

import pytest

from perfbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("checkout"))


def test_step_returning_its_state_unchanged(root, monkeypatch):
    from repro_torch.core import simulator

    real = simulator.photon_steps

    def stuck(labels, media, state, *args, **kw):
        outs = real(labels, media, state, *args, **kw)
        return (state,) + tuple(outs[1:])

    monkeypatch.setattr(simulator, "photon_steps", stuck)
    assert tiny.run(root, "tiny.cw")["correct"] is False


def test_half_the_photons_and_the_mean_over_them(root, monkeypatch):
    from repro_torch.core import simulator

    real = simulator.simulate_fixed

    def half(volume, cfg, n_photons, *args, **kw):
        f = real(volume, cfg, n_photons // 2, *args, **kw)
        return f._replace(**{k: getattr(f, k) * 2 for k in (
            "fluence", "exitance", "escaped", "timed_out", "launched_w",
            "n_launched")})

    monkeypatch.setattr(simulator, "simulate_fixed", half)
    out = tiny.run(root, "tiny.cw")
    assert out["correct"] is False
    assert out["checks"]["fluence_cells_off"]["value"] > 0


def test_a_deposit_altered_where_it_is_made(root, monkeypatch):
    from repro_torch.core import simulator

    real = simulator.photon_steps

    def altered(*args, totals=None, **kw):
        outs = real(*args, totals=totals, **kw)
        totals[0].view(-1)[7] += 1
        return outs

    monkeypatch.setattr(simulator, "photon_steps", altered)
    out = tiny.run(root, "tiny.cw")
    assert out["correct"] is False
    assert out["checks"]["fluence_cells_off"]["value"] > 0


def test_a_record_altered_where_it_is_read(root, monkeypatch):
    from repro_torch import replay

    real = replay.detected_records

    def altered(result):
        rec = real(result).copy()
        rec[0, 3] ^= 1
        return rec

    monkeypatch.setattr(replay, "detected_records", altered)
    out = tiny.run(root, "tiny.detect")
    assert out["correct"] is False
    assert out["checks"]["records_off"]["value"] > 0


def test_a_scenario_answer_replaced(root, monkeypatch):
    from repro_torch import scenarios

    real = scenarios.simulate_many

    def swapped(fleet, **kw):
        res = real(fleet, **kw)
        return [res[0]] + res[:-1]

    monkeypatch.setattr(scenarios, "simulate_many", swapped)
    assert tiny.run(root, "tiny.sweep")["correct"] is False
