"""The round loop's host reads, once every ``ROUNDS_PER_READ`` rounds,
on the CPU.

The loop reads a flag each round leaves on the device (whether any
scenario has work left) once every ``simulator.ROUNDS_PER_READ`` rounds,
so a run issues up to R - 1 rounds after its last photon ends.  Those
rounds are no-ops: every field of the ``FixedResult`` is the same bits
whatever R is, and equal to the frozen plain reference
(``perfbench/reference``), which runs each photon to its end; rounds and
steps are counted on the device, one a round in which a scenario had
work; the ``max_steps`` cap cuts the last batch of rounds; a cancel is
seen at the first read.  On the CPU every round is issued eagerly: no
graph is captured or replayed.  R is a constant of the code; the tests
set other values of it to hold the semantics against R = 1 (a read
before every round).

The round's tail is done by the photon-step call given the run's
``RoundTail``: the host kernel leaves the totals, the round counts, the
work flags and the flag the host reads as the loop's PyTorch operations
left them (``_total_rows`` and its work test, static mode's quota test
included), for one and eight scenarios, a lane count that is no multiple
of 256 and a round in which every lane dies; in static mode a lane below
its quota is budget left, round after round, which is why the tail
needs no static test of its own.  Off the card the step takes no
records: the loop appends each round's captures with
``_append_records`` after it.  No JAX is imported here.
"""

import dataclasses
import pathlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import scenarios as SC  # noqa: E402
from repro_torch import telemetry as T  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402
from repro_torch.detectors import as_detectors, det_geometry  # noqa: E402
from repro_torch.kernels.photon_step import ops  # noqa: E402
from repro_torch.kernels.photon_step import photon_step as K  # noqa: E402
from repro_torch.kernels.photon_step import ref as R  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (16, 16, 16)
DISK = {"type": "disk", "pos": [8.0, 8.0, 0.0], "radius": 3.0}
DETECTORS = [{"x": 11, "y": 8, "radius": 3}, {"x": 5, "y": 8, "radius": 2}]


@pytest.fixture
def reference(monkeypatch):
    """``perfbench.reference``'s ``step`` and ``transport``."""
    monkeypatch.syspath_prepend(str(ROOT))
    from perfbench.reference import step, transport

    return step, transport


def _cfg(k=3, **kw):
    return dataclasses.replace(V.b2_config(), steps_per_round=k,
                               n_time_gates=3, tmax_ns=0.5,
                               collect_stats=True, **kw)


def _run(monkeypatch, every, photons=700, lanes=128, mode="dynamic",
         cfg=None, **kw):
    monkeypatch.setattr(S, "ROUNDS_PER_READ", every)
    return S.simulate_fixed(V.benchmark_b2(SHAPE), cfg or _cfg(), photons,
                            lanes, 2**31 + 9, source=DISK, mode=mode,
                            device="cpu", detectors=DETECTORS,
                            record_detected=512, id_offset=2**32 - 300,
                            **kw)


def _assert_same(a, b):
    for name, x, y in zip(S.FixedResult._fields, a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name
        else:
            assert x == y, name


def _by_id(rows):
    ids = rows[:, 1].astype(np.uint64) << np.uint64(32) | rows[:, 0].astype(
        np.uint64)
    return rows[np.argsort(ids, kind="stable")]


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_trailing_no_op_rounds_change_nothing(reference, monkeypatch, mode):
    """Runs that read before every round, every 6 rounds and every 64
    give every field's bits, and those of the frozen reference: grids,
    totals, counters, records."""
    step, transport = reference
    runs = {every: _run(monkeypatch, every, mode=mode) for every in (1, 6, 64)}
    for every in (6, 64):
        _assert_same(runs[1], runs[every])
    got = runs[64]
    rounds = got.steps // 3
    # the work ends inside the last batch of 6 and of 64
    assert rounds > 64 and rounds % 6 and rounds % 64
    cfg = _cfg()
    vol = V.benchmark_b2(SHAPE)
    phys = step.Physics(do_reflect=cfg.do_reflect, tmax_ns=cfg.tmax_ns,
                        w_threshold=cfg.w_threshold,
                        roulette_m=cfg.roulette_m,
                        n_time_gates=cfg.n_time_gates)
    geom = det_geometry(as_detectors(DETECTORS), "cpu")
    ref = transport.forward(vol.labels.reshape(-1), vol.media, vol.shape,
                            vol.unitinmm, phys, DISK, 2**31 + 9,
                            2**32 - 300, 700, det_geom=geom, record=True)
    assert torch.equal(got.fluence.reshape(-1), ref.fluence)
    assert torch.equal(got.exitance.reshape(-1), ref.exitance)
    assert torch.equal(got.det_w.reshape(-1), ref.det_w)
    assert torch.equal(got.det_ppath, ref.det_ppath)
    assert [int(got.escaped), int(got.timed_out), int(got.launched_w),
            int(got.n_launched), int(got.counters[3])] == [
        ref.escaped, ref.timed_out, ref.launched_w, ref.n_launched,
        ref.live_segments]
    n = int(got.det_rec_n)
    assert 0 < n == ref.records.shape[0] and int(got.det_rec_overflow) == 0
    np.testing.assert_array_equal(_by_id(got.det_rec[:n].numpy()),
                                  _by_id(ref.records.numpy()))


def test_rounds_and_steps_are_counted_on_the_device(monkeypatch):
    """In a batch of scenarios that end rounds apart, each scenario's
    steps and round counters stop at its own last round with work, read
    every 64 rounds or before every round alike."""
    vol = V.benchmark_b2(SHAPE)
    fleet = [SC.Scenario(vol, _cfg(k=4), n, seed=5,
                         source=dict(DISK, pos=[6.0 + 2 * i, 8.0, 0.0]),
                         id_offset=1000 * i)
             for i, n in enumerate((20, 150, 400))]
    runs = {}
    for every in (1, 64):
        monkeypatch.setattr(S, "ROUNDS_PER_READ", every)
        runs[every] = SC.simulate_many(fleet, n_lanes=64, device="cpu",
                                       cache=SC.CompileCache())
    steps = [r.steps for r in runs[64]]
    assert steps == [r.steps for r in runs[1]]
    assert steps[0] < steps[1] < steps[2]
    for a, b in zip(runs[1], runs[64]):
        assert torch.equal(a.energy, b.energy)
        assert a.stats == b.stats
        assert int(b.stats.rounds) == b.steps // 4
        assert float(b.stats.lane_segments) == b.steps * 64


def test_max_steps_cuts_the_last_batch(monkeypatch):
    """A cap of 50 segments at K = 3 is 17 rounds, 3 batches of 5 and one
    of 2: the loop issues 17 photon steps, retires what is still in
    flight, and gives the bits of a read before every round."""
    calls = []
    step = S.photon_steps

    def counted(*a, **k):
        calls.append(1)
        return step(*a, **k)

    monkeypatch.setattr(S, "photon_steps", counted)
    cfg = _cfg(max_steps=50)
    capped = _run(monkeypatch, 5, cfg=cfg)
    assert len(calls) == 17 and capped.steps == 51
    assert int(capped.timed_out) > 0
    _assert_same(_run(monkeypatch, 1, cfg=cfg), capped)
    assert len(calls) == 34


def test_cpu_runs_replay_no_graph(monkeypatch):
    """Under a capture the ``run`` span counts its reads and no replay;
    no round graph is counted in ``launches_by``, and every round issued
    (the rounds with work, then no-op ones up to the next read) is an
    eager round of the host kernel, which did the round's tail."""
    T.capture_tracer().events.clear()
    K.reset_launches()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = _run(monkeypatch, 4, cfg=_cfg(k=8))
        events = T.capture_tracer().events
        (run,) = [e for e in events if e.name == "run"]
        rounds = got.steps // 8
        batches = -(-rounds // 4)
        assert run.args["rounds"] == rounds
        assert run.args["host_reads"] == batches + 1
        assert run.args["replays"] == 0
        assert not [e for e in events if e.name == "round.replay"]
        assert len([e for e in events if e.name == "round.step"]) == (
            batches * 4)
        assert K.photon_step_cuda.launches_by["round_graph"] == 0
        tail = "host/" + K.TAIL_KEY
        host = [k for k in K.photon_step_cuda.launches_by
                if k.startswith("host/") and k != tail]
        assert len(host) == 1
        assert K.photon_step_cuda.launches_by[host[0]] == batches * 4
        assert K.photon_step_cuda.launches_by[tail] == batches * 4
    finally:
        T.capture_tracer().events.clear()


def test_the_cpu_loop_appends_the_records_after_the_step(monkeypatch):
    """Off the card the step takes no records: the loop appends each
    round's captures with ``_append_records`` after it, once a round
    issued, inside a ``round.records`` span, and the run is the same
    bits as without the counting wrappers."""
    want = _run(monkeypatch, 4)
    steps, appends = [], []
    step, append = S.photon_steps, S._append_records

    def step_given(*a, **k):
        steps.append(k.get("records"))
        return step(*a, **k)

    def counted(*a, **k):
        appends.append(1)
        return append(*a, **k)

    monkeypatch.setattr(S, "photon_steps", step_given)
    monkeypatch.setattr(S, "_append_records", counted)
    T.capture_tracer().events.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = _run(monkeypatch, 4)
        spans = [e.name for e in T.capture_tracer().events]
    finally:
        T.capture_tracer().events.clear()
    _assert_same(got, want)
    assert int(got.det_rec_n) > 0
    assert steps and all(r is None for r in steps)
    assert len(appends) == len(steps) == spans.count("round.records")


def test_a_cancel_set_before_the_run_stops_it_at_the_first_read(
        monkeypatch):
    calls = []
    monkeypatch.setattr(S, "photon_steps",
                        lambda *a, **k: calls.append(1))
    vol = V.benchmark_b2(SHAPE)
    run = S.build_fixed_fn(vol.shape, vol.unitinmm, _cfg(), 128,
                           source=DISK, device="cpu")
    cancel = threading.Event()
    cancel.set()
    with pytest.raises(S.RunCancelled, match="after 0 steps"):
        run(vol.labels.reshape(-1), vol.media, 700, 3, cancel=cancel)
    assert calls == []


# ---------------------------------------------------------------------------
# the round's tail, done by the photon-step call
# ---------------------------------------------------------------------------

TAIL_LANES = 300  # a scenario's lanes: no multiple of the card's 256


def _tail_case(S_, mode, case, seed):
    """A round's inputs: an ``(S_ * TAIL_LANES)``-lane state (a third of
    its lanes dead; for ``"all die"`` and ``"run ends"`` every live lane
    times out in the round), a media table of S_ rows, and a tail
    part-way through a run with its mode's budgets (static: the
    remaining quotas; none left anywhere for ``"run ends"``).  Returns
    ``(args, tail, launched, quota)``."""
    g = torch.Generator().manual_seed(seed)
    vol = V.benchmark_b2(SHAPE)
    cfg = dataclasses.replace(_cfg(k=4), tmax_ns=0.5 if case == "mid-run"
                              else 1e-4)
    n_all = S_ * TAIL_LANES
    state = ops.fresh_state(vol, n_all, seed=seed, source=DISK)
    state = state._replace(alive=torch.rand(n_all, generator=g) < 0.67)
    media = vol.media[None].repeat(S_, 1, 1).contiguous()
    args = (vol.labels.reshape(-1), media, state, SHAPE, 1.0, cfg, 4)
    # static mode: each lane's quota as the loop splits a budget, some
    # lanes a launch short of it; the budget left is what they lack
    photons = torch.randint(0, 3 * TAIL_LANES, (S_,), generator=g)
    lane = torch.arange(TAIL_LANES)
    quota = photons[:, None] // TAIL_LANES + (
        lane[None] < (photons % TAIL_LANES)[:, None]).to(torch.int64)
    short = torch.rand((S_, TAIL_LANES), generator=g) < 0.02
    if case == "run ends":
        short[:] = False  # no budget left anywhere
    short[1::3] = False  # scenarios with no budget left
    launched = quota - (short & (quota > 0)).to(torch.int64)
    remaining = (quota - launched).sum(1)
    if mode == "dynamic" and case != "run ends":
        remaining = torch.randint(0, 40, (S_,), generator=g)
        remaining[1::3] = 0
    tail = K.round_tail(torch.randint(0, 2**40, (S_,), generator=g),
                        torch.randint(0, 2**40, (S_,), generator=g),
                        remaining)
    tail.rounds.copy_(torch.randint(0, 500, (S_,), generator=g))
    tail.work.copy_(torch.rand(S_, generator=g) < 0.7)
    return args, tail, launched, quota


def _tail_as_the_loop_did(tail, outs, mode, launched, quota):
    """The tail as the round loop computed it after the step, in PyTorch
    operations: ``_total_rows`` of the per-lane weights, the rounds of
    the scenarios that had work, then each mode's work test."""
    S_ = tail.rounds.shape[0]
    alive = outs[0].alive.view(S_, -1)
    if mode == "dynamic":
        work = alive.any(1) | (tail.remaining > 0)
    else:
        work = (alive | (launched < quota)).any(1)
    return K.RoundTail(
        escaped=tail.escaped + S._total_rows(outs[3], S_),
        timed_out=tail.timed_out + S._total_rows(outs[4], S_),
        rounds=tail.rounds + tail.work.to(torch.int64), work=work,
        more=work.any(), remaining=tail.remaining,
        flags=torch.zeros_like(tail.flags))


@pytest.mark.parametrize("case", ["mid-run", "all die", "run ends"])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("S_", [1, 8])
def test_the_steps_tail_leaves_what_the_loop_computed(S_, mode, case):
    """The host kernel given the run's tail leaves the escaped and
    timed-out totals, the round counts, the work flags and ``more``
    equal to what the loop's ``_total_rows`` and work test gave on the
    same state (static mode's test by quota included), clears its
    flags, writes no per-lane weights, and changes no other output; the
    plain version's tail (``ref.round_tail_ref``) gives the same."""
    args, tail, launched, quota = _tail_case(S_, mode, case, seed=S_ + 7)
    plain = ops.photon_steps(*args)
    want = _tail_as_the_loop_did(tail, plain, mode, launched, quota)
    ref_tail = K.RoundTail(*(x.clone() for x in tail))
    K.reset_launches()
    got = ops.photon_steps(*args, tail=tail)
    assert K.photon_step_cuda.launches_by["host/" + K.TAIL_KEY] == 1
    assert got[3] is None and got[4] is None
    for x, y in zip(got[0], plain[0]):
        assert torch.equal(x, y)
    assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])
    if case != "mid-run":
        assert bool(plain[0].alive.any()) is False
        assert torch.equal(tail.work, tail.remaining > 0)
        assert bool(tail.more) == bool((tail.remaining > 0).any())
        assert case == "all die" or not bool(tail.more)
    assert bool(tail.more) == bool(tail.work.any())
    for name, x, y in zip(K.RoundTail._fields, tail, want):
        assert torch.equal(x, y), name
    R.round_tail_ref(ref_tail, plain[3], plain[4], plain[0].alive)
    for name, x, y in zip(K.RoundTail._fields, ref_tail, want):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("seed", range(8))
def test_in_static_mode_a_lane_below_its_quota_is_budget_left(seed):
    """Over random budgets and lane counts of 1 to 4 scenarios in static
    mode, after every regeneration ``any(launched < quota, 1)`` equals
    ``remaining > 0`` (``PlainRegeneration`` subtracts each relaunch from
    the budget, as the regeneration kernel does, and the quotas sum to
    it), so the work test of the round's tail (a lane alive, or budget
    left) is the loop's static test (a lane alive or below its quota),
    round after round until the run ends."""
    g = torch.Generator().manual_seed(seed)
    S_ = int(torch.randint(1, 5, (), generator=g))
    n = int(torch.randint(1, 700, (), generator=g))
    photons = torch.randint(0, 4 * n, (S_,), generator=g)
    vol = V.benchmark_b2(SHAPE)
    lane = torch.arange(n)
    quota = photons[:, None] // n + (
        lane[None] < (photons % n)[:, None]).to(torch.int64)
    remaining = photons.clone()
    launched = torch.zeros((S_, n), dtype=torch.int64)
    launched_w = torch.zeros((S_,), dtype=torch.int64)
    seeds = torch.arange(S_, dtype=torch.int64)[:, None] + seed
    sample = S.source_sampler(DISK, "cpu")
    regen = S.PlainRegeneration(
        lambda ids, sd: tuple(x.expand((S_,) + x.shape[1:]) if S_ > 1 else x
                              for x in sample(ids, sd[:1])),
        "static", vol.shape, remaining, launched, quota, launched_w, seeds)
    state = ops.fresh_state(vol, S_ * n, source=DISK)._replace(
        alive=torch.zeros(S_ * n, dtype=torch.bool))
    next_id = (torch.zeros(S_, dtype=torch.int64),
               torch.zeros(S_, dtype=torch.int64))
    tail = K.round_tail(torch.zeros(S_, dtype=torch.int64),
                        torch.zeros(S_, dtype=torch.int64), remaining)
    zeros = torch.zeros(S_ * n)
    for _ in range(200):
        next_id = tuple(x.clone() for x in regen(state, next_id))
        assert torch.equal((launched < quota).any(1), remaining > 0)
        # a step: each live lane dies with chance 0.4
        state.alive.logical_and_(torch.rand(S_ * n, generator=g) < 0.6)
        R.round_tail_ref(tail, zeros, zeros, state.alive)
        assert torch.equal(tail.work, (state.alive.view(S_, n)
                                       | (launched < quota)).any(1))
        if not bool(tail.more):
            break
    else:
        raise AssertionError("the run did not end in 200 rounds")
    assert torch.equal(launched, quota) and int(remaining.sum()) == 0


def test_the_tails_range_check_fires_on_the_host():
    """A weight of 2**44 units of the totals (here a lane of weight 1e7
    timed out, in a medium that absorbs nothing, so no deposit is out of
    range) adds nothing to the totals and raises, as the card's kernel
    flags it; without the tail the same launch raises nothing.  A total
    pushed past 2**63 - 1 raises too."""
    vol = V.benchmark_b1(SHAPE)
    media = vol.media.clone()
    media[:, 0] = 0.0
    cfg = dataclasses.replace(V.b1_config(), tmax_ns=1.0)
    state = ops.fresh_state(vol, 64, seed=3)
    heavy = state._replace(
        w=torch.where(torch.arange(64) == 5, torch.tensor(1e7), state.w),
        t=torch.where(torch.arange(64) == 5, torch.tensor(2.0), state.t))
    args = (vol.labels.reshape(-1), media[None], heavy, SHAPE, 1.0, cfg, 1)
    out = ops.photon_steps(*args)
    assert float(out[4][5]) == 1e7
    zero = torch.zeros(1, dtype=torch.int64)
    tail = K.round_tail(zero.clone(), zero.clone(), zero.clone())
    with pytest.raises(OverflowError):
        ops.photon_steps(*args, tail=tail)
    assert int(tail.timed_out) == 0
    full = K.round_tail(zero.clone(), torch.full((1,), 2**63 - 1),
                        zero.clone())
    args = (vol.labels.reshape(-1), media[None], state, SHAPE, 1.0,
            dataclasses.replace(cfg, tmax_ns=1e-4), 1)
    with pytest.raises(OverflowError):
        ops.photon_steps(*args, tail=full)
