"""The port's resilience layer (``repro_torch.resilience``) and its
chunked schedulers, on CPU workers.

Contracts under test:

  * **Chaos anchor**: under a seeded fault schedule (dispatch failures,
    corrupted harvests, injected delays, a dropped worker, speculation
    past the chunk timeout) the pool's merged int64 totals are exactly
    those of one ``simulate()`` over the same photons, no chunk is
    merged twice, and the retry/quarantine accounting adds up.  The
    reference holds its pool to its own fault-free run; the port, whose
    totals are int64 sums, to one run of any shape.
  * **FaultInjector and RetryPolicy**: the port's copies decide exactly
    as the reference's over a grid of seeds, chunks, attempts and
    labels.  The reference's two modules are loaded from their files,
    which import no JAX.
  * **validate_chunk**: accepts real chunks and rejects a corrupted
    cell (the int64 minimum), a short launch, a negative total, a NaN
    float and a broken energy balance.
  * **Deadlines, speculation, quarantine, exhaustion, overall deadline**,
    with the abandoned chunk stopped in its worker's process at its
    next round.
  * **Failures in the workers' processes**: an error raised in a
    worker's process crosses back pickled, with its message; the
    kernel's errors end the run, others are retried, and a process that
    dies is a failed dispatch, never a silent loss.
  * **Checkpoint/restart**: the pool (frontier checkpoints, resume) and
    the elastic simulator (an injected host crash, restore, finish) end
    bit-identical to an uninterrupted campaign, records, round counters
    and gated detector totals included; the CLI's ``--chunk --chaos
    --checkpoint-*`` drill resumes to the same bits.
"""

import dataclasses
import importlib.util
import json
import pathlib
import os
import signal
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.core import procs  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402
from repro_torch.core.multidevice import ElasticSimulator  # noqa: E402
from repro_torch.launch import simulate as launch  # noqa: E402
from repro_torch.resilience import (ChunkQuarantinedError, DevicePool,  # noqa: E402
                                    DeviceSpec, FaultInjector, InjectedCrash,
                                    InjectedFault, PoolExhaustedError,
                                    RetryPolicy, corrupt_harvest,
                                    harvest_result, validate_chunk)
from repro_torch.resilience.policy import HEALTHY, QUARANTINED, SUSPECT  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (16, 16, 16)
LANES = 128
SEED = 7
INT64_TOTALS = ("fluence", "exitance", "det_w", "det_ppath", "escaped",
                "timed_out", "launched_w", "n_launched")
FIELDS = ("energy", "exitance", "escaped_w", "timed_out_w", "det_w",
          "det_ppath", "launched_w", "n_launched", "det_rec_overflow")


def _bench(**kw):
    """B1 with 3 gates over 0.3 ns (photons live ~130 segments)."""
    return V.benchmark_b1(SHAPE), dataclasses.replace(
        V.b1_config(), steps_per_round=8, n_time_gates=3, tmax_ns=0.3, **kw)


def _cpu(label=None, **kw):
    return DeviceSpec(device="cpu", n_lanes=kw.pop("n_lanes", LANES),
                      label=label, **kw)


def assert_same_totals(got, want):
    for f in INT64_TOTALS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()), f


def assert_same_fields(got, want):
    for f in FIELDS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()), f


def _load_reference(name):
    """A module of ``src/repro/resilience`` loaded from its file, without
    the package's ``__init__`` (which imports the JAX pool)."""
    path = REPO / "src" / "repro" / "resilience" / f"{name}.py"
    key = f"_reference_resilience_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod  # dataclasses look their module up
        spec.loader.exec_module(mod)
    return sys.modules[key]


# ---------------------------------------------------------------------------
# FaultInjector and RetryPolicy against the reference
# ---------------------------------------------------------------------------

def _fate(inj, fault, chunk, attempt, label):
    try:
        inj.check_dispatch(chunk, attempt, label)
        failed = None
    except fault as e:
        failed = str(e)
    return (failed, inj.corrupts(chunk, attempt),
            inj.delay_for(chunk, attempt), inj.dropped(label, attempt))


def test_fault_injector_decides_as_the_reference():
    ref = _load_reference("faults")
    from repro_torch.resilience import faults
    assert "jax" not in ref.__dict__ and "jax" not in faults.__dict__
    grid = [(c, a, lab) for c in (0, 150, 500, 2**32 + 7, 2**40)
            for a in range(4) for lab in ("w0:cpu:0", "lag", "")]
    for seed in (0, 1, 4, 2**63 + 5):
        cfg = dict(seed=seed, p_fail=0.3, p_nan=0.25, p_delay=0.2,
                   delay_s=0.03, poison_chunks=[500],
                   dropout={"lag": 2}, kill_after_merges=3)
        port, want = faults.FaultInjector(**cfg), ref.FaultInjector(**cfg)
        assert [_fate(port, faults.InjectedFault, *g) for g in grid] == [
            _fate(want, ref.InjectedFault, *g) for g in grid]
        assert port.active == want.active
        for n in range(5):
            outcomes = []
            for inj, crash in ((port, faults.InjectedCrash),
                               (want, ref.InjectedCrash)):
                try:
                    inj.maybe_kill(n)
                    outcomes.append(None)
                except crash as e:
                    outcomes.append(str(e))
            assert outcomes[0] == outcomes[1]
    assert not faults.FaultInjector().active


def test_retry_policy_decides_as_the_reference():
    ref = _load_reference("policy")
    from repro_torch.resilience import policy
    for kw in (dict(), dict(max_attempts=3, backoff_s=0.1,
                            backoff_factor=2.0, max_backoff_s=0.3,
                            suspect_after=2, quarantine_after=4),
               dict(backoff_s=0.05, backoff_factor=3.0)):
        a, b = policy.RetryPolicy(**kw), ref.RetryPolicy(**kw)
        assert [(a.backoff(k), a.exhausted(k), a.health_for(k))
                for k in range(8)] == [(b.backoff(k), b.exhausted(k),
                                        b.health_for(k)) for k in range(8)]
    for bad in (dict(max_attempts=0), dict(suspect_after=3,
                                           quarantine_after=2),
                dict(backoff_s=-1.0)):
        for cls in (policy.RetryPolicy, ref.RetryPolicy):
            with pytest.raises(ValueError):
                cls(**bad)
    p = RetryPolicy(max_attempts=3, backoff_s=0.1, max_backoff_s=0.3,
                    suspect_after=2, quarantine_after=4)
    assert [p.backoff(k) for k in (1, 2, 3, 4)] == [0.1, 0.2, 0.3, 0.3]
    assert [p.health_for(n) for n in (0, 1, 2, 3, 4)] == \
        [HEALTHY, HEALTHY, SUSPECT, SUSPECT, QUARANTINED]


def test_fault_injector_schedules_and_json_config():
    inj = FaultInjector(seed=1, poison_chunks=[100], dropout={"w0": 2},
                        kill_after_merges=3)
    assert inj.poison_chunks == (100,) and inj.active
    with pytest.raises(InjectedFault, match="poison"):
        inj.check_dispatch(100, attempt=5)
    inj.check_dispatch(200, attempt=0)
    assert not inj.dropped("w0", 1) and inj.dropped("w0", 2)
    assert not inj.dropped("w1", 99)
    inj.maybe_kill(2)
    with pytest.raises(InjectedCrash):
        inj.maybe_kill(3)


# ---------------------------------------------------------------------------
# validate_chunk: the merge guard on int64 harvests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chunk():
    vol, cfg = _bench()
    return S.simulate_fixed(vol, cfg, 300, 256, SEED, device="cpu")


def test_validate_chunk_accepts_real_results_and_rejects_corruption(chunk):
    h = harvest_result(chunk)
    assert h.fluence.dtype == torch.int64 and h.fluence.device.type == "cpu"
    assert int(h.det_rec_n) == h.det_rec.shape[0]
    assert validate_chunk(h, 300) == []
    bad = corrupt_harvest(h)
    assert int(bad.fluence.view(-1)[0]) == torch.iinfo(torch.int64).min
    assert any("negative" in e for e in validate_chunk(bad, 300))
    assert validate_chunk(h, 300) == []  # the corruption is on a copy
    assert any("assigned" in e for e in validate_chunk(h, 301))
    neg = h._replace(exitance=h.exitance - 1)
    assert any("negative" in e for e in validate_chunk(neg, 300))
    # a scalar total past the range wraps negative too
    wrapped = h._replace(escaped=torch.tensor(torch.iinfo(torch.int64).min))
    assert any("escaped contains a negative" in e
               for e in validate_chunk(wrapped, 300))
    # a broken energy balance, every total still in range
    skew = h._replace(launched_w=h.launched_w * 3 // 2)
    assert any("residue" in e for e in validate_chunk(skew, 300))


# ---------------------------------------------------------------------------
# the pool: chaos anchors, speculation, quarantine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_run():
    vol, cfg = _bench()
    return vol, cfg, S.simulate_fixed(vol, cfg, 800, 512, SEED, device="cpu")


def test_pool_chaos_anchor_bit_identical_to_one_run(one_run):
    """The reference's fleet anchor (tests/test_multidevice.py) on CPU
    workers of three lane counts, one throttled: dispatch failures,
    corrupted harvests, delays, a scheduled dropout and speculation past
    the chunk timeout change no bit of the merged totals."""
    vol, cfg, want = one_run
    specs = [_cpu(f"c{i}", n_lanes=n) for i, n in enumerate((64, 128, 256))]
    specs.append(_cpu("lag", throttle_s=0.4))
    # chunks 100 and 600 are corrupted and chunk 400 fails at their
    # first attempts; worker c1 leaves after one dispatch
    inj = FaultInjector(seed=2, p_fail=0.25, p_nan=0.25, p_delay=0.25,
                        delay_s=0.05, dropout={"c1": 1})
    pool = DevicePool(vol, cfg, specs, chunk_timeout_s=0.3,
                      fault_injector=inj,
                      retry_policy=RetryPolicy(max_attempts=12,
                                               quarantine_after=50))
    got, rep = pool.run_fixed(800, 100, seed=SEED, deadline_s=300)
    assert_same_totals(got, want)
    assert rep.merged == rep.n_chunks == 8 and not rep.quarantined_chunks
    assert rep.injected_faults > 0 and rep.retries > 0
    assert rep.validation_failures > 0
    assert rep.dispatch_failures > 0
    assert rep.speculative >= 1  # the throttled worker's chunk
    assert rep.workers_quarantined == 1 and rep.rebound == 0
    merged = sum(w["chunks_merged"] for w in rep.workers)
    assert merged == 8
    assert sum(rep.per_device_photons.values()) == 800


def test_pool_straggler_speculation_first_valid_wins(one_run):
    """The slow worker's first chunk passes its deadline and runs again
    on the fast worker; the later of the two results is discarded.  The
    throttles (latency floors) exceed a chunk's compute (0.4-1.2 s in a
    CPU worker's process), so the two workers differ whatever the
    machine's load."""
    vol, cfg, want = one_run
    specs = [_cpu("slow", throttle_s=2.0), _cpu("fast", throttle_s=0.6)]
    pool = DevicePool(vol, cfg, specs, chunk_timeout_s=0.1)
    got, rep = pool.run_fixed(800, 200, seed=SEED, deadline_s=120)
    assert_same_totals(got, want)
    assert rep.speculative >= 1 and rep.duplicates_discarded >= 1
    assert rep.merged == rep.n_chunks == 4


def test_pool_poison_chunk_quarantine(one_run):
    vol, cfg, _ = one_run
    inj = FaultInjector(poison_chunks=(200,))
    policy = RetryPolicy(max_attempts=3, quarantine_after=50)
    with pytest.raises(ChunkQuarantinedError, match="chunk 200") as ei:
        DevicePool(vol, cfg, [_cpu()], fault_injector=inj,
                   retry_policy=policy).run(800, 200, seed=SEED,
                                            deadline_s=120)
    assert isinstance(ei.value.__cause__, InjectedFault)
    pool = DevicePool(vol, cfg, [_cpu()], fault_injector=inj,
                      retry_policy=policy, raise_on_quarantine=False)
    res, rep = pool.run(800, 200, seed=SEED, deadline_s=120)
    assert [(c.start_id, c.count) for c in rep.quarantined_chunks] == \
        [(200, 200)]
    assert len(rep.chunk_failures[200]) == 3 and rep.merged == 3
    assert int(res.n_launched) == 600  # missing, never silently wrong


@pytest.fixture
def tainted():
    """Workers' processes a test breaks (``_fail_in``), closed after it
    so that no later test meets them."""
    broken = []
    yield broken
    for proc in broken:
        proc.close()


def _fail_in(pool, label, how, error, tainted):
    """Make the round loops in the process of worker ``label`` fail at
    their first photon step as ``how(error)`` makes them fail there."""
    w = next(w for w in pool.workers if w.label == label)
    proc = procs.child(w.device, w.slot)
    tainted.append(proc)
    proc.call(how, error, timeout=60)


def _steps_raise(error):
    """In a worker's process: every photon step raises ``error``."""
    from repro_torch.core import simulator as S

    def step(*args, **kw):
        raise error

    S.photon_steps = step


def _library_fails(error):
    """In a worker's process: the kernel's library cannot be built, and
    every photon step asks for it, as a launch on the card does."""
    from repro_torch.core import simulator as S
    from repro_torch.kernels.photon_step import photon_step as K

    def fail(groups):
        raise error

    K._LIBRARIES.clear()
    K._load_library = fail
    S.photon_steps = lambda *args, **kw: K._library(0)


def test_pool_real_dispatch_error_is_retried_and_surfaced(one_run, tainted):
    """An error in a worker's process that a retry may cure (here a
    RuntimeError, as a lost device raises) is retried up to the policy's
    cap and surfaced as the quarantined chunk's cause."""
    vol, cfg, _ = one_run
    pool = DevicePool(vol, cfg, [_cpu("lost")],
                      retry_policy=RetryPolicy(max_attempts=2))
    _fail_in(pool, "lost", _steps_raise, RuntimeError("device lost"),
             tainted)
    with pytest.raises(ChunkQuarantinedError) as ei:
        pool.run(100, 100, seed=SEED, deadline_s=60)
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert "device lost" in str(ei.value.__cause__)


def _kernel_error(msg):
    from repro_torch.kernels.photon_step.photon_step import KernelError
    return KernelError(msg)


@pytest.mark.parametrize("how,error", [
    (_library_fails, lambda: _kernel_error(
        "nvcc failed (1): injected by the test")),
    (_steps_raise, lambda: _kernel_error(
        "photon_step kernel launch failed: injected by the test (1)")),
    (_steps_raise, lambda: OverflowError(
        "a photon-step launch met a fixed-point deposit or sum beyond "
        "2**63 - 1 units (injected by the test)")),
    (_steps_raise, lambda: ValueError(
        "a photon-step launch got a jac_col outside [0, jac_cols) "
        "(injected by the test)")),
], ids=["build", "launch", "overflow", "jac_col"])
def test_pool_raises_kernel_errors_instead_of_moving_the_work(
        one_run, tainted, how, error):
    """The kernel's build and launch errors and what its launches flag,
    raised in a worker's process, end the run with that process's
    message: a healthy worker beside the failing one must not take its
    chunks (in a fleet of a card and a CPU, that would carry the card's
    work on in the plain version).  The first worker stands in for the
    card, its round loop failing in its process as the kernel would."""
    vol, cfg, _ = one_run
    pool = DevicePool(vol, cfg, [_cpu("card", n_lanes=64), _cpu("cpu")],
                      retry_policy=RetryPolicy(max_attempts=12,
                                               quarantine_after=50))
    _fail_in(pool, "card", how, error(), tainted)
    with pytest.raises((RuntimeError, OverflowError, ValueError),
                       match="injected by the test") as ei:
        pool.run(800, 100, seed=SEED, deadline_s=120)
    assert not isinstance(ei.value, ChunkQuarantinedError)
    assert type(ei.value) is type(error())
    assert "raised in the process of cpu:0" in "".join(ei.value.__notes__)
    assert pool.workers[0].failures == 0  # raised, not retried


def test_a_pickled_kernel_error_ends_a_pool_run_alone(one_run, tainted):
    """A KernelError from the only worker's process: the run ends with
    it, nothing is retried, and no chunk is merged."""
    from repro_torch.kernels.photon_step.photon_step import KernelError
    vol, cfg, _ = one_run
    pool = DevicePool(vol, cfg, [_cpu("card")])
    _fail_in(pool, "card", _steps_raise,
             KernelError("photon_step kernel launch failed: in a child"),
             tainted)
    with pytest.raises(KernelError, match="in a child") as ei:
        pool.run(300, 100, seed=SEED, deadline_s=60)
    pid = procs.child("cpu", 0).pid
    assert pid != os.getpid()
    assert f"pid {pid}" in "".join(ei.value.__notes__)
    assert pool.workers[0].n_merged == 0 and pool.workers[0].failures == 0


def test_a_worker_process_killed_mid_run_fails_its_dispatch(one_run,
                                                            monkeypatch):
    """The process of a worker is killed right after its first chunk is
    sent: the dispatch fails (counted, retried on a new process), no
    chunk is lost, and the totals are one run's bits."""
    vol, cfg, want = one_run
    sent = []
    submit = procs.DeviceProcess.submit

    def kill_first(self, op, work=None, args=()):
        pending = submit(self, op, work, args)
        if op == "sim" and not sent:
            sent.append(self.pid)
            os.kill(self.pid, signal.SIGKILL)
        return pending

    monkeypatch.setattr(procs.DeviceProcess, "submit", kill_first)
    pool = DevicePool(vol, cfg, [_cpu("w")])
    got, rep = pool.run_fixed(800, 200, seed=SEED, deadline_s=120)
    assert_same_totals(got, want)
    assert rep.dispatch_failures == 1 and rep.retries == 1
    assert rep.merged == rep.n_chunks == 4
    assert "ended with exit code -9" in rep.chunk_failures[0][0]
    assert procs.child("cpu", 0).pid not in sent  # a new process


def _as_card(monkeypatch):
    """Worker ``card`` stands for a card: its bit-class is ``cuda``,
    though its process runs on the CPU."""
    monkeypatch.setattr(DeviceSpec, "bit_class", property(
        lambda spec: "cuda" if spec.label == "card" else "cpu"))


def _cuda_error():
    return RuntimeError("CUDA error: an illegal memory access was "
                        "encountered (injected by the test)")


def test_a_cuda_error_in_the_card_worker_ends_the_run_there(
        one_run, tainted, monkeypatch):
    """The CUDA runtime's error in the card worker's process (as an
    asynchronous fault surfaces at the round's host read) ends the run
    as a KernelError, ends that process, and hands none of the card's
    chunks to the CPU worker: not retried, not re-bound."""
    from repro_torch.kernels.photon_step.photon_step import KernelError
    vol, cfg, _ = one_run
    _as_card(monkeypatch)
    rebound = []
    monkeypatch.setattr(DevicePool, "_report_rebound",
                        lambda self, task: rebound.append(task))
    for bind in (True, False):
        pool = DevicePool(vol, cfg, [_cpu("card", n_lanes=64), _cpu("cpu")],
                          bind_classes=bind,
                          retry_policy=RetryPolicy(max_attempts=12,
                                                   quarantine_after=2))
        _fail_in(pool, "card", _steps_raise, _cuda_error(), tainted)
        card = procs.child("cpu", 0)
        with pytest.raises(KernelError, match="illegal memory access"):
            pool.run(800, 100, seed=SEED, deadline_s=120)
        assert not card.alive()  # its context may be broken
        assert pool.workers[0].failures == 0 and not rebound


@pytest.mark.parametrize("lost", ["dropout", "killed"])
def test_a_lost_card_worker_hands_its_chunks_on_only_after_a_dropout(
        one_run, monkeypatch, lost):
    """A card worker and a CPU worker, the chunks bound to the two in
    turn.  A card worker that leaves by a scheduled dropout has its
    chunks re-bound to the CPU (the fleet lost the device).  One whose
    process dies at every chunk is quarantined after its failures, and
    then its chunks stay the card's: the run raises instead of carrying
    the card's work on in the CPU's plain version."""
    vol, cfg, want = one_run
    _as_card(monkeypatch)
    inj = None
    if lost == "dropout":
        inj = FaultInjector(dropout={"card": 0})
    else:
        submit = procs.DeviceProcess.submit

        def kill_card(self, op, work=None, args=()):
            fut = submit(self, op, work, args)
            if op == "sim" and self.slot == 0:
                os.kill(self.pid, signal.SIGKILL)
            return fut

        monkeypatch.setattr(procs.DeviceProcess, "submit", kill_card)
    pool = DevicePool(vol, cfg, [_cpu("card"), _cpu("cpu")],
                      fault_injector=inj,
                      retry_policy=RetryPolicy(max_attempts=12,
                                               quarantine_after=2))
    if lost == "dropout":
        got, rep = pool.run_fixed(800, 100, seed=SEED, deadline_s=120)
        assert_same_totals(got, want)
        assert rep.rebound == 4 and rep.merged == rep.n_chunks == 8
        return
    with pytest.raises(PoolExhaustedError,
                       match="does not move to another device type") as ei:
        pool.run(800, 100, seed=SEED, deadline_s=120)
    assert isinstance(ei.value.__cause__, procs.ChildDied)
    assert pool.workers[0].health == QUARANTINED
    assert pool.workers[1].n_merged <= 4  # its own chunks only


def test_pool_raises_refused_arguments_instead_of_retrying(one_run):
    """A worker whose round loop refuses its arguments (an unknown mode)
    raises at once: another attempt would fail the same way."""
    vol, cfg, _ = one_run
    pool = DevicePool(vol, cfg, [_cpu(mode="definitely-not-real"), _cpu()])
    with pytest.raises(ValueError, match="definitely-not-real"):
        pool.run(100, 100, seed=SEED, deadline_s=60)


def test_pool_exhausted_when_every_worker_drops(one_run):
    vol, cfg, _ = one_run
    pool = DevicePool(vol, cfg, [_cpu("only")],
                      fault_injector=FaultInjector(dropout={"only": 0}))
    with pytest.raises(PoolExhaustedError, match="worker history"):
        pool.run(300, 100, seed=SEED, deadline_s=60)


def test_pool_deadline_bounds_a_run_and_stops_its_chunks(one_run):
    """A run past ``deadline_s`` raises instead of waiting, and the chunk
    still in a worker's process stops at its next round instead of
    holding that process."""
    vol, cfg, _ = one_run
    hung = DevicePool(vol, cfg, [_cpu(throttle_s=30.0)])
    with pytest.raises(TimeoutError, match="deadline_s"):
        hung.run(300, 100, seed=SEED, deadline_s=0.3)
    long = DevicePool(vol, V.b1_config(), [_cpu(n_lanes=64)])
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        long.run(10**6, 10**6, seed=SEED, deadline_s=0.5)
    # the worker's process is free again once its chunk has stopped
    assert procs.child("cpu", 0).call(int, "3", timeout=30) == 3
    assert time.monotonic() - t0 < 30


def test_device_specs_and_default_fleet():
    assert DeviceSpec(device="cpu").bit_class == "cpu"
    assert DeviceSpec().bit_class == "cuda"
    assert DeviceSpec(device="cuda:0", n_lanes=64).bit_class == "cuda"
    vol, cfg = _bench()
    with pytest.raises(ValueError, match="unique"):
        DevicePool(vol, cfg, [_cpu("a"), _cpu("a")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DevicePool(vol, cfg)  # one worker per CUDA device
        with pytest.raises(RuntimeError, match="CUDA"):
            DevicePool(vol, cfg, [DeviceSpec()])


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def test_pool_crash_resume_bit_identity(tmp_path):
    vol, cfg = _bench(collect_stats=True)
    dets = [{"x": 11.0, "y": 8.0, "radius": 4.0}]
    kw = dict(detectors=dets, record_detected=256)
    want = S.simulate(vol, cfg, 600, 512, SEED, device="cpu", **kw)
    ckpt = Checkpointer(str(tmp_path / "ckpt"), keep=3)
    crash = DevicePool(vol, cfg, [_cpu()], **kw,
                       fault_injector=FaultInjector(kill_after_merges=2),
                       checkpointer=ckpt, checkpoint_every=1)
    with pytest.raises(InjectedCrash):
        crash.run(600, 150, seed=SEED, deadline_s=120)
    assert ckpt.latest_step() == 2
    extra = ckpt.manifest()["extra"]
    assert extra["kind"] == "device_pool" and extra["merged"] == 2
    resumed = DevicePool(vol, cfg, [_cpu()], **kw, checkpointer=ckpt,
                         checkpoint_every=1)
    res, rep = resumed.run(600, 150, seed=SEED, resume=True, deadline_s=120)
    assert rep.merged == 4
    assert_same_fields(res, want)
    assert sorted(map(tuple, res.det_rec.tolist())) == sorted(
        map(tuple, want.det_rec[:int(want.det_rec_n)].tolist()))
    for f in ("relaunched", "live_segments", "deposited_w", "escaped_w",
              "timed_out_w", "detected_w"):
        assert getattr(res.stats, f) == getattr(want.stats, f), f
    other = DevicePool(vol, cfg, [_cpu()], **kw, checkpointer=ckpt)
    with pytest.raises(ValueError, match="different campaign"):
        other.run(600, 150, seed=SEED + 1, resume=True)


def test_elastic_round_with_more_chunks_than_devices(one_run):
    """Four chunks over two devices in one round: two queue on each
    device's process, and the totals are one run's bits."""
    vol, cfg, want = one_run
    sim = ElasticSimulator(vol, cfg, 800, 200, n_lanes=LANES, seed=SEED)
    assert sim.run_round(devices=["cpu", "cpu"], max_chunks=4) == 4
    assert not sim.pending
    assert_same_totals(sim.totals(), want)


def test_elastic_requeue_goes_to_the_back_and_caps_attempts():
    vol, cfg = _bench()
    sim = ElasticSimulator(vol, cfg, 600, 150, n_lanes=LANES, seed=SEED,
                           fault_injector=FaultInjector(poison_chunks=(0,)),
                           retry_policy=RetryPolicy(max_attempts=2))
    sim.run_round(devices=["cpu"], max_chunks=1)
    assert [c.start_id for c in sim.pending][-1] == 0
    assert sim.n_retries == 1
    res = sim.run_to_completion(devices=["cpu"])
    assert [c.start_id for c in sim.skipped] == [0]
    assert sim.failures[0] == 2
    assert int(res.n_launched) == 450
    assert len(sim.completed) == 3 and not sim.pending


def test_elastic_kill_restore_bit_identity(tmp_path):
    vol, cfg = _bench(collect_stats=True)
    dets = [{"x": 8.0, "y": 8.0, "radius": 5.0},
            {"x": 4.0, "y": 4.0, "radius": 2.5}]
    kw = dict(n_lanes=LANES, seed=SEED, detectors=dets, record_detected=512)
    want = S.simulate(vol, cfg, 600, 512, SEED, device="cpu", detectors=dets,
                      record_detected=1024)
    ckpt = Checkpointer(str(tmp_path / "ckpt"), keep=3)
    crash = ElasticSimulator(vol, cfg, 600, 150, **kw,
                             fault_injector=FaultInjector(
                                 kill_after_merges=2),
                             checkpointer=ckpt, checkpoint_every=1)
    with pytest.raises(InjectedCrash):
        crash.run_to_completion(devices=["cpu", "cpu"])
    assert ckpt.latest_step() == 2
    assert ckpt.manifest()["extra"]["kind"] == "elastic"
    restored = ElasticSimulator(vol, cfg, 600, 150, **kw)
    _, state = ckpt.restore(restored.state_dict())
    assert state["energy"].dtype == np.int64
    restored.load_state_dict(state)
    assert len(restored.completed) == 2 and len(restored.pending) == 2
    res = restored.run_to_completion(devices=["cpu"])
    assert_same_fields(res, want)
    assert res.det_w.shape == (2, 3) and int(res.det_rec_n) > 0
    assert sorted(map(tuple, res.det_rec.tolist())) == sorted(
        map(tuple, want.det_rec[:int(want.det_rec_n)].tolist()))
    for f in ("relaunched", "deposited_w", "escaped_w", "detected_w"):
        assert getattr(res.stats, f) == getattr(want.stats, f), f
    # a campaign of another seed, photon budget or detector set refuses
    for other in (dict(kw, seed=SEED + 1), dict(kw, detectors=dets[:1])):
        with pytest.raises(ValueError, match="mismatch"):
            ElasticSimulator(vol, cfg, 600, 150, **other).load_state_dict(
                state)


def test_cli_chunk_chaos_drill_resumes_to_the_same_bits(tmp_path, capsys):
    argv = ["--bench", "B1", "--photons", "800", "--size", "16", "--lanes",
            "128", "--steps-per-round", "8", "--time-gates", "3",
            "--tmax-ns", "0.3", "--device", "cpu", "--seed", str(SEED)]
    want = launch.run(argv)
    drill = argv + ["--chunk", "200", "--max-retries", "8",
                    "--deadline-s", "300", "--checkpoint-every", "1",
                    "--checkpoint-dir", str(tmp_path / "ckpt")]
    # chunk 0 is corrupted, chunks 200 and 600 fail, at first attempts
    chaos = {"seed": 1, "p_fail": 0.3, "p_nan": 0.3}
    with pytest.raises(InjectedCrash):
        launch.run(drill + ["--chaos", json.dumps(
            dict(chaos, kill_after_merges=2))])
    got = launch.run(drill + ["--chaos", json.dumps(chaos)])
    out = capsys.readouterr().out
    assert "resuming from checkpoint step 2" in out
    assert "resilience: 4/4 chunks merged" in out
    assert_same_totals(got.totals, want.totals)
    assert_same_fields(got.result, want.result)
