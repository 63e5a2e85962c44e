"""The port's multi-device paths (``repro_torch.core.multidevice``) on
lists of CPU devices, against one ``simulate()`` and against
``repro.core.multidevice``.

The port's own contract is bit-identity: a photon's path depends only
on ``(seed, global id)`` and every total is an int64 fixed-point sum of
deposits each rounded once, so shards over any partition, chunks of any
size at any lane count, in either mode, add up to exactly the int64
totals of one run over the same photons (records equal as a set).  The
same holds for the sharded replay's Jacobian and for ``simulate_many``
over a mesh.  Every comparison here is ``torch.equal`` on the int64
totals or on the converted fields.

Against the JAX package: ``tests/test_torch_multidevice_reference.py``.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import scenarios as SC  # noqa: E402
from repro_torch.core import loadbalance as LB  # noqa: E402
from repro_torch.core import multidevice as M  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402
from repro_torch.launch import simulate as launch  # noqa: E402
from repro_torch.replay import detected_records, replay_jacobian  # noqa: E402

SHAPE = (16, 16, 16)
SEED = 5
SRC = {"type": "pencil", "pos": [8.0, 8.0, 0.0]}
DETS = [{"x": 11.0, "y": 8.0, "radius": 3.0}]
INT64_TOTALS = ("fluence", "exitance", "det_w", "det_ppath", "escaped",
                "timed_out", "launched_w", "n_launched")
FIELDS = ("energy", "exitance", "escaped_w", "timed_out_w", "det_w",
          "det_ppath", "launched_w", "n_launched", "det_rec_overflow")
CPU4 = ["cpu"] * 4


def _gated(**kw):
    """B1 with 3 gates over 0.3 ns: photons live ~130 segments."""
    return dataclasses.replace(V.b1_config(), steps_per_round=8,
                               n_time_gates=3, tmax_ns=0.3, **kw)


def assert_same_totals(got, want):
    for f in INT64_TOTALS:
        a, b = getattr(got, f).cpu(), getattr(want, f).cpu()
        assert a.dtype == b.dtype == torch.int64 and torch.equal(a, b), f


def assert_same_fields(got, want):
    for f in FIELDS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()), f


def rows(rec):
    return sorted(map(tuple, np.asarray(rec).tolist()))


@pytest.fixture(scope="module")
def gated_run():
    """One simulate() of 1200 photons with gates, a detector and records,
    its int64 totals and result."""
    vol, cfg = V.benchmark_b1(SHAPE), _gated()
    kw = dict(source=SRC, detectors=DETS, record_detected=2048)
    fixed = S.simulate_fixed(vol, cfg, 1200, 512, SEED, device="cpu", **kw)
    return vol, cfg, kw, fixed, S.to_sim_result(fixed)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_uneven_shards_are_bit_identical_to_one_run(gated_run, mode):
    vol, cfg, kw, fixed, _ = gated_run
    # static mode runs n / lanes photons a lane one after another: one
    # each here
    one = fixed if mode == "dynamic" else S.simulate_fixed(
        vol, cfg, 1200, 1200, SEED, device="cpu", mode=mode, **kw)
    part = [600, 300, 225, 75]
    kw = dict(kw, record_detected=512)
    parts = M.sharded_sim_fn(vol, cfg, [600, 300, 256, 128], CPU4, mode,
                             **kw)(part, M.shard_offsets(part), SEED)
    merged = S.merge_fixed(parts)
    assert_same_totals(merged, one)
    res = S.to_sim_result(merged)
    assert_same_fields(res, S.to_sim_result(one))
    # the reference's sharded layout: per-shard steps and record counts,
    # the shards' buffers concatenated
    assert res.steps.shape == (4,) and res.det_rec_n.shape == (4,)
    assert res.det_rec.shape == (4 * 512, 4)
    assert rows(detected_records(res)) == rows(detected_records(
        S.to_sim_result(one)))
    assert int(res.n_launched) == 1200


def test_equal_split_and_partition_checks(gated_run):
    vol, cfg, kw, fixed, ref = gated_run
    res = M.simulate_sharded(vol, cfg, 1200, ["cpu"] * 3, n_lanes=512,
                             seed=SEED, **kw)
    assert_same_fields(res, ref)
    assert M.shard_counts(10, 4) == [3, 3, 2, 2]
    assert M.shard_offsets([3, 3, 2], 2**32 - 4) == [
        2**32 - 4, 2**32 - 1, 2**32 + 2]
    for bad in ([500, 500], [1200, 0, 1], [-1, 1201]):
        with pytest.raises(ValueError, match="partition"):
            M.shard_counts(1200, len(bad), bad)
    with pytest.raises(ValueError, match="partition"):
        M.simulate_sharded(vol, cfg, 1200, ["cpu"] * 2, partition=[1200])
    with pytest.raises(ValueError, match="one a shard"):
        M.sharded_sim_fn(vol, cfg, [64, 64], CPU4)
    with pytest.raises(ValueError, match="at least one device"):
        M.simulate_sharded(vol, cfg, 10, [])


def test_sharded_collect_stats_totals(gated_run):
    vol, _, _, _, ref = gated_run
    cfg = _gated(collect_stats=True)
    one = S.simulate(vol, cfg, 1200, 512, SEED, source=SRC, device="cpu",
                     detectors=DETS)
    on = M.simulate_sharded(vol, cfg, 1200, ["cpu"] * 2, n_lanes=512,
                            seed=SEED, source=SRC, detectors=DETS)
    assert ref.stats is None and on.stats is not None
    assert_same_fields(on, ref)  # counting changes no physics bit
    assert_same_fields(on, one)
    st, st1 = on.stats, one.stats
    # the weights come from the merged totals: the single run's bits
    for f in ("deposited_w", "escaped_w", "timed_out_w", "detected_w"):
        assert getattr(st, f) == getattr(st1, f), f
    assert int(st.relaunched) == int(on.n_launched) == 1200
    # rounds and lane-segments add over the shards
    assert int(st.rounds) == int(on.steps.sum()) // cfg.steps_per_round
    assert float(st.lane_segments) == float(on.steps.sum()) * 512
    assert 0.0 < st.lane_occupancy() <= 1.0


def test_lanes_mode_and_chunking_change_no_bit(gated_run):
    """A chunk at 256 lanes against one at 1024, dynamic against static,
    and two chunks against one: the same int64 totals."""
    vol, cfg, _, _, _ = gated_run
    run = lambda n, lanes, mode="dynamic", off=0: S.simulate_fixed(  # noqa
        vol, cfg, n, lanes, SEED, source=SRC, mode=mode, device="cpu",
        id_offset=off)
    a = run(600, 256)
    assert_same_totals(run(600, 1024), a)
    assert_same_totals(run(600, 256, "static"), a)
    assert_same_totals(S.merge_fixed([run(350, 64), run(250, 512, off=350)]),
                       a)


def test_chunk_scheduler_with_gates_detectors_and_records(gated_run):
    vol, cfg, kw, fixed, ref = gated_run
    kw = dict(kw, record_detected=512)
    sched = M.ChunkScheduler(vol, cfg, n_lanes=256, devices=["cpu", "cpu"],
                             **kw)
    totals, stats = sched.run_fixed(1200, 350, seed=SEED)
    assert_same_totals(totals, fixed)
    got = S.to_sim_result(totals)
    assert_same_fields(got, ref)
    assert sum(stats.values()) == 1200 and list(stats) == ["cpu:0"]
    assert rows(detected_records(got)) == rows(detected_records(ref))
    rep = sched.last_report
    assert rep.merged == rep.n_chunks == 4 and rep.retries == 0


def test_sharded_replay_is_bit_identical(gated_run):
    vol, cfg, _, _, ref = gated_run
    rec = detected_records(ref)[:90]
    assert rec.shape[0] == 90
    one = replay_jacobian(vol, cfg, rec, DETS, source=SRC, seed=SEED,
                          n_lanes=64, device="cpu", gate_resolved=True)
    # three devices, 30 lanes each: the lane cap ceil(90 / 3)
    mesh = replay_jacobian(vol, cfg, rec, DETS, source=SRC, seed=SEED,
                           n_lanes=64, mesh=["cpu"] * 3, gate_resolved=True)
    for name, a, b in zip(one._fields, one, mesh):
        assert np.array_equal(a, b), name
    assert (mesh.replayed_det == mesh.det).all()
    assert (mesh.gate == rec[:, 3].astype(np.int32)).all()
    assert mesh.jacobian.sum() > 0


def test_simulate_many_over_a_mesh_is_bit_identical():
    vol = V.benchmark_b1(SHAPE)
    fleet = [SC.Scenario(vol, _gated(), 100 + 50 * i, seed=3,
                         source={"type": "disk", "pos": [5.0 + i, 8.0, 0.0],
                                 "radius": 2.0},
                         detectors=DETS, id_offset=i * 300)
             for i in range(3)]
    fleet.append(SC.Scenario(vol, _gated(), 150, seed=4))  # another group
    cache = SC.CompileCache()
    many = SC.simulate_many(fleet, n_lanes=64, mesh=["cpu", "cpu"],
                            cache=cache)
    again = SC.simulate_many(fleet, n_lanes=64, mesh=["cpu", "cpu"],
                             cache=cache)
    assert cache.hits == 2 and cache.misses == 2
    # the mesh's device list is part of the cache key
    assert {key[3] for key in cache._entries} == {("cpu:0", "cpu:0")}
    for sc, got, rerun in zip(fleet, many, again):
        want = SC.simulate_one(sc, n_lanes=64, device="cpu")
        for name, x, y, z in zip(got._fields, got, want, rerun):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y) and torch.equal(x, z), name
            else:
                assert x == y == z, name


def test_detected_records_takes_the_sharded_layout():
    rec = torch.arange(6 * 4, dtype=torch.int64).view(6, 4)
    res = S.SimResult(energy=None, exitance=None, escaped_w=None,
                      n_launched=None, launched_w=None, steps=0,
                      det_rec=rec, det_rec_n=torch.tensor([2, 0, 1]))
    got = detected_records(res)
    assert got.dtype == np.uint32
    assert got.tolist() == [rec[0].tolist(), rec[1].tolist(),
                            rec[4].tolist()]
    with pytest.raises(ValueError, match="does not split"):
        detected_records(res._replace(det_rec_n=torch.tensor([1, 1, 1, 1])))
    one = res._replace(det_rec_n=torch.tensor(3))
    assert detected_records(one).tolist() == rec[:3].tolist()


def test_merge_fixed_checks_the_range(gated_run):
    _, _, _, fixed, _ = gated_run
    big = fixed._replace(escaped=torch.tensor(2**62))
    with pytest.raises(OverflowError):
        S.merge_fixed([big, big])
    with pytest.raises(ValueError):
        S.merge_fixed([])


def _raise_key_error(after_s):
    """A job that fails in its device's process after ``after_s``."""
    import time
    time.sleep(after_s)
    raise KeyError("shard failed")


def test_a_failing_shard_cancels_the_others():
    """Two devices' processes: one runs a round loop of 10^9 photons, the
    other fails; the failure crosses back and is raised, and the long
    run stops at its next round's host read (through its process's
    cancel slot) instead of running to its end."""
    from repro_torch.core import procs
    vol = V.benchmark_b1(SHAPE)
    work = procs.sim_work(vol, V.b1_config(), 64, source=SRC)
    cpu = torch.device("cpu")
    t0 = __import__("time").monotonic()
    with pytest.raises(KeyError, match="shard failed") as ei:
        procs.run_all([procs.Job(cpu, 0, "sim", work, (10**9, SEED, 0)),
                       procs.Job(cpu, 1, "call", None,
                                 (_raise_key_error, (1.0,)))])
    assert __import__("time").monotonic() - t0 < 60
    assert "raised in the process of cpu" in "".join(ei.value.__notes__)
    # the long run's process is free again: it answers at once
    assert procs.child(cpu, 0).call(int, "7", timeout=60) == 7
    # one job runs in the calling process
    (one,) = procs.run_all([procs.Job(cpu, 0, "call", None, (os.getpid, ()))])
    assert one.value == os.getpid()
    # a cancelled round loop stops at its next round
    fn = S.build_fixed_fn(SHAPE, 1.0, V.b1_config(), 64, device="cpu")
    cancel = threading.Event()
    cancel.set()
    with pytest.raises(S.RunCancelled):
        fn(vol.labels.reshape(-1), vol.media, 100, SEED, cancel=cancel)


def test_launch_counts_survive_many_threads():
    """More threads than cores add to the kernel's launch counts at
    once, with the interpreter switching threads as often as it can: no
    add is lost."""
    import sys
    from repro_torch.kernels.photon_step import photon_step as K
    saved, interval = K.photon_step_cuda.launches_by, sys.getswitchinterval()
    K.reset_launches()
    n_threads, n_adds = 4 * (os.cpu_count() or 1), 2000
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=lambda i=i: [
            K.count_launch(f"v{i % 3}") for _ in range(n_adds)])
            for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert sum(K.photon_step_cuda.launches_by.values()) == \
            n_threads * n_adds
    finally:
        sys.setswitchinterval(interval)
        K.photon_step_cuda.launches_by = saved


def _count_launches(key, n):
    from repro_torch.kernels.photon_step import photon_step as K
    for _ in range(n):
        K.count_launch(key)
    return os.getpid()


def test_launch_counts_come_back_from_every_process():
    """Each of four device processes adds to its own launch counts; the
    replies carry them back and the calling process adds them all: no
    launch is lost and none is counted twice."""
    from repro_torch.core import procs
    from repro_torch.kernels.photon_step import photon_step as K
    saved = K.photon_step_cuda.launches_by
    K.reset_launches()
    n_adds = 2000
    try:
        replies = procs.run_all([
            procs.Job(torch.device("cpu"), i, "call", None,
                      (_count_launches, (f"v{i % 3}", n_adds)))
            for i in range(4)])
        assert len({r.value for r in replies} | {os.getpid()}) == 5
        assert [sum(r.launches.values()) for r in replies] == [n_adds] * 4
        assert K.photon_step_cuda.launches_by == {
            "v0": 2 * n_adds, "v1": n_adds, "v2": n_adds}
    finally:
        K.photon_step_cuda.launches_by = saved


def test_heterogeneous_partition_uses_the_paper_strategies():
    models = [LB.DeviceModel("gpu", a=1e-6, t0=0.1, cores=132),
              LB.DeviceModel("cpu", a=5e-5, t0=0.0, cores=8)]
    for strategy, fn in LB.PARTITIONERS.items():
        got = M.heterogeneous_partition(100_000, models, strategy)
        assert got == fn(100_000, models) and sum(got) == 100_000


def test_cli_devices_all_shards_forward_replay_and_scenarios(monkeypatch,
                                                             capsys):
    argv = ["--bench", "B1", "--photons", "600", "--size", "16",
            "--lanes", "256", "--steps-per-round", "8", "--device", "cpu",
            "--time-gates", "3", "--tmax-ns", "0.3", "--detectors",
            json.dumps(DETS), "--save-detected", "1024", "--replay",
            "--seed", str(SEED)]
    one = launch.run(argv + ["--devices", "all"])  # one CPU: one device
    assert one.result.det_rec_n.ndim == 0
    monkeypatch.setattr(launch, "visible_devices",
                        lambda kind: [__import__("torch").device(kind)] * 3)
    many = launch.run(argv + ["--devices", "all"])
    assert "over 3 devices" in capsys.readouterr().out
    assert many.result.det_rec_n.shape == (3,)
    assert_same_fields(many.result, one.result)
    assert_same_totals(many.totals, one.totals)
    for name, a, b in zip(one.replay._fields, one.replay, many.replay):
        assert np.array_equal(a, b), name
    entries = [{"bench": "B1", "size": 16, "photons": 100, "seed": s,
                "time_gates": 3, "tmax_ns": 0.3, "steps_per_round": 8}
               for s in (1, 2, 3)]
    got = launch.main(["--scenarios", json.dumps(entries), "--lanes", "64",
                       "--device", "cpu", "--devices", "all"])
    want = [SC.simulate_one(SC.Scenario.from_dict(e), n_lanes=64,
                            device="cpu") for e in entries]
    for a, b in zip(got, want):
        assert_same_fields(a, b)


@pytest.mark.parametrize("argv,message", [
    (["--chaos", "{}"], "--chaos requires --chunk"),
    (["--deadline-s", "1"], "--deadline-s requires --chunk"),
    (["--max-retries", "2"], "--max-retries requires --chunk"),
    (["--chunk-timeout-s", "1"], "--chunk-timeout-s requires --chunk"),
    (["--chunk", "100", "--checkpoint-every", "2"],
     "--checkpoint-every requires --chunk and --checkpoint-dir"),
    (["--chunk", "100", "--scenarios", "[]"],
     "--scenarios is incompatible with --chunk"),
])
def test_cli_checks_the_chunk_flags(argv, message, capsys):
    with pytest.raises(SystemExit):
        launch.run(["--device", "cpu"] + argv)
    assert message in capsys.readouterr().err


def test_entry_points_need_cuda_unless_asked_for_the_cpu(gated_run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    vol, cfg, _, _, _ = gated_run
    for call in (lambda: M.ChunkScheduler(vol, cfg),
                 lambda: M.ElasticSimulator(vol, cfg, 100, 50).run_round(),
                 lambda: M.simulate_sharded(vol, cfg, 100, [None, "cpu"]),
                 lambda: replay_jacobian(vol, cfg, np.zeros((0, 4)), DETS)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
