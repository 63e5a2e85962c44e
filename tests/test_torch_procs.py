"""The device processes of the port's multi-device paths
(``repro_torch.core.procs``), on CPU children.

Every device of a multi-device run has a spawned process of its own,
kept in a registry by ``(device, slot)`` and reused; work crosses as a
picklable description, results as CPU values, errors pickled with the
child's traceback.  The paths themselves (shards, replay, schedulers,
pool, scenario mesh) are held to one run's bits in
``test_torch_multidevice.py``, ``test_torch_resilience.py`` and
``test_torch_scenarios.py``.
"""

import os
import pathlib
import signal
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import procs  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def fresh():
    """Processes a test changes, closed after it."""
    changed = []
    yield changed
    for proc in changed:
        proc.close()


def _pid():
    return os.getpid()


def test_a_mesh_has_a_process_a_device_none_of_them_this_one():
    replies = procs.run_all([procs.Job(CPU, s, "call", None, (_pid, ()))
                             for s in range(3)])
    pids = [r.value for r in replies]
    assert len(set(pids)) == 3 and os.getpid() not in pids
    assert [r.pid for r in replies] == pids
    live = procs.children()
    assert {live[("cpu:0", s)].pid for s in range(3)} == set(pids)
    # the registry reuses them
    again = procs.run_all([procs.Job(CPU, s, "call", None, (_pid, ()))
                           for s in range(3)])
    assert [r.value for r in again] == pids


def _echo(x):
    time.sleep(0.2)
    return x


def test_several_requests_to_one_process_come_back_in_order():
    """An elastic round with more chunks than devices queues several
    requests on one process."""
    jobs = [procs.Job(CPU, s, "call", None, (_echo, (i,)))
            for i, s in enumerate((0, 1, 0, 1, 0))]
    assert [r.value for r in procs.run_all(jobs, timeout=60)] == \
        [0, 1, 2, 3, 4]


def test_a_killed_process_fails_its_request_and_is_replaced(fresh):
    proc = procs.child(CPU, 5)
    pid = proc.call(_pid, timeout=60)
    pending = proc.submit("call", None, (time.sleep, (30,)))
    os.kill(pid, signal.SIGKILL)
    with pytest.raises(procs.ChildDied, match="exit code -9"):
        procs.result(pending, timeout=60)
    assert not proc.alive()
    with pytest.raises(procs.ChildDied):
        proc.call(_pid)
    new = procs.child(CPU, 5)
    fresh.append(new)
    assert new is not proc and new.call(_pid, timeout=60) not in (pid, None)


class _Unpicklable(Exception):
    def __init__(self, a, b):
        super().__init__(a)
        self.b = lambda: b


def _raise_unpicklable():
    raise _Unpicklable("kept as text", 2)


def test_errors_cross_with_their_type_and_the_childs_traceback():
    proc = procs.child(CPU, 0)
    with pytest.raises(ZeroDivisionError) as ei:
        proc.call(divmod, 1, 0, timeout=60)
    note = "".join(ei.value.__notes__)
    assert f"pid {proc.pid}" in note and "ZeroDivisionError" in note
    with pytest.raises(RuntimeError, match="_Unpicklable: kept as text"):
        proc.call(_raise_unpicklable, timeout=60)


def _unpicklable_value():
    return lambda: 1


def test_a_reply_that_does_not_pickle_is_an_error_and_the_process_lives():
    proc = procs.child(CPU, 0)
    with pytest.raises(RuntimeError, match="could not send its reply"):
        proc.call(_unpicklable_value, timeout=60)
    assert proc.call(_pid, timeout=60) == proc.pid


def test_work_descriptions_and_their_keys():
    vol = V.benchmark_b1((8, 8, 8))
    cfg = V.b1_config()
    a = procs.sim_work(vol, cfg, 64)
    assert a.key == procs.sim_work(vol, cfg, 64).key
    others = [procs.sim_work(vol, cfg, 32),
              procs.sim_work(vol, cfg, 64, "static"),
              procs.sim_work(vol, cfg, 64, source={"type": "disk",
                                                   "pos": [4, 4, 0],
                                                   "radius": 1}),
              procs.sim_work(V.benchmark_b2((8, 8, 8)), cfg, 64)]
    assert len({a.key} | {w.key for w in others}) == 5
    assert a.arrays["labels"].dtype.name == "uint8"


def test_one_request_runs_in_this_process_and_matches_a_child():
    vol = V.benchmark_b1((8, 8, 8))
    cfg = V.b1_config()
    work = procs.sim_work(vol, cfg, 32)
    (here,) = procs.run_all([procs.Job(CPU, 0, "sim", work, (200, 3, 0))])
    there = procs.reply(procs.child(CPU, 0).submit("sim", work, (200, 3, 0)),
                        60)
    assert here.pid == os.getpid() and there.pid != os.getpid()
    want = S.simulate_fixed(vol, cfg, 200, 32, 3, device="cpu")
    for f in ("fluence", "exitance", "escaped", "launched_w", "n_launched"):
        assert torch.equal(getattr(here.value, f), getattr(want, f)), f
        assert torch.equal(getattr(there.value, f), getattr(want, f)), f
    assert there.wall_s > 0 and there.device_s == there.wall_s


def _threads():
    return torch.get_num_threads()


def test_slots_and_cpu_threads():
    """A CPU process runs on one intra-op thread, and its reply says
    the threads it ran on."""
    cuda = torch.device("cuda", 0)
    assert procs.slots([CPU, cuda, CPU, "cpu", cuda]) == [0, 0, 1, 2, 1]
    got = procs.reply(procs.child(CPU, 0).submit("call", None,
                                                 (_threads, ())), 60)
    assert got.value == got.threads == 1


def test_a_cpu_child_runs_on_the_cores_its_run_leaves():
    """A request of a run sets a CPU child's threads: its cores less one
    for each card process of the run, shared among the run's CPU
    processes, at least one; the reply says the threads it ran on."""
    cores = len(os.sched_getaffinity(0))
    assert procs.run_types([CPU, "cuda:1", "cpu"]) == ("cpu", "cuda", "cpu")
    assert procs.cpu_threads(("cuda", "cpu")) == max(1, cores - 1)
    assert procs.cpu_threads(("cpu", "cpu", "cuda")) == max(
        1, (cores - 1) // 2)
    assert procs.cpu_threads(("cuda",) * (cores + 2) + ("cpu",)) == 1
    proc = procs.child(CPU, 0)
    try:
        proc.run = ("cuda", "cpu")
        got = procs.reply(proc.submit("call", None, (_threads, ())), 60)
        assert got.value == got.threads == max(1, cores - 1)
    finally:
        proc.run = ()
        proc.call(torch.set_num_threads, 1, timeout=60)


def _big(n):
    return np.zeros(n, np.uint8)


def test_an_abandoned_reply_does_not_block_the_next_request():
    """A request that finished but was abandoned leaves a reply of a few
    MB that nobody reads; the next request to that process carries a
    few MB too.  Neither side waits on the other's pipe."""
    proc = procs.child(CPU, 0)
    done = proc.submit("call", None, (_big, (16 << 20,)))
    while not done.done():
        time.sleep(0.05)
    procs.abandon(done)
    big = np.arange(4 << 20, dtype=np.int64)
    got = proc.call(np.sum, big, timeout=60)
    assert int(got) == int(big.sum())


def _cuda_fails():
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered (injected by the test)")


def test_a_cuda_error_in_a_child_is_a_kernel_error_and_ends_it(fresh):
    """The CUDA runtime's own error in a child comes back as a
    KernelError, which no scheduler retries, and the process is closed:
    its context may be broken."""
    from repro_torch.kernels.photon_step.photon_step import KernelError

    proc = procs.child(CPU, 4)
    fresh.append(proc)
    pid = proc.pid
    with pytest.raises(KernelError, match="illegal memory access") as ei:
        proc.call(_cuda_fails, timeout=60)
    assert f"pid {pid}" in str(ei.value)
    assert not proc.alive()
    new = procs.child(CPU, 4)
    fresh.append(new)
    assert new.call(_pid, timeout=60) != pid


STAND_IN = """#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(f"start {{os.getpid()}}\\n")
time.sleep(1.0)
with open(out, "w") as f:
    f.write("library")
with open({log!r}, "a") as f:
    f.write(f"end {{os.getpid()}}\\n")
"""


def _build_with(build_dir, nvcc):
    from repro_torch.kernels.photon_step import photon_step as K

    K.BUILD_DIR = pathlib.Path(build_dir)
    K._nvcc = lambda: nvcc
    return str(K.build_library(0))


def test_two_processes_building_one_library_take_turns(tmp_path, fresh):
    """Two processes ask for one group mask's library at once, with a
    stand-in for nvcc that takes a second: the file lock lets one build
    it while the other waits, then finds it built."""
    log = tmp_path / "builds.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(STAND_IN.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    for slot in (6, 7):
        fresh.append(procs.child(CPU, slot))
    replies = procs.run_all([
        procs.Job(CPU, slot, "call", None, (_build_with, (build, str(nvcc))))
        for slot in (6, 7)], timeout=120)
    paths = {r.value for r in replies}
    assert len(paths) == 1 and pathlib.Path(paths.pop()).read_text() == \
        "library"
    events = log.read_text().split()
    assert events[0::2] == ["start", "end"]  # one build, whole
    assert (build / "build.lock").exists()
    assert not list(build.glob("*.tmp"))
