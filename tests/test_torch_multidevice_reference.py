"""The port's sharded and chunked runs against ``repro.core.multidevice``.

The reference runs in a subprocess with four fake XLA devices, as
``tests/test_multidevice.py`` runs it: its ``simulate_sharded`` and
``ChunkScheduler`` against the port's on the same partition and chunks.
``n_launched`` and ``launched_w`` are exact; absorbed, escaped and
timed-out weight within 2e-3 of the launched weight
(``tests/test_torch_simulator.py``).  Across the packages trajectories
diverge under XLA's FMA contraction (``tests/test_torch_detection.py``),
and a diverged photon is an independent draw, so cells are compared by
depth: the deposited weight of every depth slab within 1e-3 of the
launched weight, as in ``tests/test_torch_scenarios.py``.  Cell by cell
the two packages' single runs differ by 1.0e-5 to 1.7e-3 of the largest
cell here (seeds 1-5), so the 1e-3 of the largest cell that the
reference holds its own shards to (they only reorder float sums) does
not hold across the packages.  Each package's sharded and chunked
records are its own single run's set exactly; across the packages the
record counts are held within 5% of each other, as in
``tests/test_torch_detection.py``.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import multidevice as M  # noqa: E402
from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core import volume as V  # noqa: E402
from repro_torch.replay import detected_records  # noqa: E402

SHAPE = (16, 16, 16)
SEED = 5
SRC = {"type": "pencil", "pos": [8.0, 8.0, 0.0]}
DETS = [{"x": 11.0, "y": 8.0, "radius": 3.0}]
FIELDS = ("energy", "exitance", "escaped_w", "timed_out_w", "det_w",
          "det_ppath", "launched_w", "n_launched", "det_rec_overflow")


def assert_same_fields(got, want):
    for f in FIELDS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()), f


def rows(rec):
    return sorted(map(tuple, np.asarray(rec).tolist()))


_PARTITION = [500, 350, 250, 100]
_CHUNK = 400

_REFERENCE = """
import sys, dataclasses
import jax, numpy as np
from repro.core import volume as V, simulator as S
from repro.core.multidevice import simulate_sharded, ChunkScheduler
from repro.replay import detected_records
vol = V.benchmark_b1((16, 16, 16))
cfg = dataclasses.replace(V.b1_config(), steps_per_round=8, n_time_gates=3,
                          tmax_ns=0.3)
kw = dict(source={"type": "pencil", "pos": (8.0, 8.0, 0.0)},
          detectors=({"x": 11.0, "y": 8.0, "radius": 3.0},))
mesh = jax.make_mesh((4,), ("data",))
assert len(jax.devices()) == 4
one = S.simulate(vol, cfg, 1200, 512, 5, record_detected=2048, **kw)
sh = simulate_sharded(vol, cfg, 1200, mesh, partition=%s, n_lanes=128,
                      seed=5, record_detected=512, **kw)
ch, _ = ChunkScheduler(vol, cfg, n_lanes=128, record_detected=512,
                       **kw).run(1200, %d, seed=5)
out = {}
for name, r in (("one", one), ("sharded", sh), ("chunked", ch)):
    for f in ("energy", "escaped_w", "timed_out_w", "launched_w",
              "n_launched"):
        out[name + "/" + f] = np.asarray(getattr(r, f))
    out[name + "/records"] = detected_records(r)
np.savez(sys.argv[1], **out)
""" % (_PARTITION, _CHUNK)


def _depth_profile(energy) -> np.ndarray:
    """Deposited weight by depth: summed over x, y and the gates."""
    e = np.asarray(energy, np.float64)
    return e.reshape(e.shape[0], e.shape[1], e.shape[2], -1).sum(
        axis=(0, 1, 3))


def test_sharded_and_chunked_runs_match_the_reference(tmp_path):
    path = tmp_path / "reference.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    ref = np.load(path)

    vol = V.benchmark_b1(SHAPE)
    cfg = dataclasses.replace(V.b1_config(), steps_per_round=8,
                              n_time_gates=3, tmax_ns=0.3)
    kw = dict(source=SRC, detectors=DETS, record_detected=512)
    one = S.simulate(vol, cfg, 1200, 512, SEED, device="cpu",
                     **dict(kw, record_detected=2048))
    ours = {
        "sharded": M.simulate_sharded(vol, cfg, 1200, ["cpu"] * 4,
                                      partition=_PARTITION, n_lanes=128,
                                      seed=SEED, **kw),
        "chunked": M.ChunkScheduler(vol, cfg, n_lanes=256,
                                    devices=["cpu", "cpu"], **kw).run(
                                        1200, _CHUNK, seed=SEED)[0]}
    launched = float(ref["one/launched_w"])
    assert launched == 1200.0
    # each package: its sharded and chunked runs have its single run's
    # records (the port: every bit, above)
    for name in ours:
        assert rows(ref[name + "/records"]) == rows(ref["one/records"])
    for name, got in ours.items():
        assert_same_fields(got, one)
        assert rows(detected_records(got)) == rows(detected_records(one))
        assert int(got.n_launched) == int(ref[name + "/n_launched"]) == 1200
        assert float(got.launched_w) == float(ref[name + "/launched_w"])
        for f in ("escaped_w", "timed_out_w"):
            assert abs(float(getattr(got, f)) - float(ref[name + "/" + f])) \
                <= 2e-3 * launched, (name, f)
        want_profile = _depth_profile(ref[name + "/energy"])
        assert abs(float(got.energy.double().sum()) - want_profile.sum()) \
            <= 2e-3 * launched, name
        assert np.abs(_depth_profile(got.energy) - want_profile).max() \
            <= 1e-3 * launched, name
        n_ref = ref[name + "/records"].shape[0]
        assert abs(int(detected_records(got).shape[0]) - n_ref) <= \
            0.05 * n_ref, name
