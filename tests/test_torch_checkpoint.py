"""The port's ``Checkpointer`` (``repro_torch.checkpoint``).

Atomic saves (a temp file and a rename), keep-N garbage collection, a
manifest per checkpoint, ``latest_step`` counting only complete ones,
and ``restore`` into a template's structure: nested dicts, lists,
tuples and NamedTuples of torch tensors (returned as tensors of their
dtype), numpy arrays and numbers.  The file layout is the reference's:
a checkpoint written by either package restores through the other, for
a dict of numpy arrays and for NamedTuple leaves (``.field`` keys).
The resilience layer checkpoints int64 totals, which come back
bit-equal.
"""

import collections
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint.checkpointer import _flatten_to_arrays  # noqa: E402

Pair = collections.namedtuple("Pair", "lo hi")


def _state(k=0):
    return {
        "energy": torch.arange(24, dtype=torch.int64).view(2, 3, 4) + k,
        "weights": np.linspace(0.0, 1.0, 5, dtype=np.float32) * (k + 1),
        "counts": [np.int64(k), torch.tensor([1, 2, 3], dtype=torch.int32)],
        "ids": Pair(lo=np.uint32(7 + k), hi=np.uint32(k)),
        "nested": {"b": np.ones((2, 2), np.float64), "a": np.bool_(True)},
        "skipped": None,
        "key": np.frombuffer(b'{"seed": 5}', np.uint8),
    }


def _assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif a is None:
        assert b is None
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_round_trip_keeps_structure_dtypes_and_bits(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _state()
    ck.save(3, state, extra={"kind": "test", "merged": 3})
    step, got = ck.restore(_state(9))
    assert step == 3
    _assert_same(got, state)
    assert ck.manifest()["extra"] == {"kind": "test", "merged": 3}
    assert ck.manifest()["keys"] == sorted(_flatten_to_arrays(state))
    # the reference's leaf keys: sorted dict keys, indices, ".field"
    assert sorted(_flatten_to_arrays(state)) == [
        "counts/0", "counts/1", "energy", "ids/.hi", "ids/.lo", "key",
        "nested/a", "nested/b", "weights"]


def test_keep_n_latest_and_complete_checkpoints_only(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    with pytest.raises(FileNotFoundError):
        ck.restore(_state())
    assert ck.latest_step() is None
    for step in (1, 2, 5):
        ck.save(step, _state(step))
    assert ck.steps() == [2, 5] and ck.latest_step() == 5
    _assert_same(ck.restore(_state())[1], _state(5))
    _assert_same(ck.restore(_state(), step=2)[1], _state(2))
    # a checkpoint whose manifest never landed is not counted
    os.unlink(tmp_path / "step_0000000005.npz.manifest.json")
    assert ck.latest_step() == 2
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_unsupported_dtype_is_stored_as_float32(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.tensor([1.5, 2.25], dtype=torch.bfloat16)})
    _, got = ck.restore({"x": torch.zeros(2, dtype=torch.bfloat16)})
    assert got["x"].dtype == torch.bfloat16
    assert got["x"].tolist() == [1.5, 2.25]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_restore_across_the_packages(tmp_path, writer):
    state = {"energy": np.arange(24, dtype=np.int64).reshape(2, 3, 4),
             "escaped_w": np.float64(12.5),
             "pending": np.asarray([[0, 100], [100, 50]], np.int64),
             "run_key": np.frombuffer(b'{"n": 150}', np.uint8),
             "ids": Pair(lo=np.uint32(3), hi=np.uint32(1))}
    template = {k: (Pair(np.uint32(0), np.uint32(0)) if k == "ids"
                    else np.zeros_like(v)) for k, v in state.items()}
    write, read = ((Checkpointer, JaxCheckpointer) if writer == "port"
                   else (JaxCheckpointer, Checkpointer))
    write(str(tmp_path)).save(4, state, extra={"kind": "elastic"})
    reader = read(str(tmp_path))
    assert reader.latest_step() == 4
    assert reader.manifest()["extra"] == {"kind": "elastic"}
    step, got = reader.restore(template)
    assert step == 4
    for k, v in state.items():
        _assert_same(tuple(got[k]) if k == "ids" else got[k],
                     tuple(v) if k == "ids" else v)


def test_campaign_state_is_int64(tmp_path):
    """The pool's and the elastic simulator's checkpoints hold their
    totals as int64 fixed point, and restore them bit for bit."""
    from repro_torch.core import volume as V
    from repro_torch.core.multidevice import ElasticSimulator
    vol = V.benchmark_b1((16, 16, 16))
    es = ElasticSimulator(vol, V.b1_config(), 300, 100, n_lanes=64)
    es.acc.fluence[0, 0, 0] = 2**62 + 1  # beyond float64's 53 bits
    es.acc = es.acc._replace(escaped=torch.tensor(2**60 + 3))
    state = es.state_dict()
    for k in ("energy", "exitance", "det_w", "det_ppath", "escaped_w",
              "timed_out_w", "launched_w", "n_launched"):
        assert np.asarray(state[k]).dtype == np.int64, k
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    _, got = ck.restore(ElasticSimulator(
        vol, V.b1_config(), 300, 100, n_lanes=64).state_dict())
    restored = ElasticSimulator(vol, V.b1_config(), 300, 100, n_lanes=64)
    restored.load_state_dict(got)
    assert int(restored.acc.fluence[0, 0, 0]) == 2**62 + 1
    assert int(restored.acc.escaped) == 2**60 + 3
    assert [c.start_id for c in restored.pending] == [0, 100, 200]

    # an accumulator holding a harvest with records and round counters:
    # its checkpoint leaves bring back every field, bit for bit
    import dataclasses

    from repro_torch.core import fixed as F
    from repro_torch.core import simulator as S
    vol = V.benchmark_b2((16, 16, 16))
    cfg = dataclasses.replace(V.b2_config(), steps_per_round=8,
                              n_time_gates=3, collect_stats=True)
    run = S.simulate_fixed(vol, cfg, 400, 64, seed=3, device="cpu",
                           detectors=[{"x": 8, "y": 6, "radius": 4}],
                           record_detected=64)
    empty = F.zero_fixed(vol.shape, vol.media.shape[0], 1, cfg)
    acc = F.add_fixed(empty, F.harvest_result(run))
    assert int(acc.counters[0]) > 0 and int(acc.det_rec_n) > 0
    ck = Checkpointer(str(tmp_path / "acc"))
    ck.save(1, F.fixed_state(acc))
    _, leaves = ck.restore(F.fixed_state(empty))
    back = F.fixed_from_state(leaves, empty, acc.steps)
    for name, x, y in zip(F.FixedResult._fields, back, acc):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype == torch.int64, name
            assert torch.equal(x, y), name
        else:
            assert x == y, name
