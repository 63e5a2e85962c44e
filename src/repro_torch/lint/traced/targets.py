"""The traced tier's targets: real calls of the port at a small size.

Every target runs on the CPU (the plain version in place of the
kernel) unless given another device: an (8, 8, 8) volume of two media,
16 lanes, K = 2, three time gates over 0.2 ns, at most 40 segments a
lane, one detector, a record buffer and round stats.  Each target's ``make(overrides)`` records one call;
overrides change the call's dynamic arguments (REP805's variants).

* ``sim``: one ``simulator.simulate_fixed``;
* ``replay``: ``replay.replay_jacobian`` of the ``sim`` run's records,
  both passes;
* ``pool``: a device process's chunk function (``core.procs``), run in
  this process as a child runs it;
* ``simulate-many``: three scenarios through
  ``scenarios.simulate_many``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.lint.traced import Recorder, TraceTarget, stepping_recorded

SHAPE = (8, 8, 8)
LANES = 16
K = 2
GATES = 3
PHOTONS = 32
MAX_STEPS = 40
SEED = 7
RECORDS = 64
DETECTOR = {"x": 5.0, "y": 4.0, "radius": 2.5}
SOURCE = {"type": "pencil", "pos": [4.0, 4.0, 0.0]}

# the dynamic arguments a round's operations must not depend on
VARIANTS = {
    "seed": {"seed": SEED + 1},
    "photons": {"photons": PHOTONS + 21},
    "id_offset": {"id_offset": 2**32 - 5},
    "media": {"mus_scale": 1.5},
    "source_pos": {"source": {"type": "pencil", "pos": [3.0, 5.0, 0.0]}},
    "detector": {"detector": {"x": 3.0, "y": 5.0, "radius": 1.5}},
}


def _inputs(overrides: dict | None):
    from repro_torch.core import volume as V

    o = dict(overrides or {})
    vol = V.benchmark_b1(SHAPE)
    media = vol.media.clone()
    media[1:, 1] *= float(o.get("mus_scale", 1.0))
    vol = dataclasses.replace(vol, media=media)
    cfg = dataclasses.replace(V.b1_config(), steps_per_round=K,
                              n_time_gates=GATES, tmax_ns=0.2, max_steps=MAX_STEPS,
                              collect_stats=True)
    return (vol, cfg, int(o.get("photons", PHOTONS)),
            int(o.get("seed", SEED)), int(o.get("id_offset", 0)),
            o.get("source", SOURCE), [o.get("detector", DETECTOR)])


def _record(call) -> object:
    recorder = Recorder()
    with stepping_recorded(recorder), recorder:
        call()
    return recorder.recording()


def make_sim(device: str = "cpu"):
    """The ``sim`` target's run on ``device``."""
    def make(overrides=None):
        from repro_torch.core import simulator as S

        vol, cfg, n, seed, offset, src, dets = _inputs(overrides)
        vol = vol.to(device)
        return _record(lambda: S.simulate_fixed(
            vol, cfg, n, LANES, seed, source=src, device=device,
            detectors=dets, record_detected=RECORDS, id_offset=offset))
    return make


def _make_replay(overrides=None):
    import torch

    from repro_torch import replay as R
    from repro_torch.core import procs
    from repro_torch.core import simulator as S

    vol, cfg, n, seed, offset, src, dets = _inputs(overrides)
    res = S.simulate(vol, cfg, n, LANES, seed, source=src, device="cpu",
                     detectors=dets, record_detected=RECORDS)
    records = R.detected_records(res)
    # a replay built before would keep its photon step unrecorded
    procs._LOCAL.pop(torch.device("cpu"), None)
    return _record(lambda: R.replay_jacobian(
        vol, cfg, records, dets, source=src, seed=seed, n_lanes=LANES,
        device="cpu", gate_resolved=True))


def _make_pool(overrides=None):
    import torch

    from repro_torch.core import procs

    vol, cfg, n, seed, offset, src, dets = _inputs(overrides)
    work = procs.sim_work(vol, cfg, LANES, "dynamic", src, dets, RECORDS)
    state = procs._State(torch.device("cpu"))
    return _record(lambda: state.run("sim", work.key, work,
                                     (n, seed, offset)))


def _make_many(overrides=None):
    from repro_torch import scenarios as SC

    vol, cfg, n, seed, offset, src, dets = _inputs(overrides)
    fleet = [SC.Scenario(vol, cfg, n + 8 * i, seed=seed + i, source=src,
                         detectors=dets, id_offset=offset + 1000 * i)
             for i in range(3)]
    return _record(lambda: SC.simulate_many(
        fleet, n_lanes=LANES, device="cpu", cache=SC.CompileCache()))


def build_default_targets() -> list[TraceTarget]:
    sim_entry = "src/repro_torch/core/simulator.py"
    return [
        TraceTarget("sim", sim_entry, make_sim("cpu"), dict(VARIANTS)),
        TraceTarget("replay", "src/repro_torch/replay/__init__.py",
                    _make_replay),
        TraceTarget("pool", "src/repro_torch/core/procs.py", _make_pool),
        TraceTarget("simulate-many", "src/repro_torch/scenarios/__init__.py",
                    _make_many, {k: VARIANTS[k] for k in
                                 ("seed", "media", "source_pos")}),
    ]
