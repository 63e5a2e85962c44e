"""The traced tier's rules, REP801 to REP805, over recorded operations.

Each rule's findings anchor to its target's entry file.  Adding a rule:
subclass :class:`TracedRule` here, append it to ``TRACED_RULES`` and
give it fixture tests (``tests/test_torch_lint.py``).
"""

from __future__ import annotations

from typing import Iterator

from repro_torch.lint import Finding
from repro_torch.lint.traced import Recording, TracedRule, TraceTarget

# 64-bit floating dtypes: the port computes in float32 and sums in int64
# fixed point.  int64 is not flagged (unlike the reference, whose traced
# contract is 32-bit): RNG words and fixed-point sums are int64 by the
# port's contract.
WIDE_FLOATS = ("torch.float64", "torch.complex128")
FLOATS = ("torch.float16", "torch.bfloat16", "torch.float32") + WIDE_FLOATS
# operations that add into their output at indices
ACCUMULATES = ("aten::index_add_", "aten::index_add", "aten::scatter_add_",
               "aten::scatter_add", "aten::scatter_reduce_",
               "aten::scatter_reduce", "aten::index_put_",
               "aten::index_put", "aten::_index_put_impl_", "aten::put_")


def _accumulates(op) -> bool:
    if op.base not in ACCUMULATES:
        return False
    if op.base in ("aten::index_put_", "aten::index_put",
                   "aten::_index_put_impl_", "aten::put_"):
        # a write unless asked to accumulate, by keyword or position
        return dict(op.kwargs).get("accumulate") is True or True in op.bools
    return True


class TracedDtypeRule(TracedRule):
    id = "REP801"
    name = "traced-dtype"
    severity = "error"
    description = ("no float64 among the operations the host issues "
                   "(int64 is the port's fixed point and RNG words)")

    def check(self, targets: list[TraceTarget]) -> Iterator[Finding]:
        for t in targets:
            seen: set[tuple] = set()
            for op in t.recording().ops:
                if op.in_step:
                    continue
                for dt in op.dtypes:
                    if dt in WIDE_FLOATS and (op.base, dt) not in seen:
                        seen.add((op.base, dt))
                        yield self.finding(
                            t, f"{dt.split('.')[1]} from `{op.base}`: the "
                            f"port computes in float32 and sums in int64")


class ScatterRaceRule(TracedRule):
    id = "REP802"
    name = "scatter-race"
    severity = "error"
    description = ("no float accumulate at indices (index_add_, "
                   "scatter_add_, index_put_ accumulate): its sum depends "
                   "on the order of the adds")

    def check(self, targets: list[TraceTarget]) -> Iterator[Finding]:
        for t in targets:
            seen: set[tuple] = set()
            for op in t.recording().ops:
                if not _accumulates(op):
                    continue
                for dt in op.dtypes:
                    if dt in FLOATS and (op.base, dt) not in seen:
                        seen.add((op.base, dt))
                        yield self.finding(
                            t, f"`{op.base}` accumulates {dt.split('.')[1]}"
                            f": a float sum at indices depends on the order "
                            f"of its adds; add int64 fixed point")


class HostSyncRule(TracedRule):
    id = "REP803"
    name = "host-sync"
    severity = "error"
    description = "a round of a round loop reads the host at most once"

    def check(self, targets: list[TraceTarget]) -> Iterator[Finding]:
        for t in targets:
            counts = t.recording().per_round()["host_reads"]
            extra = [i for i, n in enumerate(counts) if n > 1]
            if extra:
                yield self.finding(
                    t, f"{len(extra)} of {len(counts)} rounds read the host "
                    f"more than once (round {extra[0]}: {counts[extra[0]]} "
                    f"reads)")


class EngineParityRule(TracedRule):
    """The plain version's outputs against the buffers the wrapper
    allocates for the kernel (``photon_step.prepare``, run on ``meta``
    tensors so that no card is needed), for every output-group mask,
    one scenario and a launch of two."""

    id = "REP804"
    name = "engine-parity"
    severity = "error"
    description = ("the plain version's output shapes and dtypes equal "
                   "the kernel's buffers, for every output-group mask")
    entry = "src/repro_torch/kernels/photon_step/photon_step.py"

    def check(self, targets: list[TraceTarget]) -> Iterator[Finding]:
        from repro_torch.kernels.photon_step import photon_step as K

        for groups in K.VALID_GROUPS:
            for scenarios in (1, 2):
                got, want = parity(groups, scenarios)
                if got != want:
                    bad = next(i for i, (a, b) in enumerate(zip(got, want))
                               if a != b) if len(got) == len(want) else None
                    yield Finding(
                        rule=self.id, name=self.name, severity=self.severity,
                        path=self.entry, line=1, col=0,
                        message=f"[kernel/{K.group_names(groups)}/x"
                                f"{scenarios}] the plain version returns "
                                f"{len(want)} outputs, the kernel's buffers "
                                f"are {len(got)}" + (
                                    "" if bad is None else
                                    f"; output {bad}: plain {want[bad]}, "
                                    f"kernel {got[bad]}"))


def parity(groups: int, scenarios: int = 1) -> tuple[list, list]:
    """``(kernel buffers, plain outputs)`` as (shape, dtype) lists for one
    group mask on a small launch."""
    import dataclasses

    import torch

    from repro_torch.core import photon as ph
    from repro_torch.core import volume as V
    from repro_torch.kernels.photon_step import photon_step as K
    from repro_torch.kernels.photon_step.ops import fresh_state
    from repro_torch.kernels.photon_step.ref import photon_steps_ref

    shape, n, n_det, jac_cols = (4, 4, 4), 8, 2, 3
    vol = V.benchmark_b1(shape)
    cfg = dataclasses.replace(V.b1_config(), n_time_gates=2)
    n_media = vol.media.shape[0]
    state = fresh_state(vol, n * scenarios)
    media = (vol.media if scenarios == 1
             else vol.media[None].repeat(scenarios, 1, 1))
    lead = (scenarios,) if scenarios > 1 else ()
    kw = {}
    if groups & K.GROUP_BITS["n_det"]:
        kw.update(ppath=torch.zeros((n * scenarios, n_media)),
                  det_geom=torch.tensor([[1.0, 1.0, 1.0],
                                         [2.0, 2.0, 1.0]]).repeat(
                      *lead, 1, 1) if lead else torch.tensor(
                      [[1.0, 1.0, 1.0], [2.0, 2.0, 1.0]]))
    if groups & K.GROUP_BITS["record"]:
        kw["record"] = True
    if groups & K.GROUP_BITS["jac_cols"]:
        kw.update(jac_w=torch.zeros((n * scenarios,)),
                  jac_col=torch.zeros((n * scenarios,), dtype=torch.int32),
                  jac_cols=jac_cols)
    if groups & K.GROUP_BITS["stats"]:
        kw["stats"] = True
    labels = vol.labels.reshape(-1)
    plain = photon_steps_ref(labels, media, state, shape, 1.0, cfg, 1, **kw)
    want = [(tuple(x.shape), x.dtype) for x in (*plain[0], *plain[1:])]

    def meta(x):
        return x.to("meta") if isinstance(x, torch.Tensor) else x

    _, _, outs, _, _ = K.prepare(
        meta(labels), meta(media), ph.PhotonState(*map(meta, state)), shape,
        1.0, cfg, 1, **{k: meta(v) for k, v in kw.items()})
    got = [(tuple(x.shape), x.dtype) for x in outs]
    return got, want


class RecompileChurnRule(TracedRule):
    id = "REP805"
    name = "recompile-churn"
    severity = "error"
    description = ("a round's operations do not change with the dynamic "
                   "arguments (seed, counts, id offsets, media, source "
                   "position, detector geometry)")

    def check(self, targets: list[TraceTarget]) -> Iterator[Finding]:
        for t in targets:
            base = _steady_round(t.recording())
            if base is None:
                if t.variants:
                    yield self.finding(t, "its rounds differ from one "
                                       "another within one run")
                continue
            for name, overrides in t.variants.items():
                other = _steady_round(t.make(overrides))
                if other != base:
                    yield self.finding(
                        t, f"changing `{name}` changes a round's operations"
                        f"{_first_difference(base, other)}")


def _steady_round(rec: Recording) -> list | None:
    """The operations of a steady round, if every steady round of the
    run issues the same ones (None otherwise).  Host reads are left out:
    the round loop reads once every few rounds, not in each (REP803
    counts them)."""
    rounds = [[op.key() for op in r if not op.host_read()]
              for r in rec.rounds()]
    if not rounds:
        return []
    return rounds[0] if all(r == rounds[0] for r in rounds) else None


def _first_difference(a: list, b: list | None) -> str:
    if b is None:
        return " (its rounds differ from one another)"
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f" (operation {i}: {x[0]} against {y[0]})"
    return f" ({len(a)} operations against {len(b)})"


TRACED_RULES = (TracedDtypeRule, ScatterRaceRule, HostSyncRule,
                EngineParityRule, RecompileChurnRule)
