"""Fixed-point sums that do not depend on the order of the adds, and a
run's result in them.

Fluence, exitance, TPSFs, detector path sums and the replay Jacobian
are int64 counts of ``2**-shift`` units (``kernels/photon_step/spec.py``:
``FIXED_SHIFT`` by output, with their range and resolution): each
float32 deposit is rounded once, to nearest with ties to even as the
CUDA kernel's ``__float2ll_rn(v * 2**shift)`` rounds it, and integer
addition is associative, so a sum has the same bits in any order, on
any device.

A run's totals, records and counters are a :class:`FixedResult`.  A
photon's path depends only on ``(seed, global id)``, so the results of
runs over disjoint id ranges add up (:func:`merge_fixed`,
:func:`add_fixed`) to the bits of one run over their union: the round
loop allocates its totals in this layout (:func:`zero_fixed`), and the
schedulers harvest each chunk to the CPU (:func:`harvest_result`), add
it into an accumulator and checkpoint that (:func:`fixed_state`).
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.kernels.photon_step import spec

# RoundStats counters a FixedResult carries as int64, in this order; the
# weight fields of RoundStats come from the totals at the conversion
COUNTER_FIELDS = ("rounds", "regen_rounds", "relaunched", "live_segments",
                  "lane_segments")


class FixedResult(NamedTuple):
    """A run's totals in int64 fixed point, before the one conversion to
    ``SimResult`` (``core.simulator.to_sim_result``).  Each total is in
    units of ``2**-SHIFTS[name]``; every field adds across disjoint id
    ranges (:func:`merge_fixed`)."""

    fluence: torch.Tensor     # (nx, ny, nz) or (nx, ny, nz, ntg) int64
    exitance: torch.Tensor    # (nx, ny) int64
    escaped: torch.Tensor     # () int64 escaped weight
    timed_out: torch.Tensor   # () int64 weight retired by the gate or cap
    launched_w: torch.Tensor  # () int64 launched weight
    n_launched: torch.Tensor  # () int64 photons launched
    steps: object             # int segments a lane ran (rounds * K), or a
    #                           rank-1 int64 tensor of them, one a shard
    det_w: torch.Tensor       # (n_det, ntg) int64 TPSF
    det_ppath: torch.Tensor   # (n_det, n_media) int64 path sums
    det_rec: torch.Tensor     # (capacity, 4) int64 record rows, or the
    #                           shards' buffers concatenated
    det_rec_n: torch.Tensor   # () int64 valid records, or one a shard
    det_rec_overflow: torch.Tensor  # () int64 captures dropped
    counters: torch.Tensor | None = None  # (5,) int64 in COUNTER_FIELDS
    #                           order with cfg.collect_stats, else None


# each weight total of a FixedResult and its fixed-point shift
SHIFTS = {"fluence": spec.FIXED_SHIFT["fluence"],
          "exitance": spec.FIXED_SHIFT["exitance"],
          "det_w": spec.FIXED_SHIFT["det_w"],
          "det_ppath": spec.FIXED_SHIFT["det_ppath"],
          "escaped": spec.TOTAL_SHIFT, "timed_out": spec.TOTAL_SHIFT,
          "launched_w": spec.TOTAL_SHIFT}
# the fields of a FixedResult that add across runs
_ADDED = tuple(SHIFTS) + ("n_launched", "det_rec_overflow")


def to_fixed(v: torch.Tensor, shift: int) -> torch.Tensor:
    """float32 ``v`` as int64 units of ``2**-shift``; raises
    ``OverflowError`` for a deposit of ``spec.DEPOSIT_LIMIT`` units or
    more, or not finite, which the kernel flags."""
    x = v * float(2**shift)  # exact: a power-of-two scale in float32
    if not bool((x < spec.DEPOSIT_LIMIT).all()):
        raise OverflowError(f"a deposit of 2**44 units of 2**-{shift} or "
                            f"more, or not finite")
    return torch.round(x).to(torch.int64)


def from_fixed(x: torch.Tensor, shift: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int64 units of ``2**-shift`` as ``dtype`` (float32 or float64),
    rounded once (the power-of-two scale is exact)."""
    return x.to(dtype) * float(2.0**-shift)


def zero_fixed(shape, n_media: int, n_det: int, cfg, rows=(),
               device=None) -> FixedResult:
    """The int64 totals of no photons: a volume of ``shape`` and
    ``n_media`` media, ``n_det`` detectors, ``cfg``'s time gates and
    counters (``collect_stats``), on ``device`` (``None``: the CPU).
    ``rows`` leads every tensor: the round loop's ``(S,)`` scenarios, or
    none for an accumulator.  ``steps`` is 0 and ``det_rec`` holds no
    row."""
    ntg = int(cfg.n_time_gates)

    def z(*size):
        return torch.zeros(tuple(rows) + size, dtype=torch.int64,
                           device=device)

    return FixedResult(
        fluence=z(*shape, *((ntg,) if ntg > 1 else ())),
        exitance=z(*shape[:2]), escaped=z(), timed_out=z(), launched_w=z(),
        n_launched=z(), steps=0, det_w=z(n_det, ntg),
        det_ppath=z(n_det, n_media), det_rec=z(0, 4), det_rec_n=z(),
        det_rec_overflow=z(),
        counters=z(len(COUNTER_FIELDS)) if cfg.collect_stats else None)


def check_range(totals: Iterable[torch.Tensor]) -> None:
    """Raise ``OverflowError`` if an int64 total passed the fixed-point
    range: past ``2**63 - 1`` units a sum shows a negative value (one
    host read)."""
    if bool(torch.stack([t.min() for t in totals if t.numel()]).lt(0).any()):
        raise OverflowError("a run total passed the fixed-point range of "
                            "2**63 - 1 units")


def merge_fixed(parts: Sequence[FixedResult]) -> FixedResult:
    """The sum of several runs' fixed-point results, on the host (CPU
    tensors): every total added (order-free, int64), ``steps`` and
    ``det_rec_n`` one entry a part (rank 1) and ``det_rec`` the parts'
    buffers concatenated, the layout of a sharded run.  Raises
    ``OverflowError`` if a sum passes the fixed-point range."""
    if not parts:
        raise ValueError("merge_fixed needs at least one result")
    dev = torch.device("cpu")
    moved = [FixedResult(*(x.to(dev) if isinstance(x, torch.Tensor) else x
                           for x in p)) for p in parts]
    summed = {k: sum(getattr(p, k) for p in moved) for k in _ADDED}
    counters = None
    if moved[0].counters is not None:
        counters = sum(p.counters for p in moved)
    merged = FixedResult(
        steps=torch.tensor([int(s) for p in moved
                            for s in torch.as_tensor(p.steps).reshape(-1)],
                           dtype=torch.int64, device=dev),
        det_rec=torch.cat([p.det_rec for p in moved]),
        det_rec_n=torch.cat([p.det_rec_n.reshape(-1) for p in moved]),
        counters=counters, **summed)
    check_range(summed[k] for k in _ADDED[:-1])
    return merged


def add_fixed(acc: FixedResult, harvest: FixedResult) -> FixedResult:
    """An accumulator with one more harvest added: the int64 totals and
    the segments run add, the records append (:func:`merge_fixed`, kept
    in one buffer of valid rows).  Raises ``OverflowError`` if a total
    passes the fixed-point range."""
    merged = merge_fixed([acc, harvest])
    return merged._replace(steps=int(merged.steps.sum()),
                           det_rec_n=merged.det_rec_n.sum())


def harvest_result(fixed: FixedResult) -> FixedResult:
    """Copy one chunk's ``FixedResult`` to the CPU (waits for its
    device), detached from device memory, for the schedulers to buffer,
    validate and merge: ``det_rec`` trimmed to its valid rows (a sharded
    result's buffers reassembled) with ``det_rec_n`` their count, so
    buffered copies don't pin the full capacity buffer, and ``steps``
    the longest shard's."""
    cpu = FixedResult(*(x.cpu() if isinstance(x, torch.Tensor) else x
                        for x in fixed))
    n = cpu.det_rec_n.reshape(-1).tolist()
    cap = cpu.det_rec.shape[0] // len(n)
    rec = torch.cat([cpu.det_rec[i * cap: i * cap + k]
                     for i, k in enumerate(n)]).reshape(-1, 4)
    return cpu._replace(det_rec=rec, det_rec_n=torch.tensor(rec.shape[0]),
                        steps=int(torch.as_tensor(cpu.steps).max()))


# the checkpoint leaves of an accumulator, under the reference's keys
_STATE_KEYS = {"energy": "fluence", "exitance": "exitance",
               "escaped_w": "escaped", "timed_out_w": "timed_out",
               "det_w": "det_w", "det_ppath": "det_ppath",
               "det_rec": "det_rec", "det_rec_overflow": "det_rec_overflow",
               "n_launched": "n_launched", "launched_w": "launched_w",
               "stats": "counters"}


def fixed_state(acc: FixedResult) -> dict:
    """An accumulator's checkpoint leaves: its int64 totals and counters
    as numpy, the records as ``(n, 4)`` uint32."""
    state = {k: getattr(acc, f).numpy().copy()
             for k, f in _STATE_KEYS.items() if getattr(acc, f) is not None}
    state["det_rec"] = state["det_rec"].astype(np.uint32)
    return state


def fixed_from_state(state: dict, like: FixedResult,
                     steps: int = 0) -> FixedResult:
    """The accumulator a :func:`fixed_state` checkpoint holds, with
    round counters where ``like`` (the accumulator it replaces) has
    them."""
    def t(k):
        return torch.tensor(np.asarray(state[k], np.int64))

    fields = {f: t(k) for k, f in _STATE_KEYS.items() if k != "stats"}
    fields["det_rec"] = fields["det_rec"].reshape(-1, 4)
    counters = None
    if like.counters is not None:
        counters = (t("stats") if "stats" in state
                    else torch.zeros_like(like.counters))
    return FixedResult(steps=int(steps), counters=counters,
                       det_rec_n=torch.tensor(fields["det_rec"].shape[0]),
                       **fields)
