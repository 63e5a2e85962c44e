"""Photon-step kernel output contract.

The plain version (``ref.photon_steps_ref``), the CUDA wrapper
(``photon_step.photon_step_cuda``), the host wrapper
(``photon_step_cpu.photon_step_host``), the dispatcher (``ops.photon_steps``)
and the round executor in ``repro_torch.core.simulator`` produce the same
output groups, in the same order, gated by the same flags, and each
asserts ``output_arity``.  The constants are plain literals, equal to
those of the JAX reference's spec.  ``check_groups`` holds the
reference's rules on which optional inputs go together.
"""

from __future__ import annotations

# The photon state: one tensor per field, packed as one PhotonState.
STATE_FIELDS = ("pos", "dir", "ivox", "w", "s_left", "t", "rng", "alive")

# Unconditional outputs that follow the state.
BASE_OUTPUTS = ("fluence", "exitance", "escaped", "timed")

# Optional output groups, in emission order, keyed by the flag that
# gates them; "stats" is always last.
OUTPUT_GROUPS = (
    (("n_det",), ("ppath", "det_w", "det_ppath")),
    (("record",), ("cap_det", "cap_gate")),
    (("jac_cols",), ("jac",)),
    (("stats", "collect"), ("stats",)),
)

# Positional prefix every entry point takes, in this order.
CORE_PARAMS = ("labels_flat", "media", "state", "shape", "unitinmm",
               "cfg", "n_steps")

# Optional trailing parameters, in this relative order.
EXT_PARAMS = ("ppath", "det_geom", "record", "jac_w", "jac_col",
              "jac_cols", "stats")

# Order-independent sums.  Fluence, exitance, the TPSF, the detector
# path sums and the replay Jacobian are int64 fixed point: each deposit
# is rounded once (to nearest, ties to even) to a whole number of
# 2**-shift units, and the integer sums give the same bits in any order.
# Range and resolution:
#   fluence, exitance, det_w  2**-36 = 1.46e-11 weight a unit, at most
#                             2**27 = 1.34e8 weight in one cell
#   det_ppath                 2**-28 = 3.73e-9 weight * mm a unit, at
#                             most 2**35 = 3.44e10 weight * mm in one sum
#   jac                       2**-36 = 1.46e-11 weight * mm a unit, at
#                             most 2**27 = 1.34e8 weight * mm in one cell
# A deposit of DEPOSIT_LIMIT units or more (256 weight or weight * mm,
# 65536 weight * mm for det_ppath), or a sum past 2**63 - 1 units,
# raises: the CUDA kernel flags its error word (``photon_step.check_errors``),
# the host kernel's wrapper and the plain version raise at once, and the simulator and the replay
# check the sign of every total at the end of a run.  A launch runs at
# most MAX_STEPS segments, so a block's cached sum of 256 lanes' deposits
# stays below 2**64 and its sign shows an overflow.
FIXED_SHIFT = {"fluence": 36, "exitance": 36, "det_w": 36, "det_ppath": 28,
               "jac": 36}
DEPOSIT_LIMIT = 2.0**44
MAX_STEPS = 4095
# The simulator's per-scenario run totals (escaped, timed-out, launched
# and capped weight) are int64 sums of per-lane values in 2**-24 units:
# a resolution of 6.0e-8 weight and a range of 2**39 = 5.5e11 weight.
TOTAL_SHIFT = 24

# Bytes per lane of photon state in the reference layout: pos/dir (3 f32
# each), ivox (3 i32), w/s_left/t (f32), rng (4 u32), alive (i8).  The
# port carries rng as 4 int64 words, 16 bytes more (STATE_LANE_BYTES_PORT).
STATE_LANE_BYTES = 65
STATE_LANE_BYTES_PORT = 81


def output_arity(n_det: int = 0, record: bool = False, jac_cols: int = 0,
                 stats: bool = False, packed_state: bool = True) -> int:
    """Number of outputs a photon-step call must produce.

    ``packed_state=True`` counts the photon state as one element;
    ``False`` counts one output per state field.
    """
    n = (1 if packed_state else len(STATE_FIELDS)) + len(BASE_OUTPUTS)
    flags = {"n_det": bool(n_det), "record": bool(record),
             "jac_cols": bool(jac_cols), "stats": bool(stats)}
    for names, members in OUTPUT_GROUPS:
        if flags[names[0]]:
            n += len(members)
    return n


def check_groups(ppath=None, det_geom=None, record=False, jac_w=None,
                 jac_col=None, jac_cols: int = 0) -> tuple[int, bool, int]:
    """Check which optional output groups a call asks for; returns
    ``(n_det, record, jac_cols)``.  ``det_geom`` is ``(n_det, 3)``, or
    ``(S, n_det, 3)`` for a launch of S scenarios.

    Raises ``ValueError`` as the reference does: ``ppath`` and
    ``det_geom`` go together, ``jac_w``, ``jac_col`` and ``jac_cols > 0``
    go together, and ``record`` needs detectors.
    """
    if (ppath is None) != (det_geom is None):
        raise ValueError("ppath and det_geom must be given together")
    jac_cols = int(jac_cols)
    if (jac_cols > 0) != (jac_w is not None) or \
            (jac_w is None) != (jac_col is None):
        raise ValueError("jac_w, jac_col and jac_cols > 0 must be given "
                         "together")
    n_det = 0 if det_geom is None else int(det_geom.shape[-2])
    if record and not n_det:
        raise ValueError("record=True requires detectors (det_geom)")
    return n_det, bool(record), jac_cols


def scenario_count(media) -> tuple[int, bool]:
    """``(S, batched)`` of a call: a ``(S, n_media, 4)`` media table
    makes it a launch of S scenarios, a ``(n_media, 4)`` one a launch of
    one scenario with unbatched output grids."""
    if media.ndim == 3:
        return int(media.shape[0]), True
    return 1, False


# Static shared memory of one block of the kernel (csrc/photon_step.cu,
# step_block): the deposit cache's keys (int32) and sums (int64), the
# lane order (int32 a thread), each warp's live-lane count (int32), each
# warp's two sums of the round's tail (int64), each warp's mask of
# captured lanes (uint32; only photon_step_append_kernel, which appends
# the round's records, keeps it) and the tail's last-block flag (int32).
# A block may ask for at most SHARED_LIMIT bytes statically (48 KiB on
# Hopper, as on every architecture since Volta; more needs dynamic shared
# memory and an opt-in).
SHARED_LIMIT = 48 * 1024


def shared_bytes(threads: int, cache_slots: int) -> int:
    """Static shared bytes a block of ``threads`` threads with a deposit
    cache of ``cache_slots`` cells asks for."""
    return (cache_slots * (4 + 8) + threads * 4
            + (threads // 32) * (4 + 16 + 4) + 4)


def check_shared(threads: int, cache_slots: int) -> int:
    """:func:`shared_bytes`, raising ``ValueError`` past
    ``SHARED_LIMIT``."""
    need = shared_bytes(threads, cache_slots)
    if need > SHARED_LIMIT:
        raise ValueError(f"a block of {threads} threads with {cache_slots} "
                         f"cache cells asks for {need} bytes of static "
                         f"shared memory, over the {SHARED_LIMIT}-byte "
                         f"limit")
    return need
