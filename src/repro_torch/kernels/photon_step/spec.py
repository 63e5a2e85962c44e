"""Photon-step kernel output contract.

The plain version (``ref.photon_steps_ref``), the CUDA wrapper
(``photon_step.photon_step_cuda``), the dispatcher (``ops.photon_steps``)
and the round executor in ``repro_torch.core.simulator`` produce the same
output groups, in the same order, gated by the same flags.  The constants
are plain literals, equal to those of the JAX reference's spec.  This
part of the port implements the base group only; the optional groups
raise ``NotImplementedError`` until their kernels are ported.
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


def reject_optional_groups(ppath=None, det_geom=None, record=False,
                           jac_w=None, jac_col=None, jac_cols=0,
                           stats=False) -> None:
    """Raise for any optional output group: only the base group is
    ported so far."""
    asked = [name for name, on in (
        ("ppath/det_geom", ppath is not None or det_geom is not None),
        ("record", bool(record)),
        ("jac_w/jac_col/jac_cols",
         jac_w is not None or jac_col is not None or bool(jac_cols)),
        ("stats", bool(stats))) if on]
    if asked:
        raise NotImplementedError(
            f"photon-step output groups {asked} are not ported yet; only "
            f"the base group (state, fluence, exitance, escaped, timed) is")
