"""Binding and wrapper of the CUDA regeneration kernel.

The kernel (``csrc/regenerate.cu``) does on the card, in one C call a
round, what ``core.simulator.PlainRegeneration`` does with ~160-310
PyTorch operations: it picks the dead lanes to relaunch (dynamic mode:
a dead lane whose rank among its scenario's dead lanes is below the
scenario's remaining budget; static mode: a dead lane below its quota),
gives each the next 64-bit photon id by that rank, seeds its streams,
samples the source from its staged ``(S, ...)`` parameters, launches it
(``photon.launch``) and updates the scenario's counters, with the bits
of the plain path on every field.

The round loop (``core.simulator.build_round_loop``) takes it where it
can observe that it applies (:func:`supports`): CUDA tensors and a
``sources.base.StagedSampler`` of one of the seven source types of
``sources/types.py``.  On the CPU, or for a source without ``stage()``,
the loop runs ``PlainRegeneration``, which takes the same arguments,
writes the same buffers in place, and which the card tests hold the
kernel against.

The library is built with the photon-step variants
(``photon_step.build_all``, target ``photon_step.REGENERATE``) and loaded
at first use.  A :class:`Regeneration` is bound to one run's buffers
(checked once) and owns its workspace (the scan's scratch, the advanced
ids), allocated once, so a CUDA graph that captures a call allocates
nothing; each call checks the round's state, launches on PyTorch's
current stream, never reads the device from the host, and counts one
launch in ``photon_step.photon_step_cuda.launches_by`` under
``regenerate/<source>`` (``/x<S>`` appended for S > 1 scenarios).
"""

from __future__ import annotations

import array
import ctypes

import torch

from repro_torch.core import photon as ph
from repro_torch.kernels.photon_step import photon_step as K
from repro_torch.kernels.photon_step import spec
from repro_torch.sources import types as T
from repro_torch.sources.base import StagedSampler

# Each source class the kernel evaluates: its number in the kernel and
# its staged keys in the order of the entry point's params, the last one
# optional for planar (its pattern) and line (the slit's direction)
SOURCES = {
    T.Pencil: (0, ("pos", "dir")),
    T.IsotropicPoint: (1, ("pos",)),
    T.Cone: (2, ("pos", "axis", "e1", "e2", "one_minus_cos_half")),
    T.GaussianBeam: (3, ("pos", "dir", "e1", "e2", "waist")),
    T.Disk: (4, ("pos", "dir", "e1", "e2", "radius")),
    T.Planar: (5, ("pos", "v1", "v2", "dir", "pattern")),
    T.Line: (6, ("start", "end", "dir")),
}
OPTIONAL = {T.Planar: "pattern", T.Line: "dir"}
# Scalars of the staged dicts; every other key but the pattern is a
# 3-vector
_SCALARS = ("one_minus_cos_half", "waist", "radius")
# The entry point's ptrs and ints, in the order its comment lists them;
# "params" stands for PARAMS pointers
PTRS = ("pos", "dir", "ivox", "w", "s_left", "t", "rng", "alive",
        "remaining", "launched", "quota", "next_lo", "next_hi", "seeds",
        "launched_w", "next_out", "scratch", "ppath", "lane_ids", "params")
PARAMS = 5
INTS = ("n", "scenarios", "tiles", "threads", "dynamic", "kind", "optional",
        "n_media", "rows", "cols", "nx", "ny", "nz")
_NEXT_LO, _NEXT_HI, _PPATH = (
    PTRS.index(k) for k in ("next_lo", "next_hi", "ppath"))
# Compile-time block size of csrc/regenerate.cu (kThreads)
THREADS = 256


def supports(sample, device) -> bool:
    """Whether the round loop regenerates with the kernel: a CUDA device
    and a ``StagedSampler`` of a source type the kernel evaluates."""
    return (torch.device(device).type == "cuda"
            and isinstance(sample, StagedSampler)
            and sample.source_cls in SOURCES)


def source_key(source_cls: type, scenarios: int) -> str:
    """The ``launches_by`` key of one call: ``regenerate/<type>``, with
    ``/x<S>`` for S > 1 scenarios."""
    key = f"regenerate/{source_cls.type_name}"
    return key + (f"/x{scenarios}" if scenarios > 1 else "")


def _library() -> ctypes.CDLL:
    """The loaded library, built at its first use."""
    lib = K._LIBRARIES.get(K.REGENERATE)
    if lib is None:
        lib = ctypes.CDLL(str(K.build_library(K.REGENERATE)))
        lib.regenerate_launch.argtypes = [ctypes.c_void_p] * 3
        lib.regenerate_launch.restype = ctypes.c_int
        lib.regenerate_error_string.argtypes = [ctypes.c_int]
        lib.regenerate_error_string.restype = ctypes.c_char_p
        built = (lib.regenerate_threads(), lib.regenerate_total_shift())
        if built != (THREADS, spec.TOTAL_SHIFT):
            raise K.KernelError(
                f"{K.library_path(K.REGENERATE).name} has block size and "
                f"weight shift {built}, the wrapper "
                f"{(THREADS, spec.TOTAL_SHIFT)}")
        K._LIBRARIES[K.REGENERATE] = lib
    return lib


class Regeneration:
    """The regeneration kernel bound to one run of S scenarios of ``n``
    lanes: the source (``sample``, a ``StagedSampler``), the mode, the
    volume's ``shape``, and the run's ``(S,)`` int64 photon budgets
    ``remaining``, ``(S, n)`` int64 ``launched_per_lane`` and ``quota``,
    ``(S,)`` int64 ``launched_w`` (2**-TOTAL_SHIFT units), ``(S, 1)``
    int64 seed words, the media count of the per-lane paths
    (``n_media``; 0 without detectors) and the ``(S * n, 2)`` int64
    ``lane_ids`` of a recording run (or None), all on one CUDA device.

    ``regen(state, next_id, ppath=None)`` relaunches a round's dead
    lanes: the state (a ``PhotonState`` of ``S * n`` lanes), ``ppath``
    (zeroed rows), ``remaining``, ``launched_per_lane``, ``launched_w``
    (the launched weight added) and ``lane_ids`` change in place; it
    returns the advanced ``next_id``, a ``(lo, hi)`` pair of ``(S,)``
    int64 words: the rows of ``next_out``, the ``(2, S)`` buffer each
    call overwrites, which must not be the ``next_id`` passed in (the
    round loop copies it into its own ids).  What each holds afterwards
    is what ``core.simulator.PlainRegeneration`` leaves, bit for bit.
    """

    def __init__(self, sample: StagedSampler, mode: str, shape, remaining,
                 launched_per_lane, quota, launched_w, seeds,
                 n_media: int = 0, lane_ids=None):
        dev = remaining.device
        if dev.type != "cuda":
            raise ValueError(f"the regeneration kernel needs CUDA tensors, "
                             f"got {dev}")
        if not supports(sample, dev):
            raise ValueError(f"the regeneration kernel evaluates no "
                             f"{sample!r}: it takes a StagedSampler of "
                             f"{[c.__name__ for c in SOURCES]}")
        if mode not in ("dynamic", "static"):
            raise ValueError(f"unknown workload mode: {mode}")
        S, n = (int(x) for x in launched_per_lane.shape)
        N = S * n
        self.device, self.S, self.N = dev, S, N
        self.n_media = int(n_media)
        i64 = torch.int64
        specs = [("remaining", remaining, i64, (S,)),
                 ("launched_per_lane", launched_per_lane, i64, (S, n)),
                 ("quota", quota, i64, (S, n)),
                 ("launched_w", launched_w, i64, (S,)),
                 ("seeds", seeds, i64, (S, 1))]
        if lane_ids is not None:
            specs.append(("lane_ids", lane_ids, i64, (N, 2)))
        cls = sample.source_cls
        kind, keys = SOURCES[cls]
        optional = OPTIONAL.get(cls)
        rows = cols = 0
        params = []
        for key in keys:
            if key == optional and key not in sample.staged:
                continue
            x = sample.staged[key]
            if key == "pattern":
                rows, cols = (int(v) for v in x.shape[-2:])
                shp = (S, rows, cols)
            else:
                shp = (S,) if key in _SCALARS else (S, 3)
            specs.append((f"staged[{key}]", x, torch.float32, shp))
            params.append(x)
        K._check_all(specs, dev)
        self._key = source_key(cls, S)
        tiles = -(-n // THREADS)
        scratch = torch.empty((S * (tiles + 1),), dtype=i64, device=dev)
        self.next_out = torch.empty((2, S), dtype=i64, device=dev)
        # the tensors behind the run-constant pointers, kept alive
        self._keep = (remaining, launched_per_lane, quota, seeds, launched_w,
                      scratch, lane_ids, params)
        fixed = {"remaining": remaining, "launched": launched_per_lane,
                 "quota": quota, "seeds": seeds, "launched_w": launched_w,
                 "scratch": scratch, "next_out": self.next_out,
                 "lane_ids": lane_ids}
        self._ptrs = array.array("Q", [
            fixed[k].data_ptr() if fixed.get(k) is not None else 0
            for k in PTRS[:-1]] + [x.data_ptr() for x in params] + [0] * (
            PARAMS - len(params)))
        nx, ny, nz = (int(s) for s in shape)
        ints = {"n": n, "scenarios": S, "tiles": tiles, "threads": THREADS,
                "dynamic": int(mode == "dynamic"), "kind": kind,
                "optional": int(optional in sample.staged),
                "n_media": self.n_media, "rows": rows, "cols": cols,
                "nx": nx, "ny": ny, "nz": nz}
        self._ints = array.array("i", [ints[k] for k in INTS])
        self._lib = _library()

    def __call__(self, state: ph.PhotonState, next_id, ppath=None):
        dev, N = self.device, self.N
        specs = [(name, getattr(state, name), dtype, (N,) + width)
                 for name, dtype, width in K._STATE_SPECS]
        specs += [("next_id[0]", next_id[0], torch.int64, (self.S,)),
                  ("next_id[1]", next_id[1], torch.int64, (self.S,))]
        if self.n_media:
            specs.append(("ppath", ppath, torch.float32, (N, self.n_media)))
        elif ppath is not None:
            raise ValueError("ppath given to a regeneration bound without "
                             "per-lane paths (n_media 0)")
        K._check_all(specs, dev)
        next_out = self.next_out
        ptrs = self._ptrs
        for i, x in enumerate(state):  # PTRS starts with the state
            ptrs[i] = x.data_ptr()
        ptrs[_NEXT_LO] = next_id[0].data_ptr()
        ptrs[_NEXT_HI] = next_id[1].data_ptr()
        if self.n_media:
            ptrs[_PPATH] = ppath.data_ptr()
        index = torch.cuda.current_device()
        if dev.index is None or dev.index == index:
            err = self._lib.regenerate_launch(
                ptrs.buffer_info()[0], self._ints.buffer_info()[0],
                torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(dev):
                err = self._lib.regenerate_launch(
                    ptrs.buffer_info()[0], self._ints.buffer_info()[0],
                    torch._C._cuda_getCurrentRawStream(dev.index))
        if err != 0:
            msg = self._lib.regenerate_error_string(err).decode()
            raise K.KernelError(f"regeneration kernel launch failed: {msg} "
                                f"({err})")
        K.count_launch(self._key)
        return next_out[0], next_out[1]
