"""Build, binding and wrapper of the CUDA photon-step kernel.

The kernel (``csrc/photon_step.cu``) replaces the TPU kernel
``repro/kernels/photon_step/photon_step.py::photon_step_pallas`` with
every output group.  It advances every photon lane ``n_steps`` segments
with one thread per lane and the state in registers; each block sums
its fluence and exitance deposits in a cache in shared memory and adds
the cache to device memory once, and orders its lanes so that those
alive at launch share warps.  Fluence, exitance, TPSF, detector path
sums and the replay Jacobian are int64 fixed point
(``spec.FIXED_SHIFT``), so they do not depend on the order of the
adds.  One launch may advance S scenarios (``blockIdx.y``), each with
its own media, detectors and grids.  The source file's header says
what bounds it on the card and what the design does about that.

The source is compiled with ``nvcc`` for ``sm_90a`` once per set of
output groups (``PS_GROUPS``, a mask of ``GROUP_BITS``), at first use,
into ``build/repro_torch/`` at the root of the checkout (git-ignored),
under a name keyed by a hash of the source and the flags, and loaded
with ``ctypes`` through a plain C entry point.  The regeneration
kernel (``csrc/regenerate.cu``, bound in ``regenerate.py``) is built the
same way, as the target ``REGENERATE``.  ``build_all`` starts every
variant's ``nvcc`` and the regeneration kernel's at once, and ``load``
builds through it.

``photon_step_cuda`` checks its inputs and allocates its outputs
(``prepare``: the kernel zeroes the accumulated ones on the stream
itself, or adds into the caller's ``totals``), packs the entry point's
arrays (``pack``), launches on PyTorch's current stream, and raises
``KernelError`` if the launch fails (as the build and load do).  ``check_errors`` raises for what a launch flagged on
the device (a Jacobian column out of range, a fixed-point overflow).
``photon_step_cuda.launches_by`` counts its launches by
``variant_name``, with ``/xS`` appended for a launch of S > 1
scenarios.

Each device of a multi-device run has a process of its own
(``core.procs``): two processes that build one group mask at once take
turns on a file lock in ``BUILD_DIR``, and each library is moved into
place whole.  Launch counts are those of this process; the parent adds
its children's from their replies (``add_launches``).  A thread has its
own error word on each device, so its ``check_errors`` reads and clears
only what its own launches flagged.
"""

from __future__ import annotations

import array
import collections
import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

from repro_torch.core import photon as ph
from repro_torch.core.volume import SimConfig
from repro_torch.kernels.photon_step import spec

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "photon_step.cu"
# The regeneration kernel's source and its build target
REGEN_SRC = _SRC.with_name("regenerate.cu")
REGENERATE = "regenerate"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[4] / "build" / "repro_torch"
# -lineinfo adds line tables only (for sass.py); the code is the same.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-lineinfo", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# Bit of each optional output group in the kernel's PS_GROUPS mask.
GROUP_BITS = {"n_det": 1, "record": 2, "jac_cols": 4, "stats": 8}
# Every mask the output contract allows: record needs detectors.
VALID_GROUPS = tuple(m for m in range(16) if not (m & 2 and not m & 1))


def group_mask(n_det: int = 0, record: bool = False, jac_cols: int = 0,
               stats: bool = False) -> int:
    """The PS_GROUPS mask of a call's optional output groups."""
    flags = {"n_det": n_det, "record": record, "jac_cols": jac_cols,
             "stats": stats}
    return sum(bit for name, bit in GROUP_BITS.items() if flags[name])


def group_names(groups: int) -> str:
    """``"base"`` or the groups of a mask joined by ``+``, e.g.
    ``"det+record+stats"``."""
    names = [{"n_det": "det", "jac_cols": "jac"}.get(n, n)
             for n, bit in GROUP_BITS.items() if groups & bit]
    return "+".join(names) or "base"


def variant_name(groups: int, cfg: SimConfig) -> str:
    """Name of one compiled kernel variant: physics template flags and
    output groups, e.g. ``"reflect/exact/det+record"``."""
    return _variant_name(groups, bool(cfg.do_reflect), cfg.deposit_mode)


@functools.cache
def _variant_name(groups: int, do_reflect: bool, deposit_mode: str) -> str:
    return "/".join(("reflect" if do_reflect else "noreflect", deposit_mode,
                     group_names(groups)))


class KernelError(RuntimeError):
    """The kernel could not be built, loaded or launched.  Never a
    reason to carry on elsewhere: the schedulers raise it rather than
    retry the work on another device."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelError("nvcc not found: the CUDA toolkit is needed to build "
                      "the photon-step kernel")


def _flags(groups) -> tuple[str, ...]:
    if groups == REGENERATE:
        return NVCC_FLAGS
    if groups not in VALID_GROUPS:
        raise ValueError(f"no photon-step kernel for output-group mask "
                         f"{groups}; valid masks: {VALID_GROUPS}")
    return NVCC_FLAGS + (f"-DPS_GROUPS={groups}",)


def _source(groups) -> pathlib.Path:
    return REGEN_SRC if groups == REGENERATE else _SRC


def library_path(groups=0) -> pathlib.Path:
    """Where the built kernel library of a group mask (or of
    ``REGENERATE``) lives, keyed by source and flags."""
    key = hashlib.sha256(_source(groups).read_bytes()
                         + " ".join(_flags(groups)).encode())
    stem = REGENERATE if groups == REGENERATE else f"photon_step_g{groups}"
    return BUILD_DIR / f"{stem}_{key.hexdigest()[:16]}.so"


def _start_build(groups):
    """Start ``nvcc`` for one group mask (or ``REGENERATE``); returns
    ``(out, tmp, cmd, process)``, or ``None`` when the library is already
    built."""
    out = library_path(groups)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(groups), "-o", str(tmp), str(_source(groups))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, cmd, proc


def _finish_build(started) -> None:
    out, tmp, cmd, proc = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_library(groups=0) -> pathlib.Path:
    """Compile one group mask's kernel (or ``REGENERATE``) if it is not
    built yet; returns its path.  The compiler's output (``-Xptxas -v``:
    registers, spills) is kept beside it in a ``.log`` file.  A failed
    build raises."""
    with _build_lock():
        started = _start_build(groups)
        if started is not None:
            _finish_build(started)
    return library_path(groups)


_LIBRARIES: dict[int, ctypes.CDLL] = {}


@contextlib.contextmanager
def _build_lock():
    """The file lock ``BUILD_DIR / build.lock``, held while libraries
    are built: two processes (or threads, each opening the file) would
    otherwise both start nvcc on one library, and one that waited finds
    it built and builds nothing."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(groups=VALID_GROUPS) -> float:
    """Build the kernels of several group masks and the regeneration
    kernel, one ``nvcc`` each, all started together; returns seconds.
    Any failed build raises."""
    t0 = time.perf_counter()  # reprolint: disable=REP201 - build and load seconds, reported
    with _build_lock():
        started = [x for x in map(_start_build, (*groups, REGENERATE))
                   if x is not None]
        errors = []
        for x in started:
            try:
                _finish_build(x)
            except KernelError as e:
                errors.append(str(e))
    if errors:
        raise KernelError("\n".join(errors))
    return time.perf_counter() - t0  # reprolint: disable=REP201 - build and load seconds, reported


def _library(groups: int) -> ctypes.CDLL:
    """The loaded library of a group mask, built at its first use."""
    lib = _LIBRARIES.get(groups)
    if lib is None:
        lib = _LIBRARIES[groups] = _load_library(groups)
    return lib


def _load_library(groups: int) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(groups)))
    lib.photon_step_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_void_p]
    lib.photon_step_launch.restype = ctypes.c_int
    lib.photon_step_error_string.argtypes = [ctypes.c_int]
    lib.photon_step_error_string.restype = ctypes.c_char_p
    lib.photon_step_groups.restype = ctypes.c_int
    if lib.photon_step_groups() != groups:
        raise KernelError(f"{library_path(groups).name} was built for "
                          f"groups {lib.photon_step_groups()}, not {groups}")
    built = (lib.photon_step_threads(), lib.photon_step_cache_slots())
    if built != (THREADS, CACHE_SLOTS):
        raise KernelError(f"{library_path(groups).name} has launch "
                          f"constants {built}, the wrapper "
                          f"{(THREADS, CACHE_SLOTS)}")
    try:
        spec.check_shared(*built)
    except ValueError as e:
        raise KernelError(f"{library_path(groups).name}: {e}") from None
    return lib


def load(groups=(0,)) -> float:
    """Build (if needed, in one ``build_all`` batch with the
    regeneration kernel) and load the kernel libraries of ``groups``;
    returns seconds."""
    t0 = time.perf_counter()  # reprolint: disable=REP201 - build and load seconds, reported
    build_all(groups)
    for g in groups:
        _library(g)
    return time.perf_counter() - t0  # reprolint: disable=REP201 - build and load seconds, reported


# Compile-time constants of csrc/photon_step.cu (kThreads, kCacheSlots),
# checked against each library when it is loaded: one thread per lane in
# blocks of THREADS, each with a deposit cache of CACHE_SLOTS cells.
THREADS = 256
CACHE_SLOTS = 1024
# The deposit cache keys fluence cells and exitance bins with one int32.
MAX_CELLS = 2**31
# Scenarios of one launch ride on blockIdx.y.
MAX_SCENARIOS = 65535


def _check(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_all(specs, device) -> None:
    """``_check`` each ``(name, x, dtype, shape)``; the common case, where
    all hold, costs one comparison chain a tensor."""
    for name, x, dtype, shape in specs:
        if not (isinstance(x, torch.Tensor) and x.dtype is dtype
                and x.shape == shape and x.device == device
                and x.is_contiguous()):
            _check(name, x, dtype, shape, device)


_STATE_SPECS = (("pos", torch.float32, (3,)), ("dir", torch.float32, (3,)),
                ("ivox", torch.int32, (3,)), ("w", torch.float32, ()),
                ("s_left", torch.float32, ()), ("t", torch.float32, ()),
                ("rng", torch.int64, (4,)), ("alive", torch.bool, ()))


def _grid_specs(S, batched, nvox, nxy, ntg, n_det, n_media, jac_cols):
    """``(name, shape)`` of the int64 fixed-point grids of a call."""
    lead = (S,) if batched else ()
    specs = [("fluence", lead + (nvox * ntg,)), ("exitance", lead + (nxy,))]
    if n_det:
        specs += [("det_w", lead + (n_det * ntg,)),
                  ("det_ppath", lead + (n_det, n_media))]
    if jac_cols:
        specs += [("jac", lead + (nvox * jac_cols,))]
    return specs


def prepare(labels_flat, media, state: ph.PhotonState, shape, unitinmm,
            cfg: SimConfig, n_steps: int, ppath=None, det_geom=None,
            record=False, jac_w=None, jac_col=None, jac_cols: int = 0,
            stats: bool = False, totals=None, inplace: bool = False):
    """Check a call's inputs and allocate its outputs on the state's
    device; returns ``(groups, ins, outs, ints, floats)``: the
    tensors, in the order of the C entry point's ``in`` and ``out``
    arrays, and its ``ints`` and ``floats``.  The kernel zeroes the
    accumulated outputs (fluence, exitance, TPSF, path sums, Jacobian)
    itself, so every output is allocated uninitialised; with ``totals``
    those fixed-point grids are the caller's, which the launch adds into
    and zeroes nothing.  With ``inplace`` the new lane state and
    ``ppath`` are written over the inputs (both kernels read each lane
    before they write it).  A ``(S, n_media, 4)`` media table makes
    it a launch of S scenarios (``ref.photon_steps_ref`` gives the
    shapes)."""
    n_det, record, jac_cols = spec.check_groups(ppath, det_geom, record,
                                                jac_w, jac_col, jac_cols)
    S, batched = spec.scenario_count(media)
    dev = state.w.device
    nx, ny, nz = (int(s) for s in shape)
    nvox, nxy = nx * ny * nz, nx * ny
    n_all = state.w.shape[0]
    n_media = media.shape[-2]
    ntg = int(cfg.n_time_gates)
    n_steps = int(n_steps)
    if ntg < 1 or not 0 <= n_steps <= spec.MAX_STEPS:
        raise ValueError(f"need n_time_gates >= 1 and n_steps >= 0 (at "
                         f"most {spec.MAX_STEPS}), got {ntg} and {n_steps}")
    if nvox * ntg + nxy >= MAX_CELLS:
        raise ValueError(f"fluence grid of {nvox * ntg} cells and {nxy} "
                         f"exitance bins is too large (< 2^31 in all)")
    if not 1 <= S <= MAX_SCENARIOS or n_all % S:
        raise ValueError(f"{n_all} lanes do not split into {S} scenarios "
                         f"(1 to {MAX_SCENARIOS})")
    n = n_all // S
    stacked = batched and labels_flat.ndim == 2
    specs = [("labels_flat", labels_flat, torch.uint8,
              (S, nvox) if stacked else (nvox,)),
             ("media", media, torch.float32, tuple(media.shape[:-2]) + (
                 n_media, 4))]
    specs += [(name, getattr(state, name), dtype, (n_all,) + width)
              for name, dtype, width in _STATE_SPECS]
    if n_det:
        specs += [("ppath", ppath, torch.float32, (n_all, n_media)),
                  ("det_geom", det_geom, torch.float32,
                   ((S,) if batched else ()) + (n_det, 3))]
    if jac_cols:
        specs += [("jac_w", jac_w, torch.float32, (n_all,)),
                  ("jac_col", jac_col, torch.int32, (n_all,))]
    grids = _grid_specs(S, batched, nvox, nxy, ntg, n_det, n_media,
                        jac_cols)
    if totals is not None:
        if len(totals) != len(grids):
            raise ValueError(f"totals must be the {len(grids)} grids "
                             f"{[g for g, _ in grids]}")
        specs += [(f"totals[{name}]", x, torch.int64, shp)
                  for (name, shp), x in zip(grids, totals)]
    _check_all(specs, dev)

    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    fixed = dict(zip((name for name, _ in grids), totals)) if (
        totals is not None) else {
        name: torch.empty(shp, dtype=torch.int64, device=dev)
        for name, shp in grids}
    ins = [labels_flat, media, *state, _error_word(dev)]
    outs = list(state) if inplace else [torch.empty_like(x) for x in state]
    outs += [fixed["fluence"], fixed["exitance"],
             torch.empty((n_all,), **f32), torch.empty((n_all,), **f32)]
    if n_det:
        ins += [ppath, det_geom]
        outs += [ppath if inplace else torch.empty((n_all, n_media), **f32),
                 fixed["det_w"], fixed["det_ppath"]]
    if jac_cols:
        ins += [jac_w, jac_col]
    if record:
        outs += [torch.empty((n_all,), **i32), torch.empty((n_all,), **i32)]
    if jac_cols:
        outs += [fixed["jac"]]
    if stats:
        outs += [torch.empty((n_all, 2), **f32)]
    assert len(outs) == spec.output_arity(n_det, record, jac_cols, stats,
                                          packed_state=False)
    groups = group_mask(n_det, record, jac_cols, stats)
    taylor = cfg.deposit_mode == "taylor"
    ints = (n, nx, ny, nz, n_steps, ntg,
            int(not cfg.specialize and not taylor), int(bool(cfg.do_reflect)),
            int(taylor), groups, n_det, n_media, jac_cols, S,
            nvox if stacked else 0, int(totals is not None), THREADS,
            -(-n // THREADS))
    floats = (float(unitinmm), ph.gate_scale(cfg.tmax_ns, ntg),
              float(cfg.tmax_ns), float(cfg.w_threshold),
              float(cfg.roulette_m), 1.0 / float(cfg.roulette_m))
    return groups, ins, outs, ints, floats


def pack(ins, outs, ints, floats):
    """The C entry point's four arrays: input and output pointers
    (uint64), ``ints`` (int32) and ``floats`` (float32)."""
    return (array.array("Q", [x.data_ptr() for x in ins]),
            array.array("Q", [x.data_ptr() for x in outs]),
            array.array("i", ints), array.array("f", floats))


def photon_step_cuda(labels_flat, media, state: ph.PhotonState, shape,
                     unitinmm, cfg: SimConfig, n_steps: int, ppath=None,
                     det_geom=None, record=False, jac_w=None, jac_col=None,
                     jac_cols: int = 0, stats: bool = False, totals=None,
                     inplace: bool = False):
    """Advance all lanes ``n_steps`` segments on the card; returns what
    ``ref.photon_steps_ref`` returns, output group by output group, the
    grids bit-equal to it.  ``totals`` and a ``(S, n_media, 4)`` media
    table (S scenarios) are as there; with ``inplace`` the returned state
    (and ``ppath``) are the input tensors, rewritten (``prepare``).

    Every tensor must be contiguous on one CUDA device, with the dtypes
    of ``photon.PhotonState`` and labels in ``[0, n_media)`` (the
    simulator checks that once per volume).  ``ppath`` is ``(n,
    n_media)`` float32, ``det_geom`` ``(n_det, 3)`` float32, ``jac_w``
    ``(n,)`` float32 and ``jac_col`` ``(n,)`` int32 in
    ``[0, jac_cols)``: a lane with a column outside it adds nothing and
    flags the device, and ``check_errors`` then raises; so does a
    fixed-point deposit or sum beyond its range.  Invalid group
    combinations raise ``ValueError`` (``spec.check_groups``).
    """
    dev = state.w.device
    if dev.type != "cuda":
        raise ValueError(f"photon_step_cuda needs CUDA tensors, got {dev}")
    groups, ins, outs, ints, floats = prepare(
        labels_flat, media, state, shape, unitinmm, cfg, n_steps, ppath,
        det_geom, record, jac_w, jac_col, jac_cols, stats, totals, inplace)
    lib = _library(groups)
    arrays = pack(ins, outs, ints, floats)
    ptrs = [a.buffer_info()[0] for a in arrays]
    # the current stream's handle without building a Stream object
    # (torch.cuda.current_stream(index).cuda_stream gives the same)
    index = torch.cuda.current_device()
    if dev.index is None or dev.index == index:
        err = lib.photon_step_launch(
            *ptrs, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(dev):
            err = lib.photon_step_launch(
                *ptrs, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        msg = lib.photon_step_error_string(err).decode()
        raise KernelError(f"photon_step kernel launch failed: {msg} ({err})")
    S = ints[13]
    count_launch(variant_name(groups, cfg) + (f"/x{S}" if S > 1 else ""))
    return (ph.PhotonState(*outs[:len(spec.STATE_FIELDS)]),
            *outs[len(spec.STATE_FIELDS):])


_COUNT_LOCK = threading.Lock()
# each thread's error words, one a device
_ERROR_WORDS = threading.local()
# each thread's launch counts held back while it captures a CUDA graph
_DEFERRED = threading.local()


# Bits of the error word (csrc/photon_step.cu kErrJacCol, kErrOverflow).
ERR_JAC_COL, ERR_OVERFLOW = 1, 2


def _error_word(dev: torch.device) -> torch.Tensor:
    """The calling thread's int32 error flags on the device, which the
    thread's launches may set."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    words = _ERROR_WORDS.__dict__.setdefault("by_device", {})
    if dev not in words:
        words[dev] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return words[dev]


def check_errors(device=None) -> None:
    """Raise if a launch of the calling thread on ``device`` (``None``:
    the current CUDA device) since its last check flagged an error:
    ``OverflowError`` for a fixed-point deposit or sum beyond its range
    (the kernel added nothing for it), ``ValueError`` for a ``jac_col``
    outside ``[0, jac_cols)`` (that lane added nothing).  One host read;
    clears the thread's flags."""
    word = _error_word(torch.device("cuda" if device is None else device))
    flags = int(word.item())
    if flags:
        word.zero_()
        if flags & ERR_OVERFLOW:
            raise OverflowError("a photon-step launch met a fixed-point "
                                "deposit or sum beyond 2**63 - 1 units")
        raise ValueError("a photon-step launch got a jac_col outside "
                         "[0, jac_cols); those lanes added nothing")


def count_launch(key: str) -> None:
    """Add one launch of ``key`` to ``photon_step_cuda.launches_by``
    (threads launch at once: the add holds a lock), or to the counts of
    the calling thread's :func:`deferred_launches` block."""
    held = getattr(_DEFERRED, "counts", None)
    if held is not None:
        held[key] += 1
        return
    with _COUNT_LOCK:
        photon_step_cuda.launches_by[key] += 1


@contextlib.contextmanager
def deferred_launches():
    """Count the launches the calling thread issues inside the block in
    the ``Counter`` it yields, not in ``photon_step_cuda.launches_by``:
    under a CUDA graph capture a launch runs only when the graph is
    replayed, and the replays add its counts (:func:`add_launches`)."""
    counts = collections.Counter()
    _DEFERRED.counts = counts
    try:
        yield counts
    finally:
        _DEFERRED.counts = None


def add_launches(counts) -> None:
    """Add another process's launch counts (a child's reply) to
    ``photon_step_cuda.launches_by``."""
    with _COUNT_LOCK:
        photon_step_cuda.launches_by.update(counts)


def reset_launches() -> None:
    """Set the launch counts to zero."""
    photon_step_cuda.launches_by = collections.Counter()


reset_launches()
