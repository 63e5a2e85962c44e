"""Build, binding and wrapper of the CUDA photon-step kernel.

The kernel (``csrc/photon_step.cu``) replaces the TPU kernel
``repro/kernels/photon_step/photon_step.py::photon_step_pallas`` with
every output group.  It advances every photon lane ``n_steps`` segments
with one thread per lane and the state in registers, and accumulates
fluence, exitance and the optional groups' sums with float32 atomics;
the source file's header says what bounds it on the card and what the
design does about that.

The source is compiled with ``nvcc`` for ``sm_90a`` once per set of
output groups (``PS_GROUPS``, a mask of ``GROUP_BITS``), at first use,
into ``build/repro_torch/`` at the root of the checkout (git-ignored),
under a name keyed by a hash of the source and the flags, and loaded
with ``ctypes`` through a plain C entry point.  ``build_all`` starts
every variant's ``nvcc`` at once.  ``photon_step_cuda`` checks its
inputs, allocates its outputs with ``torch.empty``/``zeros``, launches
on PyTorch's current stream and raises if the launch fails.
``photon_step_cuda.launches_by`` counts its launches by
``variant_name``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from repro_torch.core import photon as ph
from repro_torch.core.volume import SimConfig
from repro_torch.kernels.photon_step import spec

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "photon_step.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

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
    return "/".join(("reflect" if cfg.do_reflect else "noreflect",
                     cfg.deposit_mode, group_names(groups)))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the photon-step kernel")


def _flags(groups: int) -> tuple[str, ...]:
    if groups not in VALID_GROUPS:
        raise ValueError(f"no photon-step kernel for output-group mask "
                         f"{groups}; valid masks: {VALID_GROUPS}")
    return NVCC_FLAGS + (f"-DPS_GROUPS={groups}",)


def library_path(groups: int = 0) -> pathlib.Path:
    """Where the built kernel library of a group mask lives, keyed by
    source and flags."""
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_flags(groups)).encode())
    return BUILD_DIR / f"photon_step_g{groups}_{key.hexdigest()[:16]}.so"


def _start_build(groups: int):
    """Start ``nvcc`` for one group mask; returns ``(out, tmp, cmd,
    process)``, or ``None`` when the library is already built."""
    out = library_path(groups)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(groups), "-o", str(tmp), str(_SRC)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, cmd, proc


def _finish_build(started) -> None:
    out, tmp, cmd, proc = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_library(groups: int = 0) -> pathlib.Path:
    """Compile one group mask's kernel if it is not built yet; returns
    its path.  The compiler's output (``-Xptxas -v``: registers,
    spills) is kept beside it in a ``.log`` file.  A failed build
    raises."""
    started = _start_build(groups)
    if started is not None:
        _finish_build(started)
    return library_path(groups)


def build_all(groups=VALID_GROUPS) -> float:
    """Build the kernels of several group masks, one ``nvcc`` each, all
    started together; returns seconds.  Any failed build raises."""
    t0 = time.perf_counter()
    started = [x for x in map(_start_build, groups) if x is not None]
    errors = []
    for x in started:
        try:
            _finish_build(x)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


@functools.cache
def _library(groups: int) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(groups)))
    lib.photon_step_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_void_p]
    lib.photon_step_launch.restype = ctypes.c_int
    lib.photon_step_error_string.argtypes = [ctypes.c_int]
    lib.photon_step_error_string.restype = ctypes.c_char_p
    lib.photon_step_groups.restype = ctypes.c_int
    if lib.photon_step_groups() != groups:
        raise RuntimeError(f"{library_path(groups).name} was built for "
                           f"groups {lib.photon_step_groups()}, not {groups}")
    return lib


def load(groups=(0,)) -> float:
    """Build (if needed) and load the kernel libraries of ``groups``;
    returns seconds."""
    t0 = time.perf_counter()
    for g in groups:
        _library(g)
    return time.perf_counter() - t0


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


def photon_step_cuda(labels_flat, media, state: ph.PhotonState, shape,
                     unitinmm, cfg: SimConfig, n_steps: int, ppath=None,
                     det_geom=None, record=False, jac_w=None, jac_col=None,
                     jac_cols: int = 0, stats: bool = False):
    """Advance all lanes ``n_steps`` segments on the card; returns what
    ``ref.photon_steps_ref`` returns, output group by output group.

    Every tensor must be contiguous on one CUDA device, with the dtypes
    of ``photon.PhotonState`` and labels in ``[0, n_media)`` (the
    simulator checks that once per volume).  ``ppath`` is ``(n,
    n_media)`` float32, ``det_geom`` ``(n_det, 3)`` float32, ``jac_w``
    ``(n,)`` float32 and ``jac_col`` ``(n,)`` int32 in
    ``[0, jac_cols)``: a lane with a column outside it adds nothing and
    flags the device, and ``check_errors`` then raises.  Invalid group
    combinations raise ``ValueError`` (``spec.check_groups``).
    """
    n_det, record, jac_cols = spec.check_groups(ppath, det_geom, record,
                                                jac_w, jac_col, jac_cols)
    stats = bool(stats)
    dev = state.w.device
    if dev.type != "cuda":
        raise ValueError(f"photon_step_cuda needs CUDA tensors, got {dev}")
    nx, ny, nz = (int(s) for s in shape)
    nvox, nxy = nx * ny * nz, nx * ny
    n = state.w.shape[0]
    n_media = media.shape[0]
    ntg = int(cfg.n_time_gates)
    n_steps = int(n_steps)
    if ntg < 1 or n_steps < 0:
        raise ValueError(f"need n_time_gates >= 1 and n_steps >= 0, got "
                         f"{ntg} and {n_steps}")
    if nvox * ntg >= 2**31:
        raise ValueError(f"fluence grid of {nvox * ntg} cells is too large")
    _check("labels_flat", labels_flat, torch.uint8, (nvox,), dev)
    _check("media", media, torch.float32, (n_media, 4), dev)
    for name, dtype, width in (("pos", torch.float32, (3,)),
                               ("dir", torch.float32, (3,)),
                               ("ivox", torch.int32, (3,)),
                               ("w", torch.float32, ()),
                               ("s_left", torch.float32, ()),
                               ("t", torch.float32, ()),
                               ("rng", torch.int64, (4,)),
                               ("alive", torch.bool, ())):
        _check(name, getattr(state, name), dtype, (n,) + width, dev)

    f32 = dict(dtype=torch.float32, device=dev)
    new = ph.PhotonState(*(torch.empty_like(x) for x in state))
    fluence = torch.zeros((nvox * ntg,), **f32)
    exitance = torch.zeros((nxy,), **f32)
    escaped = torch.empty((n,), **f32)
    timed = torch.empty((n,), **f32)
    ins = [labels_flat, media, *state]
    outs = [*new, fluence, exitance, escaped, timed]
    if n_det:
        _check("ppath", ppath, torch.float32, (n, n_media), dev)
        _check("det_geom", det_geom, torch.float32, (n_det, 3), dev)
        ins += [ppath, det_geom]
        outs += [torch.empty((n, n_media), **f32),
                 torch.zeros((n_det * ntg,), **f32),
                 torch.zeros((n_det, n_media), **f32)]
    if jac_cols:
        _check("jac_w", jac_w, torch.float32, (n,), dev)
        _check("jac_col", jac_col, torch.int32, (n,), dev)
        ins += [jac_w, jac_col, _error_word(dev)]
    if record:
        outs += [torch.empty((n,), dtype=torch.int32, device=dev),
                 torch.empty((n,), dtype=torch.int32, device=dev)]
    if jac_cols:
        outs += [torch.zeros((nvox * jac_cols,), **f32)]
    if stats:
        outs += [torch.empty((n, 2), **f32)]

    groups = group_mask(n_det, record, jac_cols, stats)
    in_ptrs = (ctypes.c_void_p * len(ins))(*(x.data_ptr() for x in ins))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(x.data_ptr() for x in outs))
    taylor = cfg.deposit_mode == "taylor"
    ints = (ctypes.c_int * 13)(
        n, nx, ny, nz, n_steps, ntg,
        int(not cfg.specialize and not taylor), int(bool(cfg.do_reflect)),
        int(taylor), groups, n_det, n_media, jac_cols)
    floats = (ctypes.c_float * 6)(
        float(unitinmm), ph.gate_scale(cfg.tmax_ns, ntg), float(cfg.tmax_ns),
        float(cfg.w_threshold), float(cfg.roulette_m),
        1.0 / float(cfg.roulette_m))
    lib = _library(groups)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.photon_step_launch(in_ptrs, out_ptrs, ints, floats, stream)
    if err != 0:
        msg = lib.photon_step_error_string(err).decode()
        raise RuntimeError(f"photon_step kernel launch failed: {msg} ({err})")
    photon_step_cuda.launches_by[variant_name(groups, cfg)] += 1
    assert len(outs) == spec.output_arity(n_det, record, jac_cols, stats,
                                          packed_state=False)
    return (new, *outs[len(spec.STATE_FIELDS):])


_ERROR_WORDS: dict[torch.device, torch.Tensor] = {}


def _error_word(dev: torch.device) -> torch.Tensor:
    """The device's int32 error flags, which Jacobian launches set."""
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    if dev not in _ERROR_WORDS:
        _ERROR_WORDS[dev] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return _ERROR_WORDS[dev]


def check_errors(device=None) -> None:
    """Raise ``ValueError`` if a launch on ``device`` (``None``: the
    current CUDA device) since the last check met a ``jac_col`` outside
    ``[0, jac_cols)``; the kernel added nothing for such a lane.  One
    host read; clears the flags."""
    word = _error_word(torch.device("cuda" if device is None else device))
    flags = int(word.item())
    if flags:
        word.zero_()
        raise ValueError("a photon-step launch got a jac_col outside "
                         "[0, jac_cols); those lanes added nothing")


def reset_launches() -> None:
    """Set the launch counts to zero."""
    photon_step_cuda.launches_by = collections.Counter()


reset_launches()
