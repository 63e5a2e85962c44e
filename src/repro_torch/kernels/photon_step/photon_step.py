"""Build, binding and wrapper of the CUDA photon-step kernel.

The kernel (``csrc/photon_step.cu``) replaces the TPU kernel
``repro/kernels/photon_step/photon_step.py::photon_step_pallas`` (base
output group).  It advances every photon lane ``n_steps`` segments with
one thread per lane and the state in registers, and accumulates
fluence and exitance with float32 atomics; the source file's header
says what bounds it on the card and what the design does about that.

It is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/repro_torch/`` at the root of the checkout (git-ignored), under
a name keyed by a hash of the source and the flags, and loaded with
``ctypes`` through a plain C entry point.  ``photon_step_cuda`` checks
its inputs, allocates its outputs with ``torch.empty``/``zeros``,
launches on PyTorch's current stream and raises if the launch fails.
``photon_step_cuda.launches`` counts its launches.
"""

from __future__ import annotations

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


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the photon-step kernel")


def library_path() -> pathlib.Path:
    """Where the built kernel library lives, keyed by source and flags."""
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"photon_step_{key.hexdigest()[:16]}.so"


def build_library() -> pathlib.Path:
    """Compile the kernel if its library is not built yet; returns its
    path.  The compiler's output (``-Xptxas -v``: registers, spills)
    is kept beside it in a ``.log`` file.  A failed build raises."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    lib.photon_step_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_void_p]
    lib.photon_step_launch.restype = ctypes.c_int
    lib.photon_step_error_string.argtypes = [ctypes.c_int]
    lib.photon_step_error_string.restype = ctypes.c_char_p
    return lib


def load() -> float:
    """Build (if needed) and load the kernel library; returns seconds."""
    t0 = time.perf_counter()
    _library()
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
    """Advance all lanes ``n_steps`` segments on the card; returns
    ``(new_state, fluence_flat, exitance_flat, escaped_per_lane,
    timed_per_lane)`` as ``ref.photon_steps_ref`` does.

    Every tensor must be contiguous on one CUDA device, with the dtypes
    of ``photon.PhotonState`` and labels in ``[0, n_media)`` (the
    simulator checks that once per volume).  The optional output groups
    raise ``NotImplementedError`` until their kernels are ported.
    """
    spec.reject_optional_groups(ppath, det_geom, record, jac_w, jac_col,
                                jac_cols, stats)
    dev = state.w.device
    if dev.type != "cuda":
        raise ValueError(f"photon_step_cuda needs CUDA tensors, got {dev}")
    nx, ny, nz = (int(s) for s in shape)
    nvox, nxy = nx * ny * nz, nx * ny
    n = state.w.shape[0]
    ntg = int(cfg.n_time_gates)
    n_steps = int(n_steps)
    if ntg < 1 or n_steps < 0:
        raise ValueError(f"need n_time_gates >= 1 and n_steps >= 0, got "
                         f"{ntg} and {n_steps}")
    if nvox * ntg >= 2**31:
        raise ValueError(f"fluence grid of {nvox * ntg} cells is too large")
    _check("labels_flat", labels_flat, torch.uint8, (nvox,), dev)
    _check("media", media, torch.float32, (media.shape[0], 4), dev)
    for name, dtype, width in (("pos", torch.float32, (3,)),
                               ("dir", torch.float32, (3,)),
                               ("ivox", torch.int32, (3,)),
                               ("w", torch.float32, ()),
                               ("s_left", torch.float32, ()),
                               ("t", torch.float32, ()),
                               ("rng", torch.int64, (4,)),
                               ("alive", torch.bool, ())):
        _check(name, getattr(state, name), dtype, (n,) + width, dev)

    new = ph.PhotonState(*(torch.empty_like(x) for x in state))
    fluence = torch.zeros((nvox * ntg,), dtype=torch.float32, device=dev)
    exitance = torch.zeros((nxy,), dtype=torch.float32, device=dev)
    escaped = torch.empty((n,), dtype=torch.float32, device=dev)
    timed = torch.empty((n,), dtype=torch.float32, device=dev)

    ins = [labels_flat, media, *state]
    outs = [*new, fluence, exitance, escaped, timed]
    in_ptrs = (ctypes.c_void_p * len(ins))(*(x.data_ptr() for x in ins))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(x.data_ptr() for x in outs))
    taylor = cfg.deposit_mode == "taylor"
    ints = (ctypes.c_int * 9)(
        n, nx, ny, nz, n_steps, ntg,
        int(not cfg.specialize and not taylor), int(bool(cfg.do_reflect)),
        int(taylor))
    floats = (ctypes.c_float * 6)(
        float(unitinmm), ph.gate_scale(cfg.tmax_ns, ntg), float(cfg.tmax_ns),
        float(cfg.w_threshold), float(cfg.roulette_m),
        1.0 / float(cfg.roulette_m))
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.photon_step_launch(in_ptrs, out_ptrs, ints, floats, stream)
    if err != 0:
        msg = lib.photon_step_error_string(err).decode()
        raise RuntimeError(f"photon_step kernel launch failed: {msg} ({err})")
    photon_step_cuda.launches += 1
    return new, fluence, exitance, escaped, timed


photon_step_cuda.launches = 0
