"""Build, binding and wrapper of the host (CPU) photon-step kernel.

The kernel (``csrc/photon_step_cpu.cpp``) is the CPU device's
counterpart of the CUDA kernel: it replaces the TPU kernel
``repro/kernels/photon_step/photon_step.py::photon_step_pallas`` with
every output group, for CPU tensors, and gives the plain version's bits
(``ref.photon_steps_ref``) at any thread count.  Its source header says
how it runs and why.

The source is compiled with ``g++`` (C++17, ``-ffp-contract=off``, no
fast math) at first use into ``BUILD_DIR`` (``build/repro_torch/`` at
the root of the checkout, git-ignored), one library for every output
group, under a name keyed by a hash of the source, the flags and the
torch it builds against; it takes one turn on the CUDA kernel's build
lock, and is loaded with ``ctypes`` through a plain C entry point that
takes the CUDA entry point's arrays (``photon_step.prepare`` and
``pack``).  The flags come from the running torch: its headers, the
CPU capability its kernels dispatch to (``-mavx2`` / ``-mavx512*``),
its C++ ABI, and its OpenMP runtime, which the library links instead of
a second one (``-fopenmp`` when torch's intra-op backend is OpenMP).

``photon_step_host`` checks its inputs, launches on torch's intra-op
threads and raises ``KernelError`` when the build, the load or the
launch fails, and when there is no ``g++``: never the plain version in
its place.  What a launch flags (a Jacobian column out of range, a
fixed-point overflow) is raised at once, as ``photon_step.check_errors``
raises it for a card.  Given the round loop's ``RoundTail``, the
wrapper updates it after the launch with the plain tail
(``ref.round_tail_ref``), the bits of the card's epilogue.  Launches
are counted in ``photon_step_cuda.launches_by`` under ``host_key``
(``host/`` before the CUDA variant's name), those given a tail once
more under ``host/`` and ``photon_step.TAIL_KEY``, so the counts of a
device's process cover both kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

import torch

from repro_torch.core import photon as ph
from repro_torch.core.volume import SimConfig
from repro_torch.kernels.photon_step import photon_step as K
from repro_torch.kernels.photon_step import ref as R
from repro_torch.kernels.photon_step import spec

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "photon_step_cpu.cpp"
BUILD_DIR = K.BUILD_DIR
# the plain version's float32 arithmetic, operation by operation
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-ffp-contract=off",
             "-fno-fast-math", "-Wall", "-Wno-unknown-pragmas")
# flags of each CPU capability ATen compiles its kernels for
_CAPABILITY_FLAGS = {
    "AVX512": ("-mavx512f", "-mavx512bw", "-mavx512vl", "-mavx512dq",
               "-mfma"),
    "AVX2": ("-mavx2", "-mfma", "-mf16c"),
}
HOST_PREFIX = "host/"
# The slot of the per-lane escaped weight in a launch's outputs (the
# timed-out weight follows it).
_ESC = len(spec.STATE_FIELDS) + spec.BASE_OUTPUTS.index("escaped")
KernelError = K.KernelError


def host_key(groups: int, cfg: SimConfig, scenarios: int = 1) -> str:
    """The launch-count key of a host launch, e.g.
    ``"host/reflect/exact/det+record"`` (``/xS`` for S > 1 scenarios)."""
    return HOST_PREFIX + K.variant_name(groups, cfg) + (
        f"/x{scenarios}" if scenarios > 1 else "")


def _compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise KernelError("g++ not found on PATH: it builds the host "
                          "photon-step kernel that CPU tensors run")
    return found


def _openmp_runtime() -> str:
    """The OpenMP runtime this process loaded with torch (its
    ``libgomp``, ``libiomp5`` or ``libomp``), which the library links so
    that one runtime serves both."""
    with open("/proc/self/maps") as f:
        paths = {line.split()[-1] for line in f if "/" in line}
    found = sorted(p for p in paths if re.search(
        r"/lib(gomp|iomp5|omp)[-\w]*\.so", p))
    if not found:
        raise KernelError("torch's intra-op backend is OpenMP but no OpenMP "
                          "runtime is loaded in this process")
    torch_lib = str(pathlib.Path(torch.__file__).parent)
    return next((p for p in found if p.startswith(torch_lib)), found[0])


@functools.cache
def build_flags() -> tuple[tuple[str, ...], tuple[str, ...]]:
    """``(compile, link)`` flags for the running torch."""
    from torch.utils import cpp_extension

    capability = torch.backends.cpu.get_cpu_capability()
    cflags = CXX_FLAGS + _CAPABILITY_FLAGS.get(capability, ()) + (
        f"-DCPU_CAPABILITY={capability}", f"-DCPU_CAPABILITY_{capability}",
        f"-D_GLIBCXX_USE_CXX11_ABI={int(torch.compiled_with_cxx11_abi())}")
    cflags += tuple(f"-I{p}" for p in cpp_extension.include_paths())
    lib_dirs = cpp_extension.library_paths()
    lflags = ("-shared",) + tuple(f"-L{p}" for p in lib_dirs) + (
        "-ltorch_cpu", "-lc10") + tuple(f"-Wl,-rpath,{p}" for p in lib_dirs)
    if "parallel backend: OpenMP" in torch.__config__.parallel_info():
        cflags += ("-fopenmp",)
        lflags = (_openmp_runtime(),) + lflags
    return cflags, lflags


def library_path() -> pathlib.Path:
    """Where the built host library lives, keyed by source, flags and
    torch."""
    cflags, lflags = build_flags()
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(
        cflags + lflags + (torch.__version__,)).encode())
    return BUILD_DIR / f"photon_step_cpu_{key.hexdigest()[:16]}.so"


def build_library() -> pathlib.Path:
    """Compile the host kernel if it is not built yet (one turn on the
    build lock); returns its path.  The compiler's output is kept beside
    it in a ``.log`` file.  A failed build raises ``KernelError``."""
    out = library_path()
    with K._build_lock():
        if out.exists():
            return out
        cflags, lflags = build_flags()
        obj = out.with_suffix(f".{os.getpid()}.o")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cxx = _compiler()
        log = []
        for cmd in ([cxx, *cflags, "-c", "-o", str(obj), str(_SRC)],
                    [cxx, "-o", str(tmp), str(obj), *lflags]):
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout)
            if proc.returncode != 0:
                obj.unlink(missing_ok=True)
                tmp.unlink(missing_ok=True)
                raise KernelError(f"g++ failed ({proc.returncode}):\n"
                                  f"{proc.stdout}")
        out.with_suffix(".log").write_text("\n".join(log))
        obj.unlink()
        os.replace(tmp, out)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    """The loaded host library, built at its first use."""
    path = build_library()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelError(f"cannot load {path.name}: {e}") from None
    lib.photon_step_cpu_launch.argtypes = [ctypes.c_void_p] * 4
    lib.photon_step_cpu_launch.restype = ctypes.c_int
    lib.photon_step_cpu_error_string.argtypes = [ctypes.c_int]
    lib.photon_step_cpu_error_string.restype = ctypes.c_char_p
    return lib


def load() -> float:
    """Build (if needed) and load the host library; returns seconds."""
    t0 = time.perf_counter()  # reprolint: disable=REP201 - build and load seconds, reported
    _library()
    return time.perf_counter() - t0  # reprolint: disable=REP201 - build and load seconds, reported


def kernel_threads() -> int:
    """The intra-op threads a launch from this thread runs on."""
    return int(_library().photon_step_cpu_threads())


def math_library() -> str:
    """``"mkl"`` when the kernel's transcendentals are MKL's VML
    functions (as torch's CPU operators are), ``"at::vec"`` otherwise."""
    return "mkl" if _library().photon_step_cpu_math() else "at::vec"


def photon_step_host(labels_flat, media, state: ph.PhotonState, shape,
                     unitinmm, cfg: SimConfig, n_steps: int, ppath=None,
                     det_geom=None, record=False, jac_w=None, jac_col=None,
                     jac_cols: int = 0, stats: bool = False, totals=None,
                     inplace: bool = False, tail=None):
    """Advance all lanes ``n_steps`` segments on the host's cores;
    returns what ``ref.photon_steps_ref`` returns, output group by
    output group, bit-equal to it.  The arguments are those of
    ``photon_step.photon_step_cuda``, on the CPU: contiguous tensors of
    ``photon.PhotonState``'s dtypes, labels in ``[0, n_media)``; with
    ``inplace`` the returned state (and ``ppath``) are the input
    tensors, rewritten; with ``tail`` the round's tail is updated from
    the launch's per-lane weights (``ref.round_tail_ref``) and the
    escaped and timed slots are None.

    A ``jac_col`` outside ``[0, jac_cols)`` adds nothing for its lane
    and raises ``ValueError`` after the launch; a fixed-point deposit or
    sum beyond its range raises ``OverflowError``.  Invalid group
    combinations raise ``ValueError`` (``spec.check_groups``)."""
    dev = state.w.device
    if dev.type != "cpu":
        raise ValueError(f"photon_step_host needs CPU tensors, got {dev}")
    groups, ins, outs, ints, floats = K.prepare(
        labels_flat, media, state, shape, unitinmm, cfg, n_steps, ppath,
        det_geom, record, jac_w, jac_col, jac_cols, stats, totals, inplace,
        tail)
    if tail is not None:  # the kernel writes the weights the tail sums
        outs[_ESC:_ESC + 2] = [torch.empty_like(state.w) for _ in range(2)]
    lib = _library()
    arrays = K.pack(ins, outs, ints, floats)
    err = lib.photon_step_cpu_launch(*[a.buffer_info()[0] for a in arrays])
    if err != 0:
        msg = lib.photon_step_cpu_error_string(err).decode()
        raise KernelError(f"host photon_step launch failed: {msg} ({err})")
    K.count_launch(host_key(groups, cfg, ints[13]))
    K.check_errors(dev)
    if tail is not None:
        alive = outs[spec.STATE_FIELDS.index("alive")]
        R.round_tail_ref(tail, *outs[_ESC:_ESC + 2], alive)
        outs[_ESC:_ESC + 2] = None, None
        K.count_launch(HOST_PREFIX + K.TAIL_KEY)
    return (ph.PhotonState(*outs[:len(spec.STATE_FIELDS)]),
            *outs[len(spec.STATE_FIELDS):])
