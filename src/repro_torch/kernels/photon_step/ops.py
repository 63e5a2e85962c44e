"""Public entry points of the photon-step kernel.

``photon_steps`` dispatches by the device of the photon state: CUDA
tensors go to the hand-written CUDA kernel
(``photon_step.photon_step_cuda``), CPU tensors to the hand-written host
kernel (``photon_step_cpu.photon_step_host``).  There is no fallback
from either to the other or to the plain PyTorch version
(``ref.photon_steps_ref``), which only direct calls reach: the tests,
``chip_smoke.py`` and the traced lint.
"""

from __future__ import annotations

import torch

from repro_torch.core import photon as ph
from repro_torch.core import rng as xrng
from repro_torch.core.volume import SimConfig, Volume
from repro_torch.kernels.photon_step.photon_step import photon_step_cuda
from repro_torch.kernels.photon_step.photon_step_cpu import photon_step_host
from repro_torch.sources import as_source


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device.  Asking for CUDA on a machine
    without one raises: the port never carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested (the default) but "
            "torch.cuda.is_available() is false; pass device='cpu' to run "
            "the host kernel on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def engine_of(device: torch.device) -> str:
    """The round executor a device runs, as spans and reports tag it:
    the kernel or its plain version."""
    return "kernel" if device.type == "cuda" else "plain"


def visible_devices(device_type: str = "cuda") -> list[torch.device]:
    """Every device of a type this process can use: each CUDA device
    (none raises, as :func:`resolve_device` does), or the one CPU."""
    if device_type == "cpu":
        return [torch.device("cpu")]
    resolve_device(device_type)
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def photon_steps(labels_flat, media, state, shape, unitinmm, cfg: SimConfig,
                 n_steps: int, ppath=None, det_geom=None,
                 record: bool = False, jac_w=None, jac_col=None,
                 jac_cols: int = 0, stats: bool = False, totals=None,
                 inplace: bool = False):
    """Returns ``(new_state, fluence, exitance, escaped_per_lane,
    timed_per_lane)`` and the optional output groups the arguments ask
    for (see ``ref.photon_steps_ref``: int64 fixed-point grids, added
    into ``totals`` when given, and a leading scenario axis for a
    ``(S, n_media, 4)`` media table): the CUDA kernel for CUDA tensors,
    the host kernel for CPU tensors.  ``inplace`` writes the new state
    and ``ppath`` over the inputs."""
    dev = state.w.device
    if dev.type == "cuda":
        fn = photon_step_cuda
    elif dev.type == "cpu":
        fn = photon_step_host
    else:
        raise ValueError(f"unsupported device {dev}")
    return fn(labels_flat, media, state, shape, unitinmm, cfg, n_steps,
              ppath=ppath, det_geom=det_geom, record=record, jac_w=jac_w,
              jac_col=jac_col, jac_cols=jac_cols, stats=stats,
              totals=totals, inplace=inplace)


def launch_ids(n: int, id_offset: int, device) -> xrng.PhotonId:
    """Ids ``id_offset .. id_offset + n - 1`` as 64-bit (lo, hi) words,
    with the low-word wraparound carried into the high word."""
    lo0, hi0 = xrng.split_id64(id_offset)
    return xrng.add_id(lo0, hi0,
                       torch.arange(n, dtype=torch.int64, device=device))


def fresh_state(volume: Volume, n_photons: int, seed: int = 1234,
                source=None, id_offset: int = 0) -> ph.PhotonState:
    """One freshly launched photon per lane, on the volume's device."""
    ids = launch_ids(n_photons, id_offset, volume.device)
    pos, direc, w0, rng = as_source(source).sample(ids, seed)
    active = torch.ones((n_photons,), dtype=torch.bool, device=volume.device)
    return ph.launch(pos, direc, w0, rng, active, volume.shape)


def simulate_kernel(volume: Volume, cfg: SimConfig, n_photons: int,
                    n_steps: int, seed: int = 1234, source=None,
                    device=None, id_offset: int = 0):
    """Launch one photon per lane and advance ``n_steps`` segments.

    Runs on ``device`` (``None``: CUDA) with the volume moved there;
    photon ``k`` of the run has global id ``id_offset + k``.
    """
    volume = volume.to(resolve_device(device))
    state = fresh_state(volume, n_photons, seed, source, id_offset)
    return photon_steps(volume.labels.reshape(-1), volume.media, state,
                        volume.shape, volume.unitinmm, cfg, n_steps)
