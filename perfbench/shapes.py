"""A configuration's volume from MCX's shape list, as host arrays.

The reference's own rasteriser of the labels, written apart from the
port's (``repro_torch/core/shapes.py``), from the configuration file's
``shapes``: a ``Grid`` fill, then each entry painting its tag over the
earlier ones, in order.  Voxel ``(i, j, k)`` (0-based) is the cube
``[i, i + 1) x [j, j + 1) x [k, k + 1)`` in grid units and is painted
when its centre lies inside the shape (MCX's ``OriginType`` 1):

  * ``ZLayers`` ``[z0, z1, tag]``: the slabs ``z0 <= k + 1 <= z1``;
  * ``Cylinder`` ``C0``, ``C1``, ``R``: the centres ``p`` with
    ``|(p - C0) x (C1 - C0)|^2 <= R^2 |C1 - C0|^2`` and
    ``0 <= (p - C0) . (C1 - C0) <= |C1 - C0|^2``, in float64.

Row 0 of the media is the exterior, row ``t`` the medium of tag ``t``.
"""

from __future__ import annotations

import numpy as np

AIR = (0.0, 0.0, 1.0, 1.0)


def _zlayers(labels: np.ndarray, layers) -> None:
    k1 = np.arange(labels.shape[2]) + 1      # 1-based slab index
    for z0, z1, tag in layers:
        labels[:, :, (k1 >= z0) & (k1 <= z1)] = tag


def _cylinder(labels: np.ndarray, spec: dict) -> None:
    """Paint the cylinder one x slab at a time (each slab's centres as
    a ``(ny, nz, 3)`` array)."""
    c0 = np.asarray(spec["C0"], np.float64)
    axis = np.asarray(spec["C1"], np.float64) - c0
    aa = float(axis @ axis)
    r2aa = float(spec["R"]) ** 2 * aa
    _, ny, nz = labels.shape
    jk = np.stack(np.meshgrid(np.arange(ny), np.arange(nz), indexing="ij"),
                  axis=-1).astype(np.float64)
    for i in range(labels.shape[0]):
        p = np.concatenate([np.full((ny, nz, 1), float(i)), jk],
                           axis=-1) + 0.5 - c0          # centre less C0
        cross = np.cross(p, axis)
        along = p @ axis
        inside = ((np.sum(cross * cross, axis=-1) <= r2aa)
                  & (along >= 0.0) & (along <= aa))
        labels[i][inside] = spec["Tag"]


def build(volume: dict) -> tuple[np.ndarray, np.ndarray, float]:
    """``(labels, media, unitinmm)`` of a ``volume`` holding ``shapes``,
    ``media`` (``{"tag", "mua", "mus", "g", "n"}``, tags 1, 2, ... in
    order) and ``unitinmm``."""
    labels = None
    for entry in volume["shapes"]:
        if len(entry) != 1:
            raise ValueError(f"a shape entry has one key: {entry}")
        kind, spec = next(iter(entry.items()))
        if kind == "Grid":
            labels = np.empty([int(s) for s in spec["Size"]], np.uint8)
            labels.fill(spec["Tag"])
        elif labels is None:
            raise ValueError(f"{kind} before the Grid")
        elif kind == "ZLayers":
            _zlayers(labels, spec)
        elif kind == "Cylinder":
            _cylinder(labels, spec)
        else:
            raise ValueError(f"no shape {kind!r} here")
    if list(labels.shape) != [int(s) for s in volume["shape"]]:
        raise ValueError(f"Grid {labels.shape} is not shape "
                         f"{volume['shape']}")
    media = volume["media"]
    if [m["tag"] for m in media] != list(range(1, len(media) + 1)):
        raise ValueError("media tags must run 1, 2, ... in order")
    rows = [AIR] + [(m["mua"], m["mus"], m["g"], m["n"]) for m in media]
    if int(labels.max()) >= len(rows):
        raise ValueError(f"tag {int(labels.max())} has no medium")
    return labels, np.asarray(rows, np.float32), float(volume["unitinmm"])
