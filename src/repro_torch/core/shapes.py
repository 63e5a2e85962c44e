"""MCX's shape primitives, turned into uint8 label grids.

An MCX JSON input describes its volume as a ``Shapes`` list applied in
order, each entry painting its tag over what the earlier ones left:

  * ``{"Grid": {"Tag": t, "Size": [nx, ny, nz]}}`` fills the grid;
  * ``{"ZLayers": [[z0, z1, t], ...]}`` paints the z slabs ``z0..z1``
    (1-based, inclusive);
  * ``{"Cylinder": {"Tag": t, "C0": [...], "C1": [...], "R": r}}``
    paints the voxels whose centres lie within ``r`` of the segment
    ``C0``-``C1`` (grid units).

Voxel ``(i, j, k)`` (0-based) has its centre at ``(i + 0.5, j + 0.5,
k + 0.5)`` in grid units (MCX's ``OriginType`` 1), formed in float64 on
the host as the port's sphere and cube volumes are formed.
"""

from __future__ import annotations

import numpy as np


def grid(size, tag: int) -> np.ndarray:
    """An ``(nx, ny, nz)`` uint8 grid filled with ``tag``."""
    return np.full(tuple(int(s) for s in size), int(tag), np.uint8)


def zlayers(labels: np.ndarray, layers) -> np.ndarray:
    """Paint each ``[z0, z1, tag]`` slab (1-based, inclusive) in place."""
    for z0, z1, tag in layers:
        labels[:, :, int(z0) - 1:int(z1)] = int(tag)
    return labels


def _centres(shape) -> list[np.ndarray]:
    """Voxel centres along each axis, broadcastable over the grid."""
    out = []
    for axis, n in enumerate(shape):
        c = np.arange(n, dtype=np.float64) + 0.5  # reprolint: disable=REP301 - host-side rasterisation in double, as MCX
        out.append(c.reshape([-1 if a == axis else 1 for a in range(3)]))
    return out


def cylinder(labels: np.ndarray, c0, c1, radius: float,
             tag: int) -> np.ndarray:
    """Paint, in place, the voxels whose centres lie within ``radius`` of
    the segment from ``c0`` to ``c1`` (grid units): the squared distance
    from the axis, ``|v|^2 - (v.u)^2 / |u|^2`` with ``v`` the centre less
    ``c0`` and ``u = c1 - c0``, at most ``radius**2``, and the centre's
    projection on the axis inside the segment."""
    p0 = np.asarray(c0, np.float64)  # reprolint: disable=REP301 - host-side rasterisation in double, as MCX
    u = np.asarray(c1, np.float64) - p0  # reprolint: disable=REP301 - host-side rasterisation in double, as MCX
    uu = float(u @ u)
    if uu == 0.0:
        raise ValueError("a cylinder needs C0 != C1")
    v = [c - p for c, p in zip(_centres(labels.shape), p0)]
    vu = v[0] * u[0] + v[1] * u[1] + v[2] * u[2]
    vv = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    inside = ((vv - vu * vu / uu <= float(radius) ** 2)
              & (vu >= 0.0) & (vu <= uu))
    labels[inside] = int(tag)
    return labels


def rasterize(shapes) -> np.ndarray:
    """The uint8 labels of an MCX ``Shapes`` list; it must start with a
    ``Grid``, which sets the size."""
    labels = None
    for entry in shapes:
        (kind, spec), = entry.items()
        if kind == "Grid":
            labels = grid(spec["Size"], spec["Tag"])
        elif labels is None:
            raise ValueError(f"{kind!r} before any 'Grid'")
        elif kind == "ZLayers":
            zlayers(labels, spec)
        elif kind == "Cylinder":
            cylinder(labels, spec["C0"], spec["C1"], spec["R"], spec["Tag"])
        else:
            raise ValueError(f"unknown MCX shape {kind!r}")
    if labels is None:
        raise ValueError("an MCX shape list needs a 'Grid'")
    return labels
