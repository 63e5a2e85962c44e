"""A configuration's volume as host arrays, built from its file.

The labels and the media table are made here, from the configuration's
numbers, and handed alike to the port (``volume_from_arrays``) and to
the plain reference.  Label 0 is the exterior, label 1 the background
medium, each inclusion the next label.  Voxel centres are formed in
float64, as MCX's benchmark scripts and the port's builders form them.
"""

from __future__ import annotations

import numpy as np

AIR = (0.0, 0.0, 1.0, 1.0)


def _row(medium: dict) -> tuple[float, float, float, float]:
    return (medium["mua"], medium["mus"], medium["g"], medium["n"])


def build(volume: dict) -> tuple[np.ndarray, np.ndarray, float]:
    """``(labels, media, unitinmm)``: ``(nx, ny, nz)`` uint8 labels and
    the ``(n_media, 4)`` float32 rows of ``(mua, mus, g, n)``."""
    nx, ny, nz = (int(s) for s in volume["shape"])
    unit = float(volume["unitinmm"])
    labels = np.ones((nx, ny, nz), np.uint8)
    rows = [AIR, _row(volume["background"])]
    centres = [(np.arange(s) + 0.5) * unit for s in (nx, ny, nz)]
    gx, gy, gz = np.meshgrid(*centres, indexing="ij")
    for inc in volume.get("inclusions", ()):
        if inc["shape"] != "sphere":
            raise ValueError(f"unknown inclusion shape {inc['shape']!r}")
        cx, cy, cz = inc["center_mm"]
        r2 = (gx - cx) ** 2 + (gy - cy) ** 2 + (gz - cz) ** 2
        labels[r2 <= float(inc["radius_mm"]) ** 2] = len(rows)
        rows.append(_row(inc["medium"]))
    return labels, np.asarray(rows, np.float32), unit
