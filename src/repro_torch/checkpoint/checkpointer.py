"""Fault-tolerant checkpointing: atomic, versioned, keep-k.

Serializes nested state (dicts, lists, tuples and NamedTuples of torch
tensors, numpy arrays and numbers, such as a campaign's int64 totals)
to one .npz per checkpoint plus a JSON manifest.  Writes go to a temp
name and an atomic rename, so a crash mid-write can never corrupt the
latest checkpoint; ``restore()`` always loads the newest complete one.

The file layout is the reference's (``repro/checkpoint/checkpointer.py``):
the same ``step_<n>.npz`` and manifest names, and leaf keys that join a
leaf's path with ``/`` (dict keys, sequence indices, ``.field`` for a
NamedTuple field; a None subtree holds no leaf), so a checkpoint written
by one package restores through the other.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any

import numpy as np
import torch

_STEP_RE = re.compile(r"step_(\d+)\.npz$")
# dtypes an npz holds natively; others are stored as float32
_NATIVE = (np.float32, np.float64, np.int32, np.int64, np.uint32, np.uint64,  # reprolint: disable=REP301 - a dtype the checkpointer stores as is, no arithmetic
           np.int8, np.uint8, np.int16, np.uint16, np.bool_, np.float16)


def _children(tree):
    """``(key, child)`` pairs of a container node, or None for a leaf;
    dict keys in sorted order, as the reference's tree flattening."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _leaves(tree, prefix=()):
    """``(key, leaf)`` of every leaf of ``tree``, keys joined by ``/``."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield "/".join(prefix), tree
        return
    for k, child in kids:
        yield from _leaves(child, prefix + (k,))


def _to_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype in (torch.bfloat16,):  # no numpy dtype
            leaf = leaf.float()
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.type not in _NATIVE:
        arr = arr.astype(np.float32)
    return arr


def _flatten_to_arrays(tree) -> dict[str, np.ndarray]:
    return {key: _to_array(leaf) for key, leaf in _leaves(tree)}


def _rebuild(template, data, prefix=()):
    """``template``'s structure with each leaf read from ``data``: a
    tensor leaf comes back as a tensor of its dtype and device, any
    other leaf with a dtype as a numpy array of it."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        arr = data["/".join(prefix)]
        if isinstance(template, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(
                dtype=template.dtype, device=template.device)
        if hasattr(template, "dtype"):
            return arr.astype(template.dtype)
        return arr
    values = [_rebuild(child, data, prefix + (k,)) for k, child in kids]
    if isinstance(template, dict):
        return dict(zip((k for k in sorted(template)), values))
    if hasattr(template, "_fields"):
        return type(template)(*values)
    return type(template)(values)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 process_suffix: str = ""):
        self.dir = directory
        self.keep = keep
        self.suffix = process_suffix
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}{self.suffix}.npz")

    def save(self, step: int, tree: Any, extra: dict | None = None):
        arrays = _flatten_to_arrays(tree)
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        os.close(fd)
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, self._path(step))  # atomic
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        manifest = {
            "step": step,
            "keys": sorted(arrays.keys()),
            "extra": extra or {},
        }
        mtmp = self._path(step) + ".manifest.tmp"
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, self._path(step) + ".manifest.json")
        self._gc()

    def steps(self) -> list[int]:
        out = []
        for fn in os.listdir(self.dir):
            m = _STEP_RE.search(fn)
            # only count checkpoints whose manifest landed (complete)
            if m and os.path.exists(os.path.join(self.dir, fn)
                                    + ".manifest.json"):
                out.append(int(m.group(1)))
        return sorted(set(out))

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def manifest(self, step: int | None = None) -> dict:
        """Read one checkpoint's manifest (``step``/``keys``/``extra``)
        without loading the arrays: the resilience layer stamps its
        merge counters into ``extra`` so a restarting campaign (or an
        operator) can inspect progress cheaply."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with open(self._path(step) + ".manifest.json") as f:
            return json.load(f)

    def restore(self, template: Any, step: int | None = None
                ) -> tuple[int, Any]:
        """Load a checkpoint (the newest by default) into ``template``'s
        structure; returns ``(step, tree)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with np.load(self._path(step), allow_pickle=False) as data:
            return step, _rebuild(template, data)

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            for ext in ("", ".manifest.json"):
                p = self._path(s) + ext
                if os.path.exists(p):
                    os.unlink(p)
