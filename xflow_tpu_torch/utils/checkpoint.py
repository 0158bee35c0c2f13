"""Row-range ``.npy`` shard reads (the reference's
utils/checkpoint.py ``RangeReader``).

Artifacts and checkpoints store each table as
``<key>.r<start>-<stop>.npy`` files, one per owned row range; a reader
assembles any row slice from whichever ranges exist, via mmap.  Writing
checkpoints, resume and garbage collection come with ROADMAP A6.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

_RANGE_RE = re.compile(r"\.r(\d+)-(\d+)\.npy$")


def range_file(directory: str, key: str, start: int, stop: int) -> str:
    """Path of the shard holding rows [start, stop) of ``key``."""
    return os.path.join(directory, f"{key}.r{start:012d}-{stop:012d}.npy")


class RangeReader:
    """Assembles arbitrary row/col slices of one array from its
    row-range .npy files via mmap — peak memory O(requested slice)."""

    def __init__(self, path: str, key: str, shape, dtype):
        self.files: list[tuple[int, int, str]] = []
        for f in sorted(glob.glob(os.path.join(path, glob.escape(key) + ".r*.npy"))):
            m = _RANGE_RE.search(f)
            if m:
                self.files.append((int(m.group(1)), int(m.group(2)), f))
        self.files.sort()
        covered = 0
        for start, stop, _ in self.files:
            if start > covered:
                break
            covered = max(covered, stop)
        if covered < shape[0]:
            raise ValueError(
                f"checkpoint {path}: array {key} rows [{covered}, {shape[0]}) "
                f"missing (found {len(self.files)} range files)"
            )
        self.shape = tuple(shape)
        self.dtype = dtype

    def read(self, idx: tuple = ()) -> np.ndarray:
        rows = idx[0] if idx else slice(None)
        a = rows.start or 0
        b = rows.stop if rows.stop is not None else self.shape[0]
        out = np.empty((b - a, *self.shape[1:]), dtype=self.dtype)
        for start, stop, fname in self.files:
            lo, hi = max(a, start), min(b, stop)
            if lo >= hi:
                continue
            data = np.load(fname, mmap_mode="r")
            out[lo - a : hi - a] = data[lo - start : hi - start]
        if len(idx) > 1 and idx[1] != slice(None):
            out = out[:, idx[1]]
        return out
