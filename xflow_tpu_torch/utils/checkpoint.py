"""Checkpoint / resume (the reference's utils/checkpoint.py, in its
on-disk format: a checkpoint either package writes restores in the
other).

A checkpoint is a directory ``ckpt-<step:010d>`` holding every table
array (param + optimizer state, e.g. FTRL n/z) as row-range files
``<table>.<array>.r<start>-<stop>.npy``, the dense (MLP) parameters as
``dense.<name>.npy``, and ``manifest.json`` (format 2: the step, each
array's shape and dtype, the dense names, the data cursor with
per-host positions, and the config JSON).  ``LATEST`` names the newest
generation.  The port trains on one device, so it writes one range
``[0, T)`` per array, as the reference does on one device; restore
assembles any target from whichever ranges exist via mmap, so a
checkpoint from a multi-device reference mesh restores here too.

The port's gradient buffer ``g`` (parallel/step.py::uses_grad_buffer)
has no counterpart in the reference's state: it is never written, and
a restore re-makes it as zeros on the state's device.  The step counter
is the port's Python int.

Commit protocol (crash-atomic): every array into a temp dir, the
manifest last, then one rename, then ``LATEST``, then the garbage
collection of old generations.  A manifest-less ``ckpt-*`` dir was
never committed; ``latest_complete`` and ``--resume auto`` skip it.
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
from typing import Any, Iterator

import numpy as np
import torch

from xflow_tpu_torch.chaos import failpoint

MANIFEST = "manifest.json"

_RANGE_RE = re.compile(r"\.r(\d+)-(\d+)\.npy$")


def range_file(directory: str, key: str, start: int, stop: int) -> str:
    """Path of the shard holding rows [start, stop) of ``key``."""
    return os.path.join(directory, f"{key}.r{start:012d}-{stop:012d}.npy")


def all_ok(local_ok: bool) -> bool:
    """True iff every process reports success.  The port runs one
    process (multi-process training is ROADMAP A13), so this is
    ``local_ok``; the save keeps the reference's three votes so that
    its failure paths stay the reference's."""
    return local_ok


class IncompatibleCheckpoint(ValueError):
    """Checkpoint exists but cannot be loaded by this version (e.g. a
    pre-sharded-format manifest).  Trainer.restore treats it as
    'no usable checkpoint' rather than crashing."""


def iter_owned_shards(arr: torch.Tensor) -> Iterator[tuple[int, int, np.ndarray]]:
    """(start_row, stop_row, host_data) for every row range this
    process writes: the whole array ``[0, T)``, read with one ``.cpu()``
    (one device owns every row)."""
    yield 0, arr.shape[0], arr.detach().cpu().numpy()


def _flat_arrays(state: dict[str, Any]) -> list[tuple[str, torch.Tensor]]:
    """(key, tensor) for every table array but the gradient buffer
    ``g``, in deterministic order."""
    out = []
    for tname in sorted(state["tables"]):
        for aname in sorted(state["tables"][tname]):
            if aname != "g":
                out.append((f"{tname}.{aname}", state["tables"][tname][aname]))
    return out


def save_checkpoint(
    directory: str,
    state: dict[str, Any],
    cursor: dict[str, Any],
    config_json: str | None = None,
    keep: int = 0,
) -> str:
    """Write one checkpoint; returns its path.  ``state`` is the train
    step's state; ``cursor`` is loader-position metadata (per-host
    cursors under ``cursor["cursors"]``, as trainer.save passes them).
    ``keep`` > 0 deletes all but the newest ``keep`` ckpt-* dirs after a
    successful save (0 = keep everything).  Each array comes to the host
    with one ``.cpu()``, which waits for the dispatched steps; at most
    one array's host copy is alive at a time."""
    step = int(state["step"])
    final = os.path.join(directory, f"ckpt-{step:010d}")
    tmp = os.path.join(directory, f".tmp-ckpt-{step:010d}")
    err: BaseException | None = None
    try:
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):  # leftover from a crashed attempt
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    except BaseException as e:
        err = e
    if not all_ok(err is None):
        if err is not None:
            raise err
        raise RuntimeError(f"checkpoint mkdir failed on process 0 (step {step})")
    try:
        # chaos site: a fire mid-write leaves the previous committed
        # generation the newest complete one
        failpoint("ckpt.write_shard")
        arrays_meta: dict[str, Any] = {}
        for key, arr in _flat_arrays(state):
            for start, stop, host_data in iter_owned_shards(arr):
                arrays_meta[key] = {
                    "shape": list(arr.shape),
                    "dtype": str(host_data.dtype),
                }
                np.save(range_file(tmp, key, start, stop), host_data)
                del host_data
        for dname in sorted(state.get("dense", {})):
            np.save(
                os.path.join(tmp, f"dense.{dname}.npy"),
                state["dense"][dname].detach().cpu().numpy(),
            )
    except BaseException as e:
        err = e
    if not all_ok(err is None):
        shutil.rmtree(tmp, ignore_errors=True)
        if err is not None:
            raise err
        raise RuntimeError(f"checkpoint save failed on another process (step {step})")
    try:
        manifest = {
            "format": 2,
            "step": step,
            "arrays": arrays_meta,
            "dense": sorted(state.get("dense", {})),
            "cursor": cursor,
            "config": config_json,
        }
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2)
        # chaos site: a kill mid-commit — the manifest is in tmp but
        # the rename never runs, so latest_complete() never sees it
        failpoint("ckpt.finalize")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _write_latest(directory, os.path.basename(final))
        if keep > 0:
            gc_checkpoints(directory, keep)
    except BaseException as e:
        err = e
    if not all_ok(err is None):
        shutil.rmtree(tmp, ignore_errors=True)
        if err is not None:
            raise err
        raise RuntimeError(f"checkpoint finalize failed on process 0 (step {step})")
    return final


def gc_checkpoints(directory: str, keep: int) -> list[str]:
    """Delete all but the newest ``keep`` COMPLETE ckpt-* dirs (by step
    number — the zero-padded name sorts chronologically); returns the
    deleted paths.  A manifest-less dir neither takes a keep slot nor
    is deleted (it is evidence), and the dir LATEST names is never
    deleted."""
    assert keep > 0
    cands = sorted(
        d
        for d in os.listdir(directory)
        if d.startswith("ckpt-")
        and os.path.isdir(os.path.join(directory, d))
        and is_complete(os.path.join(directory, d))
    )
    latest = None
    marker = os.path.join(directory, "LATEST")
    if os.path.exists(marker):
        with open(marker) as f:
            latest = f.read().strip()
    removed = []
    for d in cands[:-keep]:
        if d == latest:
            continue
        path = os.path.join(directory, d)
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    return removed


def _write_latest(directory: str, name: str) -> None:
    tmp = os.path.join(directory, ".latest.tmp")
    with open(tmp, "w") as f:
        f.write(name)
    os.replace(tmp, os.path.join(directory, "LATEST"))


def latest_checkpoint(directory: str) -> str | None:
    """The generation LATEST names, else the newest ckpt-* dir."""
    marker = os.path.join(directory, "LATEST")
    if os.path.exists(marker):
        with open(marker) as f:
            name = f.read().strip()
        path = os.path.join(directory, name)
        if os.path.exists(path):
            return path
    if not os.path.isdir(directory):
        return None
    cands = sorted(d for d in os.listdir(directory) if d.startswith("ckpt-"))
    return os.path.join(directory, cands[-1]) if cands else None


def checkpoint_candidates(directory: str) -> list[str]:
    """Every ckpt-* generation path, NEWEST first.  .tmp-ckpt-*
    leftovers from crashed saves are never candidates."""
    if not os.path.isdir(directory):
        return []
    cands = sorted(
        (
            d
            for d in os.listdir(directory)
            if d.startswith("ckpt-") and os.path.isdir(os.path.join(directory, d))
        ),
        reverse=True,
    )
    return [os.path.join(directory, d) for d in cands]


def is_complete(path: str) -> bool:
    """A generation is COMPLETE iff its manifest exists (the commit
    protocol writes it before the rename)."""
    return os.path.exists(os.path.join(path, MANIFEST))


def latest_complete(directory: str) -> str | None:
    """Newest COMPLETE generation, ignoring the LATEST marker — what
    ``--resume auto`` falls back to after a kill mid-checkpoint."""
    for path in checkpoint_candidates(directory):
        if is_complete(path):
            return path
    return None


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
        # chaos site: a per-shard read fault during restore or an
        # artifact load
        failpoint("ckpt.read_shard")
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


def load_checkpoint(
    path: str, state: dict[str, Any]
) -> tuple[dict[str, Any], dict[str, Any]]:
    """Restore into the shapes and device of the freshly initialized
    ``state`` template; returns (new_state, cursor).  Each array is read
    through RangeReader and moved to the template's device (the card
    unless the trainer was asked for the CPU), one array's host copy at
    a time; a template table with a gradient buffer gets it back as
    zeros."""
    failpoint("ckpt.restore")
    if not is_complete(path):
        raise IncompatibleCheckpoint(
            f"checkpoint {path} has no {MANIFEST} — incomplete or "
            "externally corrupted generation (the commit protocol "
            "writes the manifest before the rename, so this was never "
            "fully committed)"
        )
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != 2:
        raise IncompatibleCheckpoint(
            f"checkpoint {path} has unsupported format "
            f"{manifest.get('format')!r} (expected 2)"
        )
    if "store" in manifest:
        raise IncompatibleCheckpoint(
            f"checkpoint {path} was written by store_mode='tiered' "
            "(tier-erased fold; store/tiered.py) — set "
            "store_mode='tiered' to restore it"
        )

    new_tables: dict[str, Any] = {}
    for tname, table in state["tables"].items():
        new_tables[tname] = {}
        for aname, arr in table.items():
            if aname == "g":
                new_tables[tname][aname] = torch.zeros_like(arr)
                continue
            key = f"{tname}.{aname}"
            meta = manifest["arrays"].get(key)
            if meta is None:
                raise ValueError(f"checkpoint {path} missing array {key}")
            if tuple(meta["shape"]) != tuple(arr.shape):
                raise ValueError(
                    f"checkpoint array {key} shape {tuple(meta['shape'])} "
                    f"!= state {tuple(arr.shape)}"
                )
            reader = RangeReader(path, key, arr.shape, np.dtype(meta["dtype"]))
            host = reader.read()
            new_tables[tname][aname] = torch.from_numpy(host).to(arr.device)
            del host
    new_dense: dict[str, Any] = {}
    for dname, arr in state.get("dense", {}).items():
        fname = os.path.join(path, f"dense.{dname}.npy")
        if not os.path.exists(fname):
            raise ValueError(f"checkpoint {path} missing dense array {dname}")
        host = np.load(fname)
        if host.shape != tuple(arr.shape):
            raise ValueError(
                f"checkpoint dense {dname} shape {host.shape} != {tuple(arr.shape)}"
            )
        new_dense[dname] = torch.from_numpy(host).to(arr.device)
    new_state = {
        "tables": new_tables,
        "dense": new_dense,
        "step": int(manifest["step"]),
    }
    return new_state, manifest["cursor"]
