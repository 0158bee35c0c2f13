"""Inference artifacts — the on-disk format the reference's
serve/artifact.py writes, read and written by the port.

An artifact is a directory:

* ``<table>.param.r<start>-<stop>.npy`` — frozen weight-table rows in
  the checkpoint row-range shard format (utils/checkpoint.py);
* ``remap.npy`` — the hot-table frequency remap, present iff the model
  was trained with a hot table (the port does not serve those yet);
* ``manifest.json`` — format version, model name, the FULL training
  config JSON plus its digest (config.Config.digest), array metadata,
  and the train-step counter.

Either package loads what the other writes.  :func:`export_artifact`
freezes a trainer's model; :func:`write_artifact` writes the same files
from numpy tables.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

import numpy as np

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.utils.checkpoint import range_file

MANIFEST = "manifest.json"
FORMAT = 1
REMAP_FILE = "remap.npy"


def servable_digest(config_digest: str, step: int) -> str:
    """Identity of one SERVABLE — a (config, train-step) point in the
    continuous-training chain (the reference's docs/CONTINUOUS.md)."""
    return hashlib.sha256(
        f"{config_digest}@{int(step)}".encode()
    ).hexdigest()[:16]


def write_artifact(
    directory: str, cfg: Config, tables: dict[str, np.ndarray], step: int
) -> str:
    """Write ``tables`` ({name: [T, dim] float32}, one per table of
    ``cfg``'s model) as an artifact at ``directory``, replaced
    atomically if it exists; returns the path.  One row-range shard per
    table, the reference's manifest."""
    from xflow_tpu_torch.models import make_model

    specs = make_model(cfg).tables()
    if set(tables) != {spec.name for spec in specs}:
        raise ValueError(
            f"model {cfg.model!r} has tables "
            f"{sorted(spec.name for spec in specs)}, got {sorted(tables)}"
        )
    parent = os.path.dirname(os.path.abspath(directory))
    tmp = os.path.join(parent, f".tmp-artifact-{os.path.basename(directory)}")
    os.makedirs(parent, exist_ok=True)
    if os.path.exists(tmp):  # leftover from a crashed attempt
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        arrays_meta = {}
        for spec in sorted(specs, key=lambda s: s.name):
            arr = np.asarray(tables[spec.name])
            shape = (cfg.table_size, spec.dim)
            if arr.shape != shape or arr.dtype != np.float32:
                raise ValueError(
                    f"table {spec.name!r} must be float32 {shape}, got "
                    f"{arr.dtype} {arr.shape}"
                )
            key = f"{spec.name}.param"
            arrays_meta[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
            np.save(range_file(tmp, key, 0, arr.shape[0]), arr)
        manifest = {
            "format": FORMAT,
            "model": cfg.model,
            "step": int(step),
            "config": cfg.to_json(),
            "config_digest": cfg.digest(),
            "arrays": arrays_meta,
            "dense": [],
            "remap": False,
            "created_unix": round(time.time(), 3),
        }
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2)
        # never leave the target path without a loadable artifact: move
        # the old one ASIDE first, rename the new one in, THEN delete
        old = None
        if os.path.exists(directory):
            old = directory + ".old"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(directory, old)
        os.rename(tmp, directory)
        if old is not None:
            shutil.rmtree(old)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return directory


def export_artifact(trainer, directory: str) -> str:
    """Freeze ``trainer``'s model into a serving artifact at
    ``directory`` (replaced atomically if it exists); returns the path.
    One host: the tables are fetched from the device once each."""
    from xflow_tpu_torch.convert import state_to_numpy

    return write_artifact(
        directory, trainer.cfg, state_to_numpy(trainer.state),
        step=trainer.state["step"],
    )


def load_manifest(directory: str) -> dict:
    """Parse + integrity-check an artifact manifest.  Raises ValueError
    on a missing/foreign/future-format manifest or when the stored
    config digest doesn't match the embedded config (tampering or a
    digest-scheme drift — either way the artifact identity is void)."""
    path = os.path.join(directory, MANIFEST)
    if not os.path.exists(path):
        raise ValueError(f"{directory}: no artifact manifest ({MANIFEST})")
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(
            f"{directory}: unsupported artifact format "
            f"{manifest.get('format')!r} (expected {FORMAT})"
        )
    cfg = Config.from_json(manifest["config"])
    if cfg.digest() != manifest.get("config_digest"):
        raise ValueError(
            f"{directory}: manifest config_digest "
            f"{manifest.get('config_digest')!r} does not match the "
            f"embedded config ({cfg.digest()}) — artifact corrupt or "
            "tampered"
        )
    return manifest
