"""Inference artifacts — the on-disk format the reference's
serve/artifact.py writes, read and written by the port.

An artifact is a directory:

* ``<table>.param.r<start>-<stop>.npy`` — frozen weight-table rows in
  the checkpoint row-range shard format (utils/checkpoint.py);
* ``dense.<name>.npy`` — the dense (MLP) parameters of wide_deep, dcn
  and two_tower, listed by name under the manifest's ``"dense"``;
* ``remap.npy`` — the hot-table frequency remap (io/freq.py), present
  iff the model was trained with a hot table: request keys go through
  it before scoring;
* ``manifest.json`` — format version, model name, the FULL training
  config JSON plus its digest (config.Config.digest), array metadata,
  and the train-step counter.

A retrieval model's artifact may also hold an item index
(:func:`export_item_index`): ``item_index.npy`` [N, index_dim] item-tower
embeddings, ``item_ids.npy``, the catalog's padded feature planes
(``item_keys/item_slots/item_vals.npy``, ``item_nnz.npy``) and
``item_index.json`` (count, width, config digest, servable).

Either package loads what the other writes.  :func:`export_artifact`
freezes a trainer's model; :func:`write_artifact` writes the same files
from numpy tables.  A model trained under ``store_mode="tiered"``
exports its folded logical table (store/tiered.py
``iter_logical_param_shards``) in ``CHUNK_ROWS`` row ranges, as the
reference does (serve/artifact.py:110-135): the artifact is then
indistinguishable from a dense export.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from collections.abc import Iterator

import numpy as np

from xflow_tpu_torch.chaos import failpoint
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.utils.checkpoint import range_file

MANIFEST = "manifest.json"
FORMAT = 1
REMAP_FILE = "remap.npy"
ITEM_INDEX_META = "item_index.json"


def servable_digest(config_digest: str, step: int) -> str:
    """Identity of one SERVABLE — a (config, train-step) point in the
    continuous-training chain (the reference's docs/CONTINUOUS.md)."""
    return hashlib.sha256(
        f"{config_digest}@{int(step)}".encode()
    ).hexdigest()[:16]


def write_artifact(
    directory: str, cfg: Config, tables: dict[str, np.ndarray], step: int,
    remap: np.ndarray | None = None, dense: dict[str, np.ndarray] | None = None,
) -> str:
    """Write ``tables`` ({name: [T, dim] float32}, one per table of
    ``cfg``'s model, or an iterator of (start, stop, rows) blocks
    covering [0, T) in order), the ``dense`` parameters ({name: float32
    array}, exactly the model's) and a hot model's ``remap`` as an
    artifact at ``directory``, replaced atomically if it exists; returns
    the path.  One row-range shard per table or block, the reference's
    manifest."""
    from xflow_tpu_torch.models import dense_shapes, make_model

    if bool(cfg.hot_size_log2) != (remap is not None):
        raise ValueError(
            "a hot-table model's artifact carries its remap, and only "
            f"then (hot_size_log2={cfg.hot_size_log2}, remap "
            f"{'given' if remap is not None else 'missing'})"
        )
    specs = make_model(cfg).tables()
    if set(tables) != {spec.name for spec in specs}:
        raise ValueError(
            f"model {cfg.model!r} has tables "
            f"{sorted(spec.name for spec in specs)}, got {sorted(tables)}"
        )
    dense = dense or {}
    want = set(dense_shapes(make_model(cfg)))
    if set(dense) != want:
        raise ValueError(f"model {cfg.model!r} has dense parameters {sorted(want)}, "
                         f"got {sorted(dense)}")
    parent = os.path.dirname(os.path.abspath(directory))
    tmp = os.path.join(parent, f".tmp-artifact-{os.path.basename(directory)}")
    os.makedirs(parent, exist_ok=True)
    if os.path.exists(tmp):  # leftover from a crashed attempt
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        arrays_meta = {}
        for spec in sorted(specs, key=lambda s: s.name):
            table = tables[spec.name]
            blocks = table if isinstance(table, Iterator) else [(0, cfg.table_size, table)]
            key = f"{spec.name}.param"
            covered = 0
            for start, stop, arr in blocks:
                arr = np.asarray(arr)
                shape = (stop - start, spec.dim)
                if start != covered or arr.shape != shape or arr.dtype != np.float32:
                    raise ValueError(
                        f"table {spec.name!r} rows [{start}, {stop}) must be float32 "
                        f"{shape} from row {covered}, got {arr.dtype} {arr.shape}"
                    )
                np.save(range_file(tmp, key, start, stop), arr)
                covered = stop
            if covered != cfg.table_size:
                raise ValueError(f"table {spec.name!r} covers {covered} of "
                                 f"{cfg.table_size} rows")
            arrays_meta[key] = {"shape": [cfg.table_size, spec.dim], "dtype": "float32"}
        for dname in sorted(dense):
            np.save(os.path.join(tmp, f"dense.{dname}.npy"),
                    np.asarray(dense[dname], np.float32))
        if remap is not None:
            np.save(os.path.join(tmp, REMAP_FILE), np.asarray(remap, np.int32))
        manifest = {
            "format": FORMAT,
            "model": cfg.model,
            "step": int(step),
            "config": cfg.to_json(),
            "config_digest": cfg.digest(),
            "arrays": arrays_meta,
            "dense": sorted(dense),
            "remap": remap is not None,
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
    One host: the tables are fetched from the device once each, or under
    the tiered store folded from both tiers a chunk at a time."""
    from xflow_tpu_torch.convert import dense_to_numpy, state_to_numpy

    store = trainer.step.store
    if store is not None:
        tables = {name: store.iter_logical_param_shards(trainer.state, name)
                  for name in trainer.state["tables"]}
    else:
        tables = state_to_numpy(trainer.state)
    return write_artifact(
        directory, trainer.cfg, tables,
        step=trainer.state["step"], remap=trainer.remap,
        dense=dense_to_numpy(trainer.state),
    )


def load_dense(directory: str, manifest: dict) -> dict[str, np.ndarray]:
    """The artifact's dense parameters by the manifest's ``"dense"``
    list ({} for a table-only model)."""
    return {name: np.load(os.path.join(directory, f"dense.{name}.npy"))
            for name in manifest.get("dense", [])}


def load_remap(directory: str, manifest: dict) -> np.ndarray | None:
    """The artifact's hot remap, or None when the manifest says it has
    none (PredictEngine refuses a hot model without one)."""
    if not manifest.get("remap"):
        return None
    return np.load(os.path.join(directory, REMAP_FILE))


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


def _atomic_save(directory: str, name: str, arr: np.ndarray) -> None:
    tmp = os.path.join(directory, f".tmp-{name}")
    with open(tmp, "wb") as f:  # file object: np.save never re-suffixes
        np.save(f, arr)
    os.replace(tmp, os.path.join(directory, name))


def item_catalog_from_block(
    block, split_field: int, max_items: int = 0
) -> list[tuple]:
    """Deduplicated item catalog in the featurize_raw row protocol
    from one parsed libffm block: each sample's ITEM-side features
    (slots >= ``split_field``) form a candidate, identified by its
    sorted key set.  The ONE copy of the catalog-identity rule, shared
    by the ``serve index`` CLI and the cascade smoke gate so the
    shipped tool and the tier-1 gate cannot diverge."""
    import numpy as np  # local: the module-level import exists; keep explicit

    items: list[tuple] = []
    seen: set[tuple] = set()
    for i in range(block.num_samples):
        lo, hi = int(block.row_ptr[i]), int(block.row_ptr[i + 1])
        ks = block.keys[lo:hi].astype(np.int64)
        ss = block.slots[lo:hi].astype(np.int32)
        sel = ss >= split_field
        ident = tuple(sorted(ks[sel]))
        if ident and ident not in seen:
            seen.add(ident)
            items.append((ks[sel], ss[sel], None))
        if max_items and len(items) >= max_items:
            break
    return items


def export_item_index(engine, directory: str, item_rows: list, item_ids=None) -> dict:
    """Freeze a retrieval model's item-tower embeddings into a serve-time
    index inside the already-exported artifact ``directory`` (the
    reference's export_item_index: the same files and meta).
    ``item_rows`` is the catalog in the ``featurize_raw`` row protocol
    (item-side features), ``item_ids`` each row's external id (default
    the ordinal); ``engine`` must carry the artifact's digest.  Writes
    ``item_index.npy`` [N, index_dim], ``item_ids.npy``, the padded
    feature planes and ``item_index.json``; returns the meta."""
    failpoint("artifact.export")
    manifest = load_manifest(directory)
    if engine.digest != manifest["config_digest"]:
        raise ValueError(
            f"export_item_index: engine digest {engine.digest} != "
            f"artifact {directory} digest {manifest['config_digest']} "
            "— the index must be computed by the model it ships with"
        )
    if not hasattr(engine.model, "item_embed"):
        raise ValueError(
            f"model {engine.cfg.model!r} has no item tower "
            "(models/__init__.py registry: retrieval=False) — only "
            "two-tower-factored families export an item index"
        )
    n = len(item_rows)
    if n < 1:
        raise ValueError("export_item_index: empty item catalog")
    emb = engine.item_embeddings(item_rows)  # [N, index_dim]
    ids = (np.arange(n, dtype=np.int64) if item_ids is None
           else np.asarray(item_ids, dtype=np.int64))
    if len(ids) != n:
        raise ValueError(f"export_item_index: {n} rows but {len(ids)} item_ids")
    k = engine.cfg.max_nnz
    keys = np.zeros((n, k), np.int64)
    slots = np.zeros((n, k), np.int32)
    vals = np.zeros((n, k), np.float32)
    nnz = np.zeros(n, np.int32)
    for i, row in enumerate(item_rows):
        rk, rs, rv = row if isinstance(row, tuple) else (row, None, None)
        rk = np.asarray(rk)
        m = min(len(rk), k)
        nnz[i] = m
        keys[i, :m] = rk[:m]
        if rs is not None:
            slots[i, :m] = np.asarray(rs)[:m]
        vals[i, :m] = 1.0 if rv is None else np.asarray(rv)[:m]
    _atomic_save(directory, "item_index.npy", emb.astype(np.float32))
    _atomic_save(directory, "item_ids.npy", ids)
    _atomic_save(directory, "item_keys.npy", keys)
    _atomic_save(directory, "item_slots.npy", slots)
    _atomic_save(directory, "item_vals.npy", vals)
    _atomic_save(directory, "item_nnz.npy", nnz)
    meta = {
        "count": n,
        "dim": int(emb.shape[1]),
        "nnz": int(k),
        "config_digest": engine.digest,
        "servable": engine.servable_digest,
        "created_unix": round(time.time(), 3),
    }
    tmp = os.path.join(directory, ".tmp-" + ITEM_INDEX_META)
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(tmp, os.path.join(directory, ITEM_INDEX_META))
    return meta


def load_item_index(directory: str) -> dict | None:
    """The index :func:`export_item_index` wrote, or None when the
    artifact has none.  Refuses (ValueError) an index whose config
    digest does not match the artifact's manifest: a stale index left by
    a re-export under another config."""
    failpoint("artifact.load")
    path = os.path.join(directory, ITEM_INDEX_META)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        meta = json.load(f)
    manifest = load_manifest(directory)
    if meta.get("config_digest") != manifest["config_digest"]:
        raise ValueError(
            f"{directory}: item index was built for config "
            f"{meta.get('config_digest')!r} but the artifact is "
            f"{manifest['config_digest']!r} — re-run export_item_index "
            "against the current artifact"
        )
    out = dict(meta)
    for name in ("item_index", "item_ids", "item_keys", "item_slots", "item_vals",
                 "item_nnz"):
        out[name] = np.load(os.path.join(directory, f"{name}.npy"))
    if out["item_index"].shape != (meta["count"], meta["dim"]):
        raise ValueError(
            f"{directory}: item_index.npy shape {out['item_index'].shape} does "
            f"not match meta ({meta['count']}, {meta['dim']})"
        )
    return out
