"""PredictEngine — the low-latency scoring tier, on PyTorch.

Loads a frozen artifact (serve/artifact.py), written by either package,
with no trainer and no optimizer state: the engine owns the model's
param-only tables on its device and the predict step.  As in the
reference (its serve/engine.py):

* **Shape buckets.**  Every request batch is padded onto a small fixed
  set of batch-size buckets (default 1/8/64/512) so the device only ever
  sees ``len(buckets)`` shapes per leg.  ``compile_count`` counts the
  distinct (leg, bucket shape) pairs run so far, as the reference keys
  its executables: after ``warm()`` it equals ``len(buckets)`` per warmed
  leg (predict, and top-k with an item index attached) and must stay
  there under any traffic mix and any ``k``.  Eager PyTorch compiles
  nothing, but the invariant is what a captured CUDA graph per bucket
  will need.
* **Digest-checked identity.**  ``load`` refuses an artifact whose
  manifest digest doesn't match its embedded config, or the caller's
  expected config.

One predict call is one K1 launch (ops/score.py); for wide_deep, dcn
and two_tower one K7 launch (ops/pool.py) and the dense head on
cuBLAS, with the artifact's dense parameters.  A retrieval model
(two_tower) also serves top-k: ``attach_item_index`` puts an item index
[N, index_dim] on the card (``load`` attaches the artifact's own), and
``topk`` runs K7, the user tower and one dot-product scan ``u @
index.T`` per bucket, then a stable descending sort, so tied scores
keep the lower index first as ``lax.top_k`` does.  The engine runs on
the card unless the caller passes ``device="cpu"``
(device.py::resolve_device).  A hot-table model needs its frequency
remap (the artifact's ``remap.npy``): request rows arrive in the raw
hash key space and are remapped and steered into the hot and cold
planes before scoring (io/batch.py::remap_batch), and a hot model
without its remap is refused, as the reference refuses it.  The tiered
store is refused at load with the
ROADMAP item that ports it; the failpoints and flight recorder come
with ROADMAP A14.
"""

from __future__ import annotations

import time
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.device import resolve_device
from xflow_tpu_torch.io.batch import Batch, pad_batch_rows, remap_batch
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.parallel.step import (
    PredictStep,
    check_servable,
    validate_compact_batch,
)

DEFAULT_BUCKETS = (1, 8, 64, 512)
DEFAULT_TOPK = 16


def _slice_rows(batch: Batch, start: int, stop: int) -> Batch:
    return Batch(
        keys=batch.keys[start:stop],
        slots=batch.slots[start:stop],
        vals=batch.vals[start:stop],
        mask=batch.mask[start:stop],
        labels=batch.labels[start:stop],
        weights=batch.weights[start:stop],
        hot_keys=batch.hot_keys[start:stop],
        hot_slots=batch.hot_slots[start:stop],
        hot_vals=batch.hot_vals[start:stop],
        hot_mask=batch.hot_mask[start:stop],
    )


class PredictEngine:
    """Bucketed predict over a frozen model state.

    Construct directly from a state (convert.py::state_from_numpy) or
    via ``load`` from an exported artifact.  ``state`` may carry
    optimizer slots; they are stripped to param-only tables.  A
    hot-table model needs its ``remap`` (io/freq.py)."""

    def __init__(
        self,
        cfg: Config,
        state: dict[str, Any],
        device: str | torch.device = "cuda",
        buckets: Sequence[int] | None = None,
        digest: str | None = None,
        warm: bool = False,
        remap: np.ndarray | None = None,
    ):
        check_servable(cfg)
        if cfg.hot_size_log2 and remap is None:
            raise ValueError(
                "model was trained with a hot table but no remap was "
                "provided — raw request keys cannot be translated"
            )
        self.cfg = cfg
        self.remap = remap
        self.digest = digest if digest is not None else cfg.digest()
        self.device = resolve_device(device)
        self.model = make_model(cfg)
        self.step = PredictStep(self.model, cfg, self.device)
        raw = tuple(buckets) if buckets else DEFAULT_BUCKETS
        if any(b < 1 for b in raw):
            raise ValueError(f"bucket sizes must be >= 1, got {raw}")
        self.buckets = tuple(sorted(set(raw)))
        self.state = self._strip_state(state)
        # Distinct (leg, rows, nnz) shapes run so far.  SHARED across
        # ``clone()`` replicas, so compile_count counts fleet-wide.
        self._shapes: set[tuple[str, int, int]] = set()
        self._parse_fn = None
        # the serve-time item index (retrieval families): attached by
        # ``load`` from the artifact's item_index.* files or by
        # ``attach_item_index``; ``topk`` refuses until one is
        self.item_index: dict | None = None
        self._index_arr: torch.Tensor | None = None
        self.topk_k = 0
        if warm:
            self.warm()

    @property
    def compile_count(self) -> int:
        return len(self._shapes)

    # -- construction ------------------------------------------------------

    @classmethod
    def load(
        cls,
        directory: str,
        config: Config | None = None,
        device: str | torch.device = "cuda",
        buckets: Sequence[int] | None = None,
        warm: bool = True,
        topk_k: int | None = None,
    ) -> "PredictEngine":
        """Load an exported artifact onto ``device`` (the card unless
        ``"cpu"`` is asked for), with its dense parameters and, when it
        holds one, its item index (``topk_k`` wide).  ``config``, when
        given, is the caller's expectation: its digest must equal the
        artifact's or the load is refused (never score through the
        wrong model)."""
        from xflow_tpu_torch.convert import state_from_numpy
        from xflow_tpu_torch.serve.artifact import (
            load_dense,
            load_item_index,
            load_manifest,
            load_remap,
        )
        from xflow_tpu_torch.utils.checkpoint import RangeReader

        dev = resolve_device(device)
        manifest = load_manifest(directory)
        cfg = Config.from_json(manifest["config"])
        digest = manifest["config_digest"]
        if config is not None and config.digest() != digest:
            raise ValueError(
                f"artifact {directory} was exported from config "
                f"{digest}, but the expected config digests to "
                f"{config.digest()} — refusing to serve a mismatched "
                "model"
            )
        check_servable(cfg)  # before reading any table shard
        tables: dict[str, np.ndarray] = {}
        for spec in make_model(cfg).tables():
            key = f"{spec.name}.param"
            meta = manifest["arrays"].get(key)
            if meta is None:
                raise ValueError(f"artifact {directory} missing {key}")
            reader = RangeReader(
                directory, key, tuple(meta["shape"]), np.dtype(meta["dtype"])
            )
            tables[spec.name] = reader.read()
        state = state_from_numpy(cfg, tables, dev, step=manifest["step"],
                                 dense=load_dense(directory, manifest))
        engine = cls(
            cfg, state, device=dev, buckets=buckets, digest=digest, warm=False,
            remap=load_remap(directory, manifest),
        )
        index = load_item_index(directory)
        if index is not None:
            engine.attach_item_index(index, topk_k=topk_k)
        if warm:  # after the index attach, so the top-k buckets warm too
            engine.warm()
        return engine

    def clone(self) -> "PredictEngine":
        """A replica view over the SAME weights and the SAME shape set —
        N replicas without N× the table memory.  Each replica gets its
        own PredictStep, as each is driven by its own batcher thread."""
        replica = PredictEngine(
            self.cfg,
            self.state,
            device=self.device,
            buckets=self.buckets,
            digest=self.digest,
            remap=self.remap,
        )
        replica._shapes = self._shapes
        replica.item_index = self.item_index
        replica._index_arr = self._index_arr
        replica.topk_k = self.topk_k
        return replica

    @staticmethod
    def _strip_state(state: dict[str, Any]) -> dict[str, Any]:
        """Param-only view of a (possibly full training) state."""
        return {
            "tables": {
                name: {"param": t["param"]}
                for name, t in state["tables"].items()
            },
            "dense": state.get("dense", {}),
            "step": state.get("step", 0),
        }

    @property
    def servable_digest(self) -> str:
        """Identity of the served (config, train step) point
        (serve/artifact.py::servable_digest)."""
        from xflow_tpu_torch.serve.artifact import servable_digest

        return servable_digest(self.digest, int(self.state["step"]))

    # -- warmup ------------------------------------------------------------

    def warm(self) -> float:
        """Run every bucket once (one all-padding batch each), and with
        an item index attached every top-k bucket too, so every serving
        shape has run before the first request; returns the seconds."""
        t0 = time.perf_counter()
        for b in self.buckets:
            self.predict(self._empty_batch(b))
            if self._index_arr is not None:
                self.topk(self._empty_batch(b))
        return time.perf_counter() - t0

    def _empty_batch(self, rows: int) -> Batch:
        k = self.cfg.max_nnz
        return Batch(
            keys=np.zeros((rows, k), np.int32),
            slots=np.zeros((rows, k), np.int32),
            vals=np.zeros((rows, k), np.float32),
            mask=np.zeros((rows, k), np.float32),
            labels=np.zeros(rows, np.float32),
            weights=np.zeros(rows, np.float32),
        )

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (the largest bucket for oversized
        requests — predict() chunks those)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    # -- featurize ---------------------------------------------------------

    def featurize_raw(self, rows: Sequence) -> Batch:
        """A Batch from single-row requests — feed it to ``predict``
        (which pads).  Each row is either a 1-D key array or a
        ``(keys, slots, vals)`` tuple (slots/vals may be None → 0 / 1.0,
        the hash-mode convention).  Features beyond ``max_nnz`` are
        truncated, like the training loader."""
        n = len(rows)
        k = self.cfg.max_nnz
        keys = np.zeros((n, k), np.int32)
        slots = np.zeros((n, k), np.int32)
        vals = np.zeros((n, k), np.float32)
        mask = np.zeros((n, k), np.float32)
        for i, row in enumerate(rows):
            if isinstance(row, tuple):
                rk, rs, rv = row
            else:
                rk, rs, rv = row, None, None
            rk = np.asarray(rk)
            m = min(len(rk), k)
            keys[i, :m] = rk[:m]
            if rs is not None:
                slots[i, :m] = np.asarray(rs)[:m]
            vals[i, :m] = 1.0 if rv is None else np.asarray(rv)[:m]
            mask[i, :m] = 1.0
        return Batch(
            keys=keys, slots=slots, vals=vals, mask=mask,
            labels=np.zeros(n, np.float32),
            weights=np.ones(n, np.float32),
        )

    def featurize(self, rows: Sequence) -> Batch:
        """``featurize_raw`` + widen + pad to the covering bucket: the
        Batch is ready for ``predict_prepared`` (the batcher's featurize
        leg).  ``rows`` must fit the largest bucket."""
        n = len(rows)
        if n > self.buckets[-1]:
            raise ValueError(
                f"featurize: {n} rows exceed the largest bucket "
                f"{self.buckets[-1]} — use predict(featurize_raw(rows))"
            )
        return pad_batch_rows(
            self._prepare(self.featurize_raw(rows)), self.bucket_for(n)
        )

    def score_text(self, lines: Iterable[str]) -> np.ndarray:
        """pctr for libffm-format text lines (``label\\tfgid:fid:val``,
        label ignored) — the CLI ``score`` path.  Parses with the
        artifact config's hashing and seed."""
        from xflow_tpu_torch.io.batch import pack_batch
        from xflow_tpu_torch.io.loader import make_parse_fn

        if self._parse_fn is None:
            cfg = self.cfg
            self._parse_fn = make_parse_fn(cfg.table_size, cfg.hash_mode, cfg.seed)
        data = "".join(
            line if line.endswith("\n") else line + "\n" for line in lines
        ).encode()
        block = self._parse_fn(data)
        n = block.num_samples
        if n == 0:
            return np.zeros(0, np.float32)
        out = []
        cap = self.buckets[-1]
        for s in range(0, n, cap):
            e = min(s + cap, n)
            raw = pack_batch(block, s, e, e - s, self.cfg.max_nnz)
            out.append(self.predict(raw))
        return np.concatenate(out)

    # -- retrieval: item index + top-k --------------------------------------

    def attach_item_index(self, index: dict, topk_k: int | None = None) -> None:
        """Arm the top-k mode with an item index (serve/artifact.py::
        load_item_index's dict, or any dict with ``item_index`` [N, D]
        and ``item_ids`` [N]): the scan operand goes to the device once;
        ``topk_k`` fixes the result width (DEFAULT_TOPK, capped at N)."""
        if not hasattr(self.model, "user_embed"):
            raise ValueError(
                f"model {self.cfg.model!r} has no user tower "
                "(models/__init__.py registry: retrieval=False) — "
                "top-k retrieval needs a two-tower-factored family"
            )
        emb = np.asarray(index["item_index"], np.float32)
        if emb.ndim != 2 or not len(emb):
            raise ValueError(f"item index must be [N, index_dim], got {emb.shape}")
        want = self.model.index_dim
        if emb.shape[1] != want:
            raise ValueError(
                f"item index rows are {emb.shape[1]} wide but model "
                f"{self.cfg.model!r} scans {want} lanes (tower_dim "
                f"{self.cfg.tower_dim} + 2 bias lanes) — the index was "
                "exported from a different tower geometry; re-run "
                "export_item_index"
            )
        self.item_index = dict(index)
        self.item_index["ids_order"] = np.argsort(np.asarray(index["item_ids"]),
                                                  kind="stable")
        self._index_arr = torch.tensor(emb, device=self.device)
        self.topk_k = min(topk_k if topk_k is not None else DEFAULT_TOPK, len(emb))
        if self.topk_k < 1:
            raise ValueError("topk_k must be >= 1")

    def _tower_run(self, leg: str, batch: Batch) -> torch.Tensor:
        """One prepared bucket-sized batch through K7 and a tower (the
        user tower for ``leg="topk"``, the item tower for
        ``"item_embed"``): [B, index_dim] on the device."""
        arrays = self.step.put_batch(batch)
        self._shapes.add((leg, batch.batch_size, batch.max_nnz))
        with torch.no_grad():
            pooled, _ = self.step.pool(self.state, arrays)
            tower = (self.model.user_from_pooled if leg == "topk"
                     else self.model.item_from_pooled)
            return tower(self.state["dense"], pooled)

    def topk_prepared(self, batch: Batch) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(item_ids [B, topk_k], scores [B, topk_k], user_emb [B, D])
        for one already-prepared bucket-sized batch: K7, the user
        tower, the scan against the index, a stable descending sort (a
        tie keeps the lower index first, as ``lax.top_k``)."""
        if self._index_arr is None:
            raise ValueError(
                "top-k refused: no item index attached — export one "
                "with serve.artifact.export_item_index (retrieval "
                "families only) or attach_item_index(...)"
            )
        u = self._tower_run("topk", batch)
        with torch.no_grad():
            scores = u @ self._index_arr.T  # [B, N]
            vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
            vals, idx = vals[:, :self.topk_k], idx[:, :self.topk_k]
        idx = idx.cpu().numpy()
        return self.item_index["item_ids"][idx], vals.cpu().numpy(), u.cpu().numpy()

    def topk(self, batch: Batch, k: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """(item_ids [B, k], scores [B, k]) for an externally built
        raw-key-space batch of user-side features.  Any batch size
        (padded and chunked like ``predict``); any ``k <= topk_k``
        slices the one result width, so mixed-k traffic adds no shape."""
        kk = self.topk_k if k is None else int(k)
        if kk < 1 or kk > self.topk_k:
            raise ValueError(
                f"k={kk} outside (0, topk_k={self.topk_k}] — the "
                "engine serves ONE top-k width; raise topk_k at "
                "load/attach time for deeper candidate sets"
            )
        n = batch.batch_size
        batch = self._prepare(batch)
        cap = self.buckets[-1]
        ids_out, score_out = [], []
        for s in range(0, n, cap):
            e = min(s + cap, n)
            chunk = pad_batch_rows(_slice_rows(batch, s, e), self.bucket_for(e - s))
            ids, vals, _ = self.topk_prepared(chunk)
            ids_out.append(ids[: e - s, :kk])
            score_out.append(vals[: e - s, :kk])
        return np.concatenate(ids_out), np.concatenate(score_out)

    def item_embeddings(self, rows: Sequence) -> np.ndarray:
        """Item-tower embeddings [len(rows), index_dim] for
        featurize_raw-protocol catalog rows: export_item_index's compute
        leg, bucket-chunked."""
        if not hasattr(self.model, "item_embed"):
            raise ValueError(
                f"model {self.cfg.model!r} has no item tower "
                "(registry: retrieval=False)"
            )
        cap = self.buckets[-1]
        out = []
        for s in range(0, len(rows), cap):
            chunk = rows[s:s + cap]
            b = pad_batch_rows(self._prepare(self.featurize_raw(chunk)),
                               self.bucket_for(len(chunk)))
            out.append(self._tower_run("item_embed", b).cpu().numpy()[: len(chunk)])
        return np.concatenate(out)

    # -- predict -----------------------------------------------------------

    def _prepare(self, batch: Batch) -> Batch:
        """Canonicalize an external raw-key-space batch: widen it so its
        total feature width (hot + cold) matches the training geometry's
        ``max_nnz`` with zero-mask columns (no new shapes), then apply
        the hot remap and steering (a no-op without a hot table).
        Wider batches keep their width (truncating would silently drop
        features) and run one extra shape per distinct width — the
        featurize tier only produces canonical widths."""
        cfg = self.cfg
        if batch.hot_nnz and not cfg.hot_size:
            raise ValueError(
                "batch carries hot planes but the model has no hot table"
            )
        total = batch.hot_nnz + batch.max_nnz
        if total < cfg.max_nnz:
            pad = cfg.max_nnz - total
            b = batch.batch_size
            z_i = np.zeros((b, pad), np.int32)
            z_f = np.zeros((b, pad), np.float32)
            batch = Batch(
                keys=np.concatenate([batch.keys, z_i], axis=1),
                slots=np.concatenate([batch.slots, z_i], axis=1),
                vals=np.concatenate([batch.vals, z_f], axis=1),
                mask=np.concatenate([batch.mask, z_f], axis=1),
                labels=batch.labels,
                weights=batch.weights,
                hot_keys=batch.hot_keys,
                hot_slots=batch.hot_slots,
                hot_vals=batch.hot_vals,
                hot_mask=batch.hot_mask,
            )
        return remap_batch(batch, self.remap, cfg.hot_size, cfg.hot_nnz)

    def predict(self, batch: Batch) -> np.ndarray:
        """pctr for one externally built Batch.  Any batch size: rows
        pad up to the smallest covering bucket; oversized batches chunk
        by the largest bucket.  Returns exactly ``batch.batch_size``
        values."""
        n = batch.batch_size
        batch = self._prepare(batch)
        cap = self.buckets[-1]
        if n <= cap:
            padded = pad_batch_rows(batch, self.bucket_for(n))
            return self.predict_prepared(padded)[:n]
        out = []
        for s in range(0, n, cap):
            e = min(s + cap, n)
            chunk = pad_batch_rows(
                _slice_rows(batch, s, e), self.bucket_for(e - s)
            )
            out.append(self.predict_prepared(chunk)[: e - s])
        return np.concatenate(out)

    def predict_prepared(self, batch: Batch) -> np.ndarray:
        """Run one already-prepared, bucket-sized batch on the device;
        returns pctr for every row (padding included).  This is the
        'device' leg of the batcher's latency accounting: h2d + execute
        + fetch."""
        if self.step.compact_wire:
            # serving traffic is heterogeneous: validate every batch, or
            # a value-carrying request would score with vals=1
            validate_compact_batch(batch)
        arrays = self.step.put_batch(batch)
        self._shapes.add(("predict", batch.batch_size, batch.max_nnz))
        return self.step.predict(self.state, arrays).cpu().numpy()
