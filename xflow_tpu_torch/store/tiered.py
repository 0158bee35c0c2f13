"""TieredStore — the orchestrator threading cold/hot/promote through
the train step, checkpoints and the serving export (the reference's
store/tiered.py).

Dataflow per train step (strictly sequential on the training thread —
the trainer runs without the staging ring under store_mode='tiered' so
the cold store has read-your-writes semantics):

    put_batch        complete the previous write-back → dedup keys
                     (io/compact.py::dedup_select) → hot-map lookup →
                     cold-fetch misses into (pinned) host blocks → ship
                     the refs planes, arm the plan
    dispatch_train   take the plan → the miss rows into the combined
                     buffers → the update over the view (store/hot.py)
                     → queue the miss rows' copy to the host and defer
                     (plan, rows, event) as the pending write-back
    maintain         complete the write-back → apply the promotion
                     worker's plan (demote: device read → cold write;
                     promote: cold take → device fill) between steps

Checkpoints FOLD both tiers into one tier-erased logical table: sorted
touched keys + packed rows in the utils/checkpoint.py row-range shard
format (``store.<table>.<arr>.r<start>-<stop>.npy``, the manifest's
``store`` section), the reference's files: a tiered checkpoint written
by either package restores in the other.  Restore loads everything
cold and lets promotion re-warm — the logical table (touched rows
exact, untouched rows re-derived from the deterministic per-row init)
is bitwise identical however rows were split across tiers at save
time.  Artifact export materializes the logical [T, D] param table in
bounded chunks (``iter_logical_param_shards``), so PredictEngine loads
a tiered model as a dense one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from collections import deque

import numpy as np
import torch

from xflow_tpu_torch.chaos import failpoint, retry_call
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.io.batch import Batch
from xflow_tpu_torch.io.compact import dedup_select, plane_cap
from xflow_tpu_torch.obs import Obs, emit_health
from xflow_tpu_torch.store.cold import ColdStore, ColdTableSpec
from xflow_tpu_torch.store.hot import PROMOTE_CAP, HotTier
from xflow_tpu_torch.store.promote import PromotionWorker
from xflow_tpu_torch.utils.checkpoint import (
    MANIFEST,
    IncompatibleCheckpoint,
    RangeReader,
    _write_latest,
    gc_checkpoints,
    is_complete,
)

# rows per checkpoint/export range file — bounds peak memory of the
# fold at 2^28 (a chunk is CHUNK_ROWS * D * 4 B, ~40 MiB at FM's D=10)
CHUNK_ROWS = 1 << 20


@dataclasses.dataclass
class BatchPlan:
    """Host-side half of one staged batch: which unique keys missed the
    hot tier, the cold rows shipped for them, and the touch note for the
    promotion worker (posted only when the plan is TAKEN by a train
    dispatch — predict/eval traffic must not steer tier placement)."""

    miss_keys: np.ndarray  # int64 [n_miss]
    miss_rows: dict  # {table: {arr: host float32 [mc, D]}} (padded)
    miss_nbytes: int
    touch: tuple  # (uniq, counts, miss) for PromotionWorker.note
    param_only: bool  # predict plan: param plane shipped alone


class TieredStore:
    def __init__(self, model, optimizer, cfg: Config, device: torch.device):
        self.model = model
        self.optimizer = optimizer
        self.cfg = cfg
        self.device = device
        self.hot = HotTier(model, optimizer, cfg, device)
        self.cold = ColdStore(
            {
                spec.name: ColdTableSpec(
                    dim=spec.dim,
                    arrays={
                        "param": (spec.init_kind, spec.init_scale),
                        **{a: ("zeros", 0.0) for a in self.hot._aux_names},
                    },
                )
                for spec in model.tables()
            },
            seed=cfg.seed,
        )
        # health/counter sink for paths with no per-call obs
        # (checkpoint/export/close flushes); the TrainStep binds its own
        self.obs = Obs()
        self.promoter: PromotionWorker | None = None
        # staged plans keyed by the IDENTITY of the arrays dict put_batch
        # returned, so a dispatch can never pair one batch's arrays with
        # another batch's plan; predict plans are staged and never taken,
        # and age out of the two-entry ring
        self._staged: deque = deque(maxlen=2)
        # (plan, {table: {arr: host rows}}, event or None)
        self._pending: tuple | None = None
        # a dead promotion worker is restarted exactly ONCE; a second
        # death leaves placement frozen (new keys stay all-miss)
        self._promoter_restarts = 0
        self._promoter_dead = False

    # -- per-batch planning -------------------------------------------------

    def _ensure_promoter(self, obs) -> None:
        if self.promoter is None:
            self.promoter = PromotionWorker(self.hot.capacity, obs=obs)

    def plan_batch(self, batch: Batch, obs=None, param_only: bool = False):
        """Resolve one Batch through the tier map: returns (refs, plan),
        ``refs`` the Batch to ship with each key replaced by its row in
        the combined space (hot slot, or Hc + its miss index) and the
        model-facing planes passed through, ``plan`` the host half.
        Read-only with respect to the store — the write-back happens at
        complete_pending() with the step's miss rows.  ``param_only``
        (predict/eval): fetch and ship only the param plane per miss."""
        if obs is None:
            obs = self.obs
        self._ensure_promoter(obs)
        if batch.hot_nnz:
            raise ValueError(
                "tiered store batches must not carry MXU hot planes "
                "(config validation enforces hot_size_log2=0)"
            )
        b, k = batch.keys.shape
        mask = batch.mask.reshape(-1) > 0
        flat = batch.keys.reshape(-1).astype(np.int64)
        live = flat[mask]
        if len(live):
            # the dictionary wire's dedup with an uncapped dictionary:
            # every unique key gets a code, codes index the unique list
            uniq, codes = dedup_select(live, dict_cap=len(live))
            codes = codes.astype(np.int64)
        else:
            uniq = np.zeros(0, np.int64)
            codes = np.zeros(0, np.int64)
        slots = self.hot.lookup(uniq)
        miss = slots < 0
        miss_keys = uniq[miss]
        n_miss = len(miss_keys)
        # granule-bucketed miss capacity (io/compact.py::plane_cap)
        mc = plane_cap(n_miss, b * k)
        miss_pos = np.cumsum(miss) - 1
        ref_of_u = np.where(miss, self.hot.capacity + miss_pos, slots)
        refs = np.zeros(b * k, np.int64)
        if len(live):
            refs[mask] = ref_of_u[codes]
        t0 = time.perf_counter()

        def fetch():
            # chaos site: transient cold-store read — bounded retry
            # heals it with zero data loss (the fetch is idempotent)
            failpoint("store.cold_fetch")
            return self.cold.fetch(
                miss_keys, planes=("param",) if param_only else None
            )

        fetched = retry_call(
            fetch,
            attempts=self.cfg.io_retries,
            backoff_s=self.cfg.io_retry_backoff_s,
            channel="store",
            site="cold_fetch",
            obs=obs,
        )
        miss_rows: dict = {}
        miss_nbytes = 0
        for tname, arrs in fetched.items():
            miss_rows[tname] = {}
            for aname, rows in arrs.items():
                block = self.hot.host_block(mc, rows.shape[1])
                host = block.numpy()
                host[:n_miss] = rows
                host[n_miss:] = 0.0
                miss_rows[tname][aname] = block
                miss_nbytes += host.nbytes
        obs.counter(
            "store.cold_fetch_seconds", time.perf_counter() - t0
        )
        counts = np.bincount(codes, minlength=len(uniq)).astype(np.int64)
        obs.counter("store.hit_occ", int(counts[~miss].sum()))
        obs.counter("store.miss_occ", int(counts[miss].sum()))
        obs.counter("store.miss_rows", n_miss)
        ref_batch = Batch(
            keys=refs.reshape(b, k).astype(np.int32),
            slots=batch.slots,
            vals=batch.vals,
            mask=batch.mask,
            labels=batch.labels,
            weights=batch.weights,
        )
        return ref_batch, BatchPlan(
            miss_keys=miss_keys,
            miss_rows=miss_rows,
            miss_nbytes=miss_nbytes,
            touch=(uniq, counts, miss),
            param_only=param_only,
        )

    # -- staging / write-back ----------------------------------------------

    def stage(self, arrays: dict, plan: BatchPlan) -> None:
        """Arm ``plan`` for the dispatch of exactly ``arrays`` (predict
        paths stage and never take — their entries age out of the
        identity ring)."""
        self._staged.append((arrays, plan))

    def take_staged(self, arrays: dict) -> BatchPlan:
        for i, (staged_arrays, plan) in enumerate(self._staged):
            if staged_arrays is arrays:
                del self._staged[i]
                if plan.param_only:
                    raise RuntimeError(
                        "dispatch_train on a predict-staged batch — "
                        "its miss blocks carry no optimizer slots; "
                        "stage train batches with put_batch(batch) "
                        "(predict=False)"
                    )
                if self.promoter is not None:
                    # taking a plan means this batch TRAINS: only now
                    # does its touch profile steer promotion
                    self.promoter.note(*plan.touch)
                return plan
        raise RuntimeError(
            "dispatch_train received arrays put_batch did not stage "
            "(or staged too long ago) — under store_mode='tiered' "
            "every dispatch must consume a put_batch result from the "
            "same step"
        )

    def defer_complete(self, plan: BatchPlan, miss_out: tuple) -> None:
        """``miss_out`` is HotTier.train's write-back: (host rows, the
        event recorded after their copies)."""
        self.complete_pending()  # invariant: at most one pending
        self._pending = (plan, *miss_out)

    def complete_pending(self, obs=None) -> None:
        """Flush the deferred write-back: wait for the step's miss rows
        to reach the host (their event) and upsert them into the cold
        store.  Called before every plan (read-your-writes), before
        maintenance, checkpoint save, export and close.  The upsert is
        idempotent, so a transient failure (``store.writeback``
        failpoint) retries safely."""
        if obs is None:
            obs = self.obs
        if self._pending is None:
            return
        plan, host, event = self._pending
        self._pending = None
        n = len(plan.miss_keys)
        if not n:
            return
        if event is not None:
            event.synchronize()

        def write():
            failpoint("store.writeback")
            self.cold.write(plan.miss_keys, {
                tname: {aname: rows.numpy() for aname, rows in arrs.items()}
                for tname, arrs in host.items()
            })

        retry_call(
            write,
            attempts=self.cfg.io_retries,
            backoff_s=self.cfg.io_retry_backoff_s,
            channel="store",
            site="writeback",
            obs=obs,
        )

    # -- tier maintenance ---------------------------------------------------

    def maintain(self, state: dict, obs=None) -> dict:
        """Between-steps application point: flush the write-back, check
        the promotion worker's pulse, then apply its plan (if any).
        Returns the (possibly rebound) device state."""
        if obs is None:
            obs = self.obs
        self.complete_pending(obs=obs)
        if self.promoter is None:
            return state
        if not self.promoter.alive() and not self._promoter_dead:
            self._heal_promoter(obs)
        if self._promoter_dead:
            return state
        plan = self.promoter.poll_plan()
        if plan is None:
            return state
        evict = [k for k in plan.get("evict", []) if k in self.hot.slot_of]
        promote = [
            k for k in plan.get("promote", [])
            if k not in self.hot.slot_of
        ]
        demoted: list[int] = []
        for chunk in _chunks(evict, PROMOTE_CAP):
            state = self._demote(state, chunk)
            demoted.extend(chunk)
        promote = promote[: self.hot.free_count]
        promoted: list[int] = []
        for chunk in _chunks(promote, PROMOTE_CAP):
            state = self._promote(state, chunk)
            promoted.extend(chunk)
        if promoted or demoted:
            obs.counter("store.promotions", len(promoted))
            obs.counter("store.demotions", len(demoted))
            self.promoter.ack(promoted, demoted)
        return state

    def _heal_promoter(self, obs) -> None:
        """The promotion worker died.  Restart ONCE — the fresh worker's
        empty hot_view self-corrects through maintain's slot_of filters
        + acks.  A second death leaves placement frozen: the store stays
        correct (hot hits keep hitting, new keys ride the miss path)
        with no more tier movement — degraded, loud, never corrupt."""
        crash = self.promoter.crashed
        self.promoter.close()  # dead thread: the join returns at once
        if self._promoter_restarts == 0:
            self._promoter_restarts += 1
            obs.counter("store.promote_restarts")
            emit_health(
                obs,
                cause="store_promote_restarted",
                channel="store",
                detail=f"promotion worker died "
                f"({type(crash).__name__ if crash else 'no exception'}"
                f"{f': {crash}' if crash else ''}) — restarted once",
            )
            self.promoter = PromotionWorker(self.hot.capacity, obs=obs)
        else:
            self._promoter_dead = True
            emit_health(
                obs,
                cause="store_promote_dead",
                channel="store",
                detail="promotion worker died again after its one "
                "restart — tier placement frozen (all-miss for new "
                "keys); training continues correctly",
            )

    def _demote(self, state: dict, keys: list[int]) -> dict:
        """Flush ``keys``' rows (param + optimizer slots) from the hot
        tier back to the cold store and free their slots."""
        karr = np.asarray(keys, np.int64)
        slots = np.asarray(
            [self.hot.slot_of[int(k)] for k in keys], np.int64
        )
        self.cold.write(karr, self.hot.read(state, slots))
        self.hot.release(karr)
        return state

    def _promote(self, state: dict, keys: list[int]) -> dict:
        """Move ``keys``' rows from the cold store into freshly
        assigned hot slots."""
        karr = np.asarray(keys, np.int64)
        rows = self.cold.take(karr)
        slots = self.hot.assign(karr)
        return self.hot.fill(state, slots, rows)

    def occupancy_frac(self) -> float:
        return self.hot.occupancy / self.hot.capacity

    def close(self) -> None:
        """Flush the write-back (best-effort — on a crash path the
        device may be the thing that died) and reap the promotion
        worker (bounded join; a leak surfaces as a health row)."""
        try:
            self.complete_pending()
        except Exception:  # noqa: BLE001 - crash-path cleanup
            self._pending = None
        if self.promoter is not None:
            self.promoter.close()

    # -- device state -------------------------------------------------------

    def init_device_state(self) -> dict:
        return self.hot.init_device_state()

    # -- logical-table views ------------------------------------------------

    def _hot_rows(self, state: dict, table: str, arr: str,
                  slots: np.ndarray) -> np.ndarray:
        """Host copies of the tier's rows at ``slots`` (one gather on
        the device, one copy to the host)."""
        idx = torch.as_tensor(np.asarray(slots, np.int64)).to(self.device)
        return state["tables"][table][arr].index_select(0, idx).cpu().numpy()

    def logical_rows(self, state: dict, table: str, keys: np.ndarray) -> dict:
        """{arr: [m, D]} — the logical table rows for ``keys``
        regardless of tier: hot slots read from the device, the rest
        from the cold store (stored or lazy-init)."""
        self.complete_pending()
        out = self.cold.fetch(keys)
        slots = self.hot.lookup(keys)
        sel = slots >= 0
        if sel.any():
            for aname in out[table]:
                out[table][aname][sel] = self._hot_rows(state, table, aname, slots[sel])
        return out[table]

    @staticmethod
    def _gather_fold(
        idx: np.ndarray,
        ncold: int,
        cold_rows: np.ndarray,
        hot_rows: np.ndarray,
    ) -> np.ndarray:
        """Rows for merged-index positions ``idx`` of the two-tier key
        space (cold keys first, hot keys appended — idx < ncold gathers
        the cold view, the rest offset into the hot host copy).  The
        ONE split-gather shared by the checkpoint fold and the export
        fold."""
        csel = idx < ncold
        block = np.empty((len(idx), cold_rows.shape[1]), np.float32)
        block[csel] = cold_rows[idx[csel]]
        block[~csel] = hot_rows[idx[~csel] - ncold]
        return block

    def iter_logical_param_shards(
        self, state: dict, table: str, chunk: int = CHUNK_ROWS
    ):
        """(start, stop, rows) blocks of the FULL logical [T, D] param
        table — lazy init overlaid with both tiers' live rows.  Peak
        extra memory is O(chunk) row data + O(touched keys) int64
        index; touched rows are gathered per chunk from the stores' own
        arrays.  serve/artifact.py writes these as the standard
        row-range shard files, so a tiered model exports to an artifact
        PredictEngine loads unchanged."""
        self.complete_pending()
        occupied = np.flatnonzero(self.hot.key_of >= 0)
        hkeys = self.hot.key_of[occupied]
        hrows = self._hot_rows(state, table, "param", occupied)
        ckeys, crows = self.cold.export_array(table, "param")  # views
        ncold = len(ckeys)
        mkeys = np.concatenate([ckeys, hkeys])
        order = np.argsort(mkeys)
        skeys = mkeys[order]
        t = self.cfg.table_size
        for start in range(0, t, chunk):
            stop = min(start + chunk, t)
            block = self.cold.lazy_rows(
                table, "param", np.arange(start, stop, dtype=np.int64)
            )
            lo, hi = np.searchsorted(skeys, (start, stop))
            idx = order[lo:hi]
            at = skeys[lo:hi] - start
            block[at] = self._gather_fold(idx, ncold, crows, hrows)
            yield start, stop, block

    # -- checkpoint (tier-erased fold) --------------------------------------

    def save_checkpoint(
        self,
        directory: str,
        state: dict,
        cursor: dict,
        config_json: str | None = None,
        keep: int = 0,
    ) -> str:
        """Tiered checkpoint: manifest format 2 plus a ``store``
        section; touched rows from BOTH tiers in the row-range shard
        format over the PACKED key-sorted space, written chunk by chunk
        through a sort INDEX (no [T, D] materialization and no second
        copy of the touched rows)."""
        self.complete_pending()
        step = int(state["step"])
        final = os.path.join(directory, f"ckpt-{step:010d}")
        tmp = os.path.join(directory, f".tmp-ckpt-{step:010d}")
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        # same chaos site as the dense path: a fire leaves only a
        # .tmp-ckpt-* (cleaned by the next save)
        failpoint("ckpt.write_shard")
        occupied = np.flatnonzero(self.hot.key_of >= 0)
        hkeys = self.hot.key_of[occupied]
        ckeys = self.cold.keys_view()
        ncold = len(ckeys)
        all_keys = np.concatenate([ckeys, hkeys])
        order = np.argsort(all_keys)
        n = len(order)
        np.save(os.path.join(tmp, "store.keys.npy"), all_keys[order])
        arrays_meta: dict = {}
        for tname, spec in self.cold.tables.items():
            for aname in spec.arrays:
                key = f"store.{tname}.{aname}"
                _, cold_rows = self.cold.export_array(tname, aname)
                hot_rows = self._hot_rows(state, tname, aname, occupied)
                arrays_meta[key] = {
                    "shape": [n, spec.dim],
                    "dtype": "float32",
                }
                for start in range(0, n, CHUNK_ROWS):
                    stop = min(start + CHUNK_ROWS, n)
                    block = self._gather_fold(
                        order[start:stop], ncold, cold_rows, hot_rows
                    )
                    np.save(
                        os.path.join(
                            tmp, f"{key}.r{start:012d}-{stop:012d}.npy"
                        ),
                        block,
                    )
        for dname in sorted(state.get("dense", {})):
            np.save(
                os.path.join(tmp, f"dense.{dname}.npy"),
                state["dense"][dname].detach().cpu().numpy(),
            )
        manifest = {
            "format": 2,
            "step": step,
            "arrays": arrays_meta,
            "dense": sorted(state.get("dense", {})),
            "cursor": cursor,
            "config": config_json,
            "store": {
                "rows": n,
                "table_size": self.cfg.table_size,
                "hot_capacity": self.hot.capacity,
                "hot_occupancy": self.hot.occupancy,
            },
        }
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2)
        failpoint("ckpt.finalize")  # kill mid-commit (manifest-last)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _write_latest(directory, os.path.basename(final))
        if keep > 0:
            gc_checkpoints(directory, keep)
        return final

    def load_checkpoint(self, path: str, state: dict):
        """Restore: repopulate the cold store with the folded rows,
        reset the hot tier (promotion re-warms it), rebuild device
        state.  Returns (state, cursor)."""
        failpoint("ckpt.restore")
        if not is_complete(path):
            raise IncompatibleCheckpoint(
                f"checkpoint {path} has no {MANIFEST} — incomplete or "
                "externally corrupted generation"
            )
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        store_meta = manifest.get("store")
        if manifest.get("format") != 2 or store_meta is None:
            raise IncompatibleCheckpoint(
                f"checkpoint {path} was not written by "
                "store_mode='tiered' (no store section) — restore it "
                "with the store mode it was trained under"
            )
        if int(store_meta["table_size"]) != self.cfg.table_size:
            raise ValueError(
                f"checkpoint {path} table_size "
                f"{store_meta['table_size']} != configured "
                f"{self.cfg.table_size} — table_size_log2 changed "
                "between runs?"
            )
        n = int(store_meta["rows"])
        keys = (
            np.load(os.path.join(path, "store.keys.npy"))
            if n
            else np.zeros(0, np.int64)
        )
        data: dict[str, dict[str, np.ndarray]] = {}
        for tname, spec in self.cold.tables.items():
            data[tname] = {}
            for aname in spec.arrays:
                key = f"store.{tname}.{aname}"
                meta = manifest["arrays"].get(key)
                if meta is None:
                    raise ValueError(
                        f"checkpoint {path} missing array {key}"
                    )
                if n:
                    reader = RangeReader(
                        path, key, tuple(meta["shape"]),
                        np.dtype(meta["dtype"]),
                    )
                    data[tname][aname] = reader.read((slice(0, n),))
                else:
                    data[tname][aname] = np.zeros(
                        (0, spec.dim), np.float32
                    )
        self._staged.clear()
        self._pending = None
        if self.promoter is not None:
            # the worker mirrors the tier (hot_view, decayed scores);
            # restoring under it would leave keys it still believes hot
            # permanently un-promotable — recreate it fresh alongside
            # the maps it mirrors
            self.promoter.close()
            self.promoter = None
        self._promoter_restarts = 0  # restored run: fresh heal budget
        self._promoter_dead = False
        self.cold.load_rows(keys, data)
        self.hot.reset_maps()
        new_state = self.init_device_state()
        for dname, arr in new_state.get("dense", {}).items():
            fname = os.path.join(path, f"dense.{dname}.npy")
            if not os.path.exists(fname):
                raise ValueError(
                    f"checkpoint {path} missing dense array {dname}"
                )
            host = np.load(fname)
            if host.shape != tuple(arr.shape):
                raise ValueError(
                    f"checkpoint dense {dname} shape {host.shape} != "
                    f"{tuple(arr.shape)}"
                )
            new_state["dense"][dname] = torch.from_numpy(host).to(arr.device)
        new_state["step"] = int(manifest["step"])
        return new_state, manifest["cursor"]


def _chunks(items: list, size: int):
    for i in range(0, len(items), size):
        yield items[i : i + size]
