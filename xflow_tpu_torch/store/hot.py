"""The hot tier on the card: bounded device rows, the key→slot map, and
the tiered step over the combined row space (the reference's
store/hot.py; B12).

The card never sees a table key under store_mode='tiered'.  The host
resolves every batch key through the key→slot map and ships each
occurrence as a ``ref`` into a combined row space::

    [0, Hc)         the hot tier        (param + optimizer slots)
    [Hc, Hc+mc)     this batch's misses (cold rows fetched by the host)

Where the reference concatenates the hot tier and the miss block on
every step (``_combined``, store/hot.py:197-207), which copies the whole
tier, the port keeps ONE combined buffer per (table, plane) of
``Hc + Mmax`` rows on the card, allocated once (``Mmax`` =
``plane_cap(B*K, B*K)``, the most misses a batch can carry, io/compact.py);
the hot tier is its view ``[:Hc]``.  A dispatch copies its ``mc``
padded miss rows into rows ``[Hc, Hc+mc)`` (from pinned host memory,
``non_blocking``, on the step's stream) and every kernel then runs on
the contiguous view ``[:Hc+mc]`` (rounded up to 4 rows, K3's 16-byte
groups), so no new kernel is needed:

* ``train``: the port's ``TrainStep._update`` over the view, refs as
  the keys.  ``update_mode="dense"``: K2 (K7, the head and K8 for a
  pooled family) into the combined ``g``, then K3 per table over the
  view (rows with g = 0 are left as they were, the dense mode's
  argument).  ``"sparse"``: K4 over the refs, K2 in index mode, one K5.
  Padding refs carry -1, the compact wire's sentinel; K4's plan carries
  the view's row count ``Hc+mc`` as its sentinel (the reference's
  ``refs_eff``, store/hot.py:234-236), which K5 drops.  Dense
  parameters take plain SGD.  Then the rows ``[Hc, Hc+n)`` of every
  plane are queued for the host (``writeback``): one device-to-host
  copy a plane into pinned memory and an event, which
  ``TieredStore.complete_pending`` waits on before the upsert.
* ``predict``: K1 (K7 and the head) over the param view; a predict
  plan ships the param plane alone.
* ``fill`` / ``read``: ``index_copy_`` / ``index_select`` of at most
  ``PROMOTE_CAP`` rows of every plane, between steps.  The reference
  pads them to ``PROMOTE_CAP`` so that XLA compiles once; the port moves
  the real count.

Every device transient is hot-capacity or batch shaped, never T: that
is what lets FM train at T = 2^28.
"""

from __future__ import annotations

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.io.compact import plane_cap
from xflow_tpu_torch.parallel.step import DENSE_STREAM, table_generator

# Promotion/demotion transfer width: maintain() moves rows in chunks of
# at most this many (the reference's fixed fill/read width).
PROMOTE_CAP = 1024


def _round4(n: int) -> int:
    return -(-n // 4) * 4


class HotTier:
    """Bounded device rows + key→slot map + the tiered device calls."""

    def __init__(self, model, optimizer, cfg: Config, device: torch.device):
        self.model = model
        self.optimizer = optimizer
        self.cfg = cfg
        self.device = device
        self.capacity = cfg.hot_capacity
        if cfg.update_mode not in ("dense", "sparse"):
            raise ValueError(
                "tiered store supports update_mode 'dense' or 'sparse' "
                f"(got {cfg.update_mode!r})"
            )
        # optimizer aux plane names (FTRL: n/z; SGD: none), discovered
        # once from a 1-row probe
        self._aux_names = tuple(sorted(optimizer.init_aux(torch.zeros((1, 1)))))
        self.planes = ("param",) + self._aux_names
        # the dense update's gradient buffer rides the combined rows too
        self._buffers = self.planes + (("g",) if cfg.update_mode == "dense" else ())
        self.miss_cap = plane_cap(cfg.batch_size * cfg.max_nnz,
                                  cfg.batch_size * cfg.max_nnz)
        # {table: {plane: [Hc + Mmax, D]}}, allocated by init_device_state
        self.bufs: dict[str, dict[str, torch.Tensor]] = {}
        # index_copy_ / index_select calls by fill / read (one a plane)
        self.fill_calls = 0
        self.read_calls = 0
        # key→slot remap: key_of[-1 = free] is the inverse, _free a
        # stack of unassigned slots.  Main-thread only (the promotion
        # worker proposes over queues; application is between steps).
        self.key_of = np.full(self.capacity, -1, np.int64)
        self.slot_of: dict[int, int] = {}
        self._free: list[int] = list(range(self.capacity - 1, -1, -1))
        # vectorized lookup snapshot (key-sorted occupied slots),
        # rebuilt lazily: the map only mutates in maintain() (between
        # steps), while lookup() runs per batch over every unique key
        self._lookup_keys = np.empty(0, np.int64)
        self._lookup_slots = np.empty(0, np.int64)
        self._lookup_dirty = False

    # -- device state -------------------------------------------------------

    def _rows(self, misses: int) -> int:
        return _round4(self.capacity + misses)

    def init_device_state(self) -> dict:
        """A zeroed tier (rows are garbage to the maps until a slot is
        assigned and filled — the maps gate every read) in the combined
        buffers, allocated once and zeroed in place on a later call
        (a restore), plus dense parameters seeded exactly as the dense
        store's ``init_state`` seeds them (parallel/step.py), so model
        quality is layout-independent."""
        rows = self._rows(self.miss_cap)
        for spec in self.model.tables():
            bufs = self.bufs.setdefault(spec.name, {})
            for plane in self._buffers:
                if plane in bufs and bufs[plane].shape[0] >= rows:
                    bufs[plane].zero_()
                else:
                    bufs[plane] = torch.zeros((rows, spec.dim), device=self.device)
        dense = {}
        if hasattr(self.model, "dense_init"):
            gen = table_generator(self.cfg.seed, DENSE_STREAM, torch.device("cpu"))
            dense = {k: t.to(self.device) for k, t in self.model.dense_init(gen).items()}
        return {"tables": self._hot_views(), "dense": dense, "step": 0}

    def _hot_views(self) -> dict:
        h = self.capacity
        return {name: {p: bufs[p][:h] for p in self.planes}
                for name, bufs in self.bufs.items()}

    def _check_state(self, state: dict) -> None:
        for name, bufs in self.bufs.items():
            if state["tables"][name]["param"].data_ptr() != bufs["param"].data_ptr():
                raise ValueError(
                    "the state's tables are not this store's hot tier — "
                    "take the state from init_device_state / maintain / "
                    "load_checkpoint"
                )

    def _ensure(self, state: dict, misses: int) -> None:
        """Grow the combined buffers when a batch carries more misses
        than the configured geometry allows (an external batch wider
        than ``batch_size`` x ``max_nnz``); the hot rows move with them
        and ``state`` is rebound to the new tier views."""
        rows = self._rows(misses)
        if rows <= next(iter(self.bufs.values()))["param"].shape[0]:
            return
        h = self.capacity
        for bufs in self.bufs.values():
            for plane, old in list(bufs.items()):
                new = torch.zeros((rows, old.shape[1]), device=self.device)
                new[:h] = old[:h]
                bufs[plane] = new
        self.miss_cap = misses
        state["tables"] = self._hot_views()

    def host_block(self, rows: int, dim: int) -> torch.Tensor:
        """A host [rows, dim] float32 buffer for miss rows: pinned on the
        card (the copies are then asynchronous)."""
        return torch.empty((rows, dim), pin_memory=self.device.type == "cuda")

    def _load_misses(self, state: dict, miss: dict) -> int:
        """Copy the shipped miss blocks into rows [Hc, Hc+mc) of the
        combined buffers, on the current stream; returns the view's
        rows.  The previous dispatch's write-back copy reads the same
        rows: it was queued earlier on this stream, so stream order
        runs it first (and complete_pending waited on it already)."""
        self._check_state(state)
        mc = max((b.shape[0] for arrs in miss.values() for b in arrs.values()), default=0)
        self._ensure(state, mc)
        h = self.capacity
        if mc:
            for name, arrs in miss.items():
                for plane, block in arrs.items():
                    self.bufs[name][plane][h:h + mc].copy_(block, non_blocking=True)
        return self._rows(mc)

    def _views(self, rows: int, planes) -> dict:
        return {name: {p: bufs[p][:rows] for p in planes}
                for name, bufs in self.bufs.items()}

    # -- key→slot map -------------------------------------------------------

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Slot per key (-1 = miss), vectorized: binary search over the
        key-sorted occupancy snapshot."""
        if self._lookup_dirty:
            occ = np.flatnonzero(self.key_of >= 0)
            hkeys = self.key_of[occ]
            order = np.argsort(hkeys)
            self._lookup_keys = hkeys[order]
            self._lookup_slots = occ[order]
            self._lookup_dirty = False
        if not len(self._lookup_keys) or not len(keys):
            return np.full(len(keys), -1, np.int64)
        pos = np.searchsorted(self._lookup_keys, keys)
        pos = np.minimum(pos, len(self._lookup_keys) - 1)
        hit = self._lookup_keys[pos] == keys
        return np.where(hit, self._lookup_slots[pos], -1)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> int:
        return self.capacity - len(self._free)

    def assign(self, keys) -> np.ndarray:
        """Pop a free slot per key (caller guarantees capacity and that
        no key is already hot)."""
        slots = np.empty(len(keys), np.int64)
        for i, k in enumerate(keys):
            k = int(k)
            s = self._free.pop()
            self.slot_of[k] = s
            self.key_of[s] = k
            slots[i] = s
        self._lookup_dirty = True
        return slots

    def release(self, keys) -> np.ndarray:
        """Free the slots of ``keys`` (demotion — rows must already be
        flushed to the cold store)."""
        slots = np.empty(len(keys), np.int64)
        for i, k in enumerate(keys):
            k = int(k)
            s = self.slot_of.pop(k)
            self.key_of[s] = -1
            self._free.append(s)
            slots[i] = s
        self._lookup_dirty = True
        return slots

    def reset_maps(self) -> None:
        """Empty the tier (restore: every row re-enters through the
        cold store and promotes again)."""
        self.key_of.fill(-1)
        self.slot_of.clear()
        self._free = list(range(self.capacity - 1, -1, -1))
        self._lookup_keys = np.empty(0, np.int64)
        self._lookup_slots = np.empty(0, np.int64)
        self._lookup_dirty = False

    # -- device calls -------------------------------------------------------

    def train(self, state: dict, arrays: dict, n_miss: int, update):
        """One tiered train step in place: the miss rows into the
        combined buffers, ``update`` (``TrainStep._update``) over the
        view, and the write-back of the ``n_miss`` real miss rows queued
        for the host.  Returns (metrics ``{"logloss", "count"}`` as
        device tensors, no sync; the write-back ``(rows, event)``)."""
        rows = self._load_misses(state, arrays["miss"])
        acc = torch.zeros(2, dtype=torch.float64, device=self.device)
        update(self._views(rows, self._buffers), arrays, arrays["num_real"], acc,
               state["dense"])
        state["step"] += 1
        metrics = {"logloss": acc[0] / torch.clamp(acc[1], min=1.0), "count": acc[1]}
        return metrics, self.writeback(n_miss)

    def writeback(self, n: int):
        """Rows [Hc, Hc+n) of every plane on their way to the host:
        ({table: {plane: host [n, D]}}, the event recorded after the
        copies, or None on the CPU)."""
        if not n:
            return {}, None
        h = self.capacity
        out = {}
        for name, bufs in self.bufs.items():
            out[name] = {}
            for plane in self.planes:
                src = bufs[plane][h:h + n]
                if self.device.type == "cuda":
                    dst = torch.empty(src.shape, pin_memory=True)
                    dst.copy_(src, non_blocking=True)
                else:
                    dst = src.clone()
                out[name][plane] = dst
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return out, event

    def predict(self, state: dict, arrays: dict, predict_step) -> torch.Tensor:
        """pctr over the combined param view (misses fetched read-only by
        the planner — no write-back; the predict wire ships only the
        param plane per miss block, since optimizer slots never
        score)."""
        rows = self._load_misses(state, arrays["miss"])
        return predict_step.predict(
            {"tables": self._views(rows, ("param",)), "dense": state["dense"]}, arrays)

    def _index(self, slots: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slots, np.int64)).to(self.device)

    def fill(self, state: dict, slots: np.ndarray, rows: dict) -> dict:
        """Write ``rows`` ({table: {plane: [n, D]}}) into the tier at
        ``slots``: promotion (``index_copy_`` a plane)."""
        self._check_state(state)
        idx = self._index(slots)
        for name, arrs in rows.items():
            for plane, block in arrs.items():
                state["tables"][name][plane].index_copy_(
                    0, idx, torch.from_numpy(np.ascontiguousarray(block)).to(self.device))
                self.fill_calls += 1
        return state

    def read(self, state: dict, slots: np.ndarray) -> dict:
        """The tier's rows at ``slots`` on the host, every plane
        (``index_select`` a plane): demotion."""
        self._check_state(state)
        idx = self._index(slots)
        out = {}
        for name, t in state["tables"].items():
            out[name] = {}
            for plane, arr in t.items():
                out[name][plane] = arr.index_select(0, idx).cpu().numpy()
                self.read_calls += 1
        return out
