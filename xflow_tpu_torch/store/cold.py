"""Host-resident cold row store (a copy of the reference's
store/cold.py; numpy only, byte for byte but this docstring).

Storage model: one shared key→slot index over packed per-table arrays
(``[rows_stored, D]`` numpy, amortized-doubling growth).  A key is
present for ALL of a model's tables or none — a logical table row moves
between tiers as a unit, optimizer slots included.  Rows that were
never written materialize on fetch from the per-row deterministic init
(``row_init_values``), so a 2^28-row table costs O(touched rows) host
memory instead of 10+ GiB per table: an untouched row's value is a pure
function of (seed, table, array, row index) — computable per-row,
independent of T, bit-stable across save/restore and across the two
packages (a tiered run of either starts from the same logical table).

This is the reference's own storage semantics: its server tables are
unordered_maps materializing entries on first touch with zeros (w/n/z)
or N(0,1)*scale (v) — ftrl.h:84,113-120.  store/hot.py keeps the head
of the table on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_GOLD = np.uint64(0x9E3779B97F4A7C15)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 arrays (wrapping
    arithmetic is the point — numpy array uint64 ops wrap silently)."""
    x = x + _GOLD
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _tag64(s: str) -> np.uint64:
    """FNV-1a of a table/array tag, so 'w.param' and 'v.param' draw
    independent streams for the same row index.  Python-int arithmetic
    masked to 64 bits — numpy uint64 SCALARS warn on overflow (arrays
    wrap silently, which _splitmix64 relies on)."""
    h = 0xCBF29CE484222325
    for b in s.encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return np.uint64(h)


def row_init_values(
    seed: int,
    table: str,
    arr: str,
    rows: np.ndarray,
    dim: int,
    init_kind: str = "zeros",
    init_scale: float = 0.0,
) -> np.ndarray:
    """Initial value of logical rows ``rows`` of ``table``'s ``arr``
    plane: float32 [len(rows), dim], deterministic in (seed, table,
    arr, row, col) and independent of the table size — the lazy
    counterpart of TableSpec.init (models/base.py).  "normal" is
    Box-Muller over two splitmix64 streams; optimizer aux planes are
    always zeros (FTRL n/z start at 0, ftrl.h:113-120)."""
    m = len(rows)
    if init_kind != "normal" or init_scale == 0.0:
        return np.zeros((m, dim), np.float32)
    seed_mix = np.uint64(
        (int(seed) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    )
    base = _splitmix64(
        rows.astype(np.uint64) ^ _tag64(f"{table}.{arr}") ^ seed_mix
    )
    e = _splitmix64(
        base[:, None] + np.arange(1, dim + 1, dtype=np.uint64)[None, :]
    )
    # u1 in (0, 1] (the +1 keeps log finite), u2 in [0, 1)
    u1 = ((e >> np.uint64(11)).astype(np.float64) + 1.0) * 2.0**-53
    u2 = (_splitmix64(e) >> np.uint64(11)).astype(np.float64) * 2.0**-53
    z = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
    return (z * init_scale).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ColdTableSpec:
    """Per-table layout the store needs: row width plus the init
    distribution of every array plane ({arr_name: (kind, scale)})."""

    dim: int
    arrays: dict  # {arr_name: (init_kind, init_scale)}


class ColdStore:
    """Packed host rows + key index.  Main-thread only by design: the
    trainer's plan/write-back/promotion-apply path is strictly
    sequential (store/tiered.py), and the async promotion worker talks
    queues, never this object."""

    _INITIAL_CAP = 1024

    def __init__(self, tables: dict[str, ColdTableSpec], seed: int = 0):
        self.tables = tables
        self.seed = seed
        self._index: dict[int, int] = {}
        self._cap = self._INITIAL_CAP
        self._n = 0
        self._keys = np.full(self._cap, -1, np.int64)
        self._data: dict[str, dict[str, np.ndarray]] = {
            t: {
                a: np.zeros((self._cap, spec.dim), np.float32)
                for a in spec.arrays
            }
            for t, spec in tables.items()
        }

    # -- capacity ----------------------------------------------------------

    def __len__(self) -> int:
        return self._n

    def nbytes(self) -> int:
        """Host bytes the packed value arrays occupy (capacity, not
        just live rows) — the number behind docs/STORE.md's budget
        math."""
        return sum(
            arr.nbytes for arrs in self._data.values()
            for arr in arrs.values()
        )

    def _grow(self, need: int) -> None:
        if self._n + need <= self._cap:
            return
        new_cap = self._cap
        while new_cap < self._n + need:
            new_cap *= 2
        keys = np.full(new_cap, -1, np.int64)
        keys[: self._n] = self._keys[: self._n]
        self._keys = keys
        for t, arrs in self._data.items():
            for a, arr in arrs.items():
                grown = np.zeros((new_cap, arr.shape[1]), np.float32)
                grown[: self._n] = arr[: self._n]
                arrs[a] = grown
        self._cap = new_cap

    def _slots_of(self, keys: np.ndarray) -> np.ndarray:
        # per-key dict resolution, but through tolist()+map (native
        # ints, C-level loop) — ~3x over a python generator.  Unlike
        # the hot map (store/hot.py::lookup, sorted-snapshot), this
        # index mutates on EVERY write-back, so a rebuild-per-step
        # snapshot would cost O(rows log rows) each step at scale;
        # lookups here cover only miss/write keys (small after
        # warmup).  A log-structured sorted index (append tail +
        # amortized merge) is the follow-up if cold-start profiles
        # ever dominate (docs/STORE.md).
        idx = self._index
        return np.asarray(
            [s if (s := idx.get(k)) is not None else -1
             for k in keys.tolist()],
            dtype=np.int64,
        ) if len(keys) else np.empty(0, np.int64)

    # -- fetch / write / take ----------------------------------------------

    def lazy_rows(self, table: str, arr: str, keys: np.ndarray) -> np.ndarray:
        spec = self.tables[table]
        kind, scale = spec.arrays[arr]
        return row_init_values(
            self.seed, table, arr, keys, spec.dim, kind, scale
        )

    def fetch(
        self, keys: np.ndarray, planes: tuple[str, ...] | None = None
    ) -> dict[str, dict[str, np.ndarray]]:
        """Rows for ``keys`` across every table: stored values where
        present, lazy init ONLY for the absent subset (the Box-Muller
        draw is real host work on the serialized per-step path — don't
        compute it for rows about to be overwritten).  ``planes``
        restricts which array planes are materialized (predict fetches
        pass ("param",) — optimizer slots never score).  Read-only —
        predict-path fetches never grow the store."""
        slots = self._slots_of(keys)
        present = slots >= 0
        absent = ~present
        any_present = bool(present.any())
        any_absent = bool(absent.any())
        out: dict[str, dict[str, np.ndarray]] = {}
        for t, arrs in self._data.items():
            out[t] = {}
            for a, arr in arrs.items():
                if planes is not None and a not in planes:
                    continue
                rows = np.zeros((len(keys), arr.shape[1]), np.float32)
                if any_absent:
                    rows[absent] = self.lazy_rows(t, a, keys[absent])
                if any_present:
                    rows[present] = arr[slots[present]]
                out[t][a] = rows
        return out

    def write(
        self, keys: np.ndarray, rows: dict[str, dict[str, np.ndarray]]
    ) -> None:
        """Upsert rows for ``keys`` (every table/array plane together —
        the write-back of one step's miss block)."""
        slots = self._slots_of(keys)
        absent = slots < 0
        n_new = int(absent.sum())
        if n_new:
            self._grow(n_new)
            new_slots = np.arange(self._n, self._n + n_new, dtype=np.int64)
            slots[absent] = new_slots
            self._keys[new_slots] = keys[absent]
            # bulk insert (C-level dict.update over native ints)
            self._index.update(
                zip(keys[absent].tolist(), new_slots.tolist())
            )
            self._n += n_new
        for t, arrs in rows.items():
            data = self._data[t]
            for a, block in arrs.items():
                data[a][slots] = block
        return None

    def delete(self, keys: np.ndarray) -> None:
        """Remove ``keys`` (promotion: the row now lives in the hot
        tier).  Swap-with-last keeps the arrays packed."""
        for k in keys:
            k = int(k)
            slot = self._index.pop(k, None)
            if slot is None:
                continue
            last = self._n - 1
            if slot != last:
                moved = int(self._keys[last])
                self._keys[slot] = moved
                self._index[moved] = slot
                for arrs in self._data.values():
                    for arr in arrs.values():
                        arr[slot] = arr[last]
            self._keys[last] = -1
            self._n = last

    def take(self, keys: np.ndarray) -> dict[str, dict[str, np.ndarray]]:
        """fetch + delete: the promotion path (rows move to the hot
        tier).  Keys never written back (e.g. only ever touched by a
        read-only predict plan) still yield their lazy-init rows."""
        rows = self.fetch(keys)
        self.delete(keys)
        return rows

    # -- bulk (checkpoint fold / restore) ----------------------------------

    def keys_view(self) -> np.ndarray:
        """View of the live keys, packed order (checkpoint fold)."""
        return self._keys[: self._n]

    def export_array(self, table: str, arr: str) -> tuple[np.ndarray, np.ndarray]:
        """(keys, rows) VIEWS of one plane's live rows — the fold paths
        (store/tiered.py) gather through these per chunk instead of
        copying the whole touched set."""
        return (
            self._keys[: self._n],
            self._data[table][arr][: self._n],
        )

    def load_rows(
        self, keys: np.ndarray, data: dict[str, dict[str, np.ndarray]]
    ) -> None:
        """Replace the whole store with ``keys``/``data`` (restore)."""
        n = len(keys)
        self._cap = max(self._INITIAL_CAP, n)
        self._n = n
        self._keys = np.full(self._cap, -1, np.int64)
        self._keys[:n] = keys
        self._index = {int(k): i for i, k in enumerate(keys)}
        self._data = {}
        for t, spec in self.tables.items():
            self._data[t] = {}
            for a in spec.arrays:
                arr = np.zeros((self._cap, spec.dim), np.float32)
                if n:
                    arr[:n] = data[t][a]
                self._data[t][a] = arr
