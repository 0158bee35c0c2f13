"""Digest-keyed hot-key score cache — the zipf-skew throughput
multiplier in front of the MicroBatcher.

Ads traffic is zipf-shaped: the loadgen models it (serve/loadgen.py
``zipf_rows``) because the real feature stream is dominated by a small
hot set of (user, ad) feature rows.  Scoring is deterministic per
model version, so a row already scored by the CURRENT servable is pure
repeat work — a bounded LRU in front of the batcher turns the hot
set's repeat fraction directly into throughput, at zero device cost.

Correctness contract (the whole point of the design):

* **Keys are (servable_digest, row content).**  The servable digest
  (serve/artifact.py::servable_digest — config digest @ step) advances
  on every committed rollout INCLUDING zero-recompile delta refreshes,
  so a cached score can only ever be returned for the exact model
  version that produced it.  Row content is the raw little-endian
  bytes of (keys, slots, vals) — byte-equality, not a hash, so a
  collision can never serve a wrong score.
* **Inserts are digest-guarded.**  ``set_current(digest)`` pins the
  one digest the cache accepts; an insert carrying any other digest is
  dropped.  This closes the rollout straggler hole: a batch scored on
  the OLD engine that resolves AFTER the commit would otherwise
  re-pollute the cache under a digest that was just evicted.  The
  fleet calls ``set_current`` inside the same critical section that
  swaps ``fleet.servable`` (serve/fleet.py commit/abort), so there is
  no window where lookups and inserts disagree about the current
  version.
* **Invalidation is eviction, not just mis-keying.**  Digest keying
  makes a swap invalidation *by construction* (new lookups miss), but
  the old generation's entries would still occupy LRU capacity until
  traffic churned them out — across repeated rollouts that is a slow
  leak of hit rate, not memory safety.  ``set_current`` therefore
  EXPLICITLY evicts every entry not under the new digest, atomically
  with the pin.

Thread model: one lock around an ``OrderedDict`` (XF008 — every
mutable field behind it); no threads of its own, no blocking calls
under the lock.  Hit/miss/eviction counters are booked both locally
(windowed, flushed into ``serve_stats`` rows by the fleet) and into
the fleet's shared MetricsRegistry (``serve.cache_hit`` /
``serve.cache_miss``), so the `/metrics` exposition exports them
live (obs/export.py).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np


def row_key(keys, slots, vals) -> tuple:
    """Canonical content key for one featurize_raw-protocol row: the
    raw little-endian bytes of each component (None stays None — a
    defaulted component and an explicit zeros/ones component are
    DIFFERENT keys, which costs a miss, never a wrong hit)."""
    kb = np.asarray(keys).astype("<i8", copy=False).tobytes()
    sb = (
        None if slots is None
        else np.asarray(slots).astype("<i4", copy=False).tobytes()
    )
    vb = (
        None if vals is None
        else np.asarray(vals).astype("<f4", copy=False).tobytes()
    )
    return (kb, sb, vb)


class ScoreCache:
    """Bounded LRU of (servable_digest, row content) -> pctr."""

    def __init__(self, capacity: int, registry=None):
        if capacity < 1:
            raise ValueError("ScoreCache capacity must be >= 1")
        self.capacity = capacity
        self.registry = registry
        self._lock = threading.Lock()
        self._d: OrderedDict[tuple, float] = OrderedDict()
        self._current: str | None = None
        self._bytes = 0
        # window counters (flushed into serve_stats by the fleet)
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._invalidations = 0
        self._inserts_dropped = 0

    @staticmethod
    def _entry_bytes(key: tuple) -> int:
        _, kb, sb, vb = key
        return (
            len(kb)
            + (len(sb) if sb is not None else 0)
            + (len(vb) if vb is not None else 0)
            + 8  # the float score
        )

    def set_current(self, digest: str) -> int:
        """Pin ``digest`` as the one servable version the cache serves
        and accepts; EVICT every entry under any other digest (bounded
        memory across repeated rollouts — see module docstring).
        Returns the number of entries evicted."""
        with self._lock:
            if digest == self._current:
                return 0
            # the FIRST pin (fleet construction) is not an
            # invalidation — only a generation swap is, so doctor's
            # churn check counts rollouts, not fleet starts
            if self._current is not None:
                self._invalidations += 1
            self._current = digest
            stale = [k for k in self._d if k[0] != digest]
            for k in stale:
                self._bytes -= self._entry_bytes(k)
                del self._d[k]
            if stale:
                self._evictions += len(stale)
            return len(stale)

    def lookup(self, digest: str, keys, slots, vals) -> float | None:
        """Cached score for this row under ``digest``, or None.  A
        lookup against a non-current digest always misses (the caller
        read ``fleet.servable`` a beat before a commit landed — the
        miss routes it to the batcher, which scores it on whatever
        engine is then serving: correct either way)."""
        k = (digest, *row_key(keys, slots, vals))
        with self._lock:
            score = self._d.get(k)
            if score is None or digest != self._current:
                self._misses += 1
                hit = False
            else:
                self._d.move_to_end(k)
                self._hits += 1
                hit = True
        if self.registry is not None:
            self.registry.counter_add(
                "serve.cache_hit" if hit else "serve.cache_miss"
            )
        return score if hit else None

    def insert(self, digest: str, keys, slots, vals,
               score: float) -> bool:
        """Insert one scored row; dropped (False) when ``digest`` is
        not the pinned current version — the rollout-straggler guard.
        Evicts LRU entries past capacity."""
        k = (digest, *row_key(keys, slots, vals))
        with self._lock:
            if digest != self._current:
                self._inserts_dropped += 1
                return False
            if k in self._d:
                self._d.move_to_end(k)
                self._d[k] = float(score)
                return True
            self._d[k] = float(score)
            self._bytes += self._entry_bytes(k)
            while len(self._d) > self.capacity:
                old, _ = self._d.popitem(last=False)
                self._bytes -= self._entry_bytes(old)
                self._evictions += 1
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def stats_row(self, reset: bool = True) -> dict:
        """Windowed counters + live gauges for the fleet's
        ``serve_stats`` row (obs/schema.py OPTIONAL fields)."""
        with self._lock:
            hits, misses = self._hits, self._misses
            row = {
                "cache_hits": hits,
                "cache_misses": misses,
                "cache_hit_rate": round(
                    hits / (hits + misses), 6
                ) if (hits + misses) else 0.0,
                "cache_entries": len(self._d),
                "cache_bytes": self._bytes,
                "cache_evictions": self._evictions,
                "cache_invalidations": self._invalidations,
                "cache_inserts_dropped": self._inserts_dropped,
            }
            if reset:
                self._hits = 0
                self._misses = 0
                self._evictions = 0
                self._invalidations = 0
                self._inserts_dropped = 0
            return row
