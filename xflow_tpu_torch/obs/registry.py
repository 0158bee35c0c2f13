"""Counters / gauges / histograms (a copy of the reference's
obs/registry.py, less the disabled NullRegistry).

The serving batcher observes per-request queue, featurize and device
seconds here and snapshots a window into its stats row
(serve/batcher.py).  Thread-safety: request threads and the batcher's
worker thread both touch it, so every mutation takes a (cheap,
uncontended) lock.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


class Histogram:
    """Sliding-window value recorder with percentile summaries.

    Keeps the newest ``capacity`` observations in a ring (plus exact
    running count/sum/max), so percentiles reflect the recent window
    and memory stays bounded on arbitrarily long runs.  Step-time p50/
    p90/p99 are the intended use; 4096 samples cover several epochs of
    toy runs and a representative window of production ones.

    ``summary()`` windows: ``count``/``sum``/``mean``/``max`` are exact
    ALL-TIME aggregates; the percentiles and ``window_max`` cover only
    the retained ring.  (``max`` used to silently switch to the window
    once the ring wrapped — a one-off spike older than ``capacity``
    observations vanished from the summary.)
    """

    __slots__ = ("capacity", "count", "sum", "max", "_vals")

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self.count = 0
        self.sum = 0.0
        self.max = float("-inf")
        self._vals: list[float] = []

    def observe(self, v: float) -> None:
        if self.count < self.capacity:
            self._vals.append(v)
        else:
            self._vals[self.count % self.capacity] = v
        self.count += 1
        self.sum += v
        if v > self.max:
            self.max = v

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the retained window (p in
        [0, 100]); 0.0 when empty."""
        if not self._vals:
            return 0.0
        s = sorted(self._vals)
        idx = min(len(s) - 1, max(0, int(round(p / 100.0 * (len(s) - 1)))))
        return s[idx]

    def summary(self) -> dict[str, float]:
        return {
            "count": self.count,
            "mean": self.sum / self.count if self.count else 0.0,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "max": self.max if self.count else 0.0,
            "window_max": max(self._vals) if self._vals else 0.0,
        }


@dataclass
class Snapshot:
    """One reset-window's worth of metrics, as plain dicts."""

    counters: dict[str, float] = field(default_factory=dict)
    gauges: dict[str, float] = field(default_factory=dict)
    hists: dict[str, dict[str, float]] = field(default_factory=dict)

    def phase_seconds(self) -> dict[str, float]:
        """Counters under the ``phase.`` namespace, name-stripped —
        the per-phase wall-second accounting."""
        pre = "phase."
        return {
            k[len(pre):]: v for k, v in self.counters.items()
            if k.startswith(pre)
        }


class MetricsRegistry:
    enabled = True

    def __init__(self, hist_capacity: int = 4096):
        self._lock = threading.Lock()
        self._hist_capacity = hist_capacity
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}

    def counter_add(self, name: str, v: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + v

    def gauge_set(self, name: str, v: float) -> None:
        with self._lock:
            self._gauges[name] = v

    def observe(self, name: str, v: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(self._hist_capacity)
            h.observe(v)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    def snapshot(self, reset: bool = False) -> Snapshot:
        with self._lock:
            snap = Snapshot(
                counters=dict(self._counters),
                gauges=dict(self._gauges),
                hists={k: h.summary() for k, h in self._hists.items()},
            )
            if reset:
                self._counters.clear()
                self._gauges.clear()
                self._hists.clear()
        return snap
