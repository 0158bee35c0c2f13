"""Async promotion/demotion worker — tier placement off the hot loop
(a copy of the reference's store/promote.py: the same policy, constants
and bounded close; a leak's ``health`` row goes through the port's
``obs.emit_health``, since the port has no flight recorder yet).

The worker never touches the store: the planner posts per-batch touch
counts (the dedup kernel's unique keys + occurrence counts — free, the
host computed them for the refs plane anyway) into a bounded queue; the
worker folds them into a decayed score table and proposes plans
(promote these misses / evict those cold hot rows); the trainer applies
a plan BETWEEN steps (store/tiered.py::maintain) so an in-flight batch
never sees a moving key→slot map, then acks what actually happened so
the worker's view of the tier converges.  Queues are the only shared
state (XF008 by construction: no lock to get wrong), the loop
heartbeats the flight recorder (the XF009 discipline — a silent
promoter with misses flowing is a diagnosable stall, not a mystery),
and close() joins with a timeout, surfacing a leak as a ``health`` row
exactly like the loader's prefetch reaper (XF006).

Policy: promote any touched miss while free slots exist (zipf traffic
front-loads the head, so first-touch filling is near-optimal); once
full, swap in candidates whose decayed score clears the coldest hot
rows by a margin (hysteresis — a tie must not churn).  Scores halve
every DECAY_EVERY batches so yesterday's head can age out.
"""

from __future__ import annotations

import heapq
import queue
import threading

import numpy as np

from xflow_tpu_torch.chaos import failpoint
from xflow_tpu_torch.obs import Obs, emit_health

POLL_S = 0.05
DECAY_EVERY = 512
DECAY = 0.5
SCORE_FLOOR = 0.25  # decayed-out entries are dropped
# Hard score-table bound: when the dict outgrows this, decay+prune runs
# IMMEDIATELY instead of waiting for the DECAY_EVERY cadence.  A
# once-touched tail key survives at most two decays (1.0 -> 0.5 ->
# 0.25-pruned), so resident entries are bounded by ~2-3 trigger
# intervals of unique inflow — without this, a 2^28 zipf run's
# singleton tail would accumulate for a whole decay window (millions
# of dict entries, GBs of host RAM competing with the cold store).
SCORES_MAX_FACTOR = 8  # * capacity, floored at 65536
MAX_SWAPS = 256  # evict/promote pairs per plan
SWAP_EVERY = 8  # scan the hot set for cold rows every N notes
SWAP_MARGIN = 2.0  # candidate must beat the evictee by this factor


class PromotionWorker:
    def __init__(self, capacity: int, obs=None):
        self.capacity = capacity
        self._obs = obs if obs is not None else Obs()
        self._touch_q: queue.Queue = queue.Queue(maxsize=256)
        self._plan_q: queue.Queue = queue.Queue(maxsize=2)
        self._ack_q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # set when _run dies on an exception (the store.promote_worker
        # failpoint, or a real bug): TieredStore.maintain polls
        # alive() every step and restarts the worker ONCE with a
        # health row — placement degrades, correctness never does
        self.crashed: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, name="store-promote", daemon=True
        )
        self._thread.start()

    # -- main-thread surface ------------------------------------------------

    def note(
        self, keys: np.ndarray, counts: np.ndarray, miss: np.ndarray
    ) -> None:
        """Post one batch's (unique keys, occurrence counts, miss mask).
        Dropped (with a counter) when the worker lags — placement is
        advisory, the training step is not."""
        try:
            self._touch_q.put_nowait((keys, counts, miss))
        except queue.Full:
            self._obs.counter("store.touch_dropped")

    def poll_plan(self) -> dict | None:
        try:
            return self._plan_q.get_nowait()
        except queue.Empty:
            return None

    def ack(self, promoted: list[int], demoted: list[int]) -> None:
        """Report what maintain() actually applied, so the worker's
        hot-set view converges on the authoritative maps."""
        self._ack_q.put((promoted, demoted))

    def close(self) -> bool:
        """Stop + bounded join; returns True when the thread exited.
        A leak is surfaced exactly like the loader's (io/loader.py):
        counter + schema-valid ``health`` row through the metrics
        logger."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        leaked = self._thread.is_alive()
        if leaked:
            self._obs.counter("store.promote_thread_leak")
            emit_health(
                self._obs,
                cause="store_promote_leak",
                channel="store",
                silence_seconds=5.0,
                threshold_seconds=5.0,
                detail="promotion worker did not exit within the "
                "join timeout",
            )
        return not leaked

    def alive(self) -> bool:
        """The worker thread is still running.  False + ``crashed``
        set = it died on an exception; False + clean = it exited via
        close().  maintain() (store/tiered.py) polls this between
        steps — the watchdog's ``store`` channel independently sees
        the silence, but the restart decision is taken on the strictly
        sequential maintain path so it can never race a live plan."""
        return self._thread.is_alive()

    # -- worker -------------------------------------------------------------

    def _beat(self, detail: str) -> None:
        flight = self._obs.flight
        if flight is not None:
            flight.note_store(detail)

    def _run(self) -> None:
        try:
            self._run_inner()
        except BaseException as e:
            # worker death is a FACT to surface, not a crash to spread:
            # record it (maintain's alive() poll restarts once + emits
            # the health row) and exit — the store keeps training
            # correctly with placement frozen (all-miss for new keys)
            self.crashed = e
            self._obs.counter("store.promote_crash")

    def _run_inner(self) -> None:
        scores: dict[int, float] = {}
        hot_view: set[int] = set()
        scores_max = max(SCORES_MAX_FACTOR * self.capacity, 65536)
        notes = 0
        while not self._stop.is_set():
            while True:
                try:
                    promoted, demoted = self._ack_q.get_nowait()
                except queue.Empty:
                    break
                hot_view.update(promoted)
                hot_view.difference_update(demoted)
            try:
                keys, counts, miss = self._touch_q.get(timeout=POLL_S)
            except queue.Empty:
                self._beat("idle")
                continue
            # chaos site: a fire kills THIS thread (caught by _run's
            # death recorder) — the self-healing under test is the
            # maintain()-side detect-and-restart-once
            failpoint("store.promote_worker")
            self._beat("note")
            notes += 1
            miss_keys: list[int] = []
            for k, c, m in zip(
                keys.tolist(), counts.tolist(), miss.tolist()
            ):
                scores[k] = scores.get(k, 0.0) + float(c)
                if m and k not in hot_view:
                    miss_keys.append(k)
            if notes % DECAY_EVERY == 0 or len(scores) > scores_max:
                scores = {
                    k: v * DECAY
                    for k, v in scores.items()
                    if v * DECAY >= SCORE_FLOOR
                }
            plan = self._build_plan(scores, hot_view, miss_keys, notes)
            if plan is not None:
                try:
                    self._plan_q.put_nowait(plan)
                except queue.Full:
                    pass  # maintain() hasn't drained the last one yet

    def _build_plan(
        self,
        scores: dict[int, float],
        hot_view: set[int],
        miss_keys: list[int],
        notes: int,
    ) -> dict | None:
        if not miss_keys:
            return None
        cand = sorted(miss_keys, key=lambda k: -scores.get(k, 0.0))
        free = max(0, self.capacity - len(hot_view))
        promote = cand[:free]
        evict: list[int] = []
        rest = cand[free : free + MAX_SWAPS]
        if rest and hot_view and notes % SWAP_EVERY == 0:
            coldest = heapq.nsmallest(
                len(rest), hot_view, key=lambda k: scores.get(k, 0.0)
            )
            for k, old in zip(rest, coldest):
                if scores.get(k, 0.0) > SWAP_MARGIN * scores.get(old, 0.0):
                    promote.append(k)
                    evict.append(old)
        if not promote:
            return None
        # NOT applied to hot_view here: only maintain()'s ack mutates
        # the view, so a dropped/truncated plan self-corrects (the next
        # plan re-proposes; maintain skips keys already placed)
        return {"promote": promote, "evict": evict}
