"""Micro-batching request queue — single-row scoring at device-batch
efficiency.

Online CTR traffic arrives as independent single-row requests, but the
device wants bucketed batches (serve/engine.py).  The MicroBatcher
bridges them: requests enqueue with a timestamp; a worker thread
coalesces everything that arrives within a ``max_wait_ms`` deadline
(capped at the engine's largest bucket) into ONE featurize + ONE
bucketed device call, then resolves each request's Future.  Tail
latency is bounded by ``max_wait_ms`` + one device call; throughput
approaches the bucketed batch rate as concurrency rises.

Latency accounting: per-request queue (enqueue→dequeue),
featurize (request→Batch assembly), and device (h2d+execute+fetch)
seconds land in obs registry histograms; ``emit_stats``/``close``
flush a ``serve_stats`` JSONL row (obs/schema.py) with p50/p99 per
phase and the coalescing ratio.

Hot swap: ``swap(new_engine)`` atomically replaces the engine between
batches — the in-flight batch finishes on the old one, the next batch
scores on the new one; zero dropped or mixed requests.  Digest-guarded:
a replacement exported from a different config is refused unless
``force=True`` (rolling out a new model GEOMETRY is a redeploy, not a
hot swap)."""

from __future__ import annotations

import queue
import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future
from typing import Any

import numpy as np

from xflow_tpu_torch.chaos import failpoint
from xflow_tpu_torch.obs.registry import MetricsRegistry, Snapshot

_STOP = object()


def stats_row_from_snapshot(snap: Snapshot) -> dict:
    """Build a ``serve_stats`` record body from one registry snapshot.

    Shared by ``MicroBatcher.emit_stats`` (one batcher, its own
    registry) and ``serve/fleet.py`` (N batchers pooling ONE registry —
    the fleet snapshots once and owns the row, so per-replica resets
    never tear the window)."""

    def pct(name: str, p: str) -> float:
        return round(snap.hists.get(name, {}).get(p, 0.0), 6)

    return {
        "requests": int(snap.counters.get("serve.requests", 0)),
        "batches": int(snap.counters.get("serve.batches", 0)),
        "swaps": int(snap.counters.get("serve.swaps", 0)),
        "shed_total": int(snap.counters.get("serve.shed_total", 0)),
        "batch_fill_mean": round(
            snap.hists.get("serve.batch_size", {}).get("mean", 0.0), 3
        ),
        "queue_p50": pct("serve.queue_seconds", "p50"),
        "queue_p99": pct("serve.queue_seconds", "p99"),
        "featurize_p50": pct("serve.featurize_seconds", "p50"),
        "featurize_p99": pct("serve.featurize_seconds", "p99"),
        "device_p50": pct("serve.device_seconds", "p50"),
        "device_p99": pct("serve.device_seconds", "p99"),
    }


class MicroBatcher:
    def __init__(
        self,
        engine,
        max_wait_ms: float = 2.0,
        max_batch: int | None = None,
        registry: MetricsRegistry | None = None,
        metrics_logger=None,
        flight=None,
        emit_on_close: bool = True,
        topk: bool = False,
        cache=None,
    ):
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        self._engine = engine
        # hot-key score cache (serve/scache.py): the worker INSERTS
        # scored rows here, keyed by the scoring engine's OWN servable
        # digest — bitwise-correct by construction (the cached value IS
        # what that engine returned).  Lookups happen upstream
        # (serve/fleet.py submit); the cache itself digest-guards
        # inserts, so a batch scored on a pre-rollout engine that
        # resolves after the commit is dropped, not cached stale.
        # topk batchers never cache (tuple results, not scalar pctrs).
        self._cache = None if topk else cache
        # top-k mode (retrieval fleets, docs/SERVING.md cascade): the
        # worker coalesces exactly like score mode but runs the
        # engine's topk leg; each Future resolves to (item_ids [k],
        # scores [k]) instead of a float.  One batcher serves ONE mode
        # — a cascade runs a topk retrieval fleet in front of a score
        # ranking fleet, so modes never mix inside a coalesced batch.
        self._topk = topk
        if topk and getattr(engine, "topk_k", 0) < 1:
            raise ValueError(
                "topk batcher needs an engine with an item index "
                "attached (PredictEngine.attach_item_index)"
            )
        # obs/flight.py heartbeat sink: one note_serve per coalesced
        # batch; a watchdog with set_pending("serve", self.pending)
        # then classifies silence-with-backlog as serve_queue_stall
        self._flight = flight
        self._busy = False
        self._max_wait = max_wait_ms / 1000.0
        self._max_batch = (
            max_batch if max_batch is not None else engine.buckets[-1]
        )
        if self._max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        # a coalesced batch must fit the engine's largest bucket
        # (featurize pads onto ONE bucket, it never chunks)
        self._max_batch = min(self._max_batch, engine.buckets[-1])
        self.registry = registry if registry is not None else MetricsRegistry()
        self.metrics_logger = metrics_logger
        # False when the registry is pooled across replicas
        # (serve/fleet.py): the fleet snapshots ONCE and owns the final
        # serve_stats row — a per-batcher emit on close would reset the
        # shared window out from under the other replicas
        self._emit_on_close = emit_on_close
        self._q: queue.Queue = queue.Queue()
        # FIFO of (enqueue stamp, trace span|None) mirroring _q
        # (admission-control feed): submit appends under _submit_lock,
        # the worker pops one per dequeued request — depth()/
        # queue_age_s()/oldest_trace() read the backlog without
        # touching the queue internals
        self._enq: deque[tuple[float, Any]] = deque()
        self._swap_lock = threading.Lock()
        self._submit_lock = threading.Lock()
        self._closed = False
        self._final_stats: dict | None = None
        self._drained = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="xflow-serve-batcher", daemon=True
        )
        self._thread.start()

    @property
    def engine(self):
        # under the swap lock for XF008 discipline: every access to the
        # swappable reference goes through one guard.  Callers that
        # need several fields of ONE engine must still capture a single
        # reference (as _run_batch does) — two property reads can
        # legitimately straddle a swap().
        with self._swap_lock:
            return self._engine

    # -- request side ------------------------------------------------------

    def submit(self, keys, slots=None, vals=None, trace=None) -> Future:
        """Enqueue one scoring request (raw hash-space features; vals
        default to 1.0 — the hash-mode convention) and return a Future
        resolving to its pctr.  ``trace`` is an optional opened
        ``obs.reqtrace.RequestSpan``: the worker stamps its
        seal/dequeue/featurize boundaries and completes it when the
        Future resolves (obs/reqtrace.py)."""
        # the closed-check + put is atomic w.r.t. close(), so every
        # accepted request is enqueued BEFORE the _STOP sentinel and is
        # guaranteed to be scored — no Future can sit behind _STOP
        # forever
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            fut: Future = Future()
            t = time.perf_counter()
            if trace is not None:
                trace.t_enq = t
            self._enq.append((t, trace))
            self._q.put(((keys, slots, vals), fut, t, trace))
        return fut

    def score(self, keys, slots=None, vals=None) -> float:
        return float(self.submit(keys, slots, vals).result())

    def pending(self) -> bool:
        """Work is queued or in flight — the watchdog's serve-channel
        gate (an idle batcher's silence is healthy, a backed-up one's
        is a stall).  ``_busy`` is read under the same lock that
        guards its writes (XF008: the watchdog monitor thread calls
        this while the worker flips the flag)."""
        with self._submit_lock:
            busy = self._busy
        return busy or not self._q.empty()

    def depth(self) -> int:
        """Requests accepted but not yet picked up by the worker — the
        admission-control backlog gauge (serve/fleet.py sheds on it).
        Excludes the batch currently in flight; ``pending()`` covers
        that.  Lock-safe: read under the same lock ``submit`` appends
        and the worker pops under."""
        with self._submit_lock:
            return len(self._enq)

    def queue_age_s(self, now: float | None = None) -> float:
        """Seconds the OLDEST still-queued request has waited (0.0 when
        the backlog is empty).  The admission-control deadline gauge: a
        new request admitted now queues behind this one, so its age is
        a floor on the newcomer's queue time."""
        if now is None:
            now = time.perf_counter()
        with self._submit_lock:
            if not self._enq:
                return 0.0
            return now - self._enq[0][0]

    def oldest_trace(self) -> int | None:
        """Trace id of the OLDEST still-queued request (None when the
        backlog is empty or its head request is untraced).  Feeds the
        serve-channel flight heartbeat below, and through it the
        watchdog's ``serve_queue_stall`` health rows — so a flight
        dump names the stuck request, not just the stuck channel."""
        with self._submit_lock:
            if not self._enq:
                return None
            span = self._enq[0][1]
        return span.trace_id if span is not None else None

    def note_shed(self, cause: str) -> None:
        """Book one admission-control rejection against this batcher's
        registry — the shed request never enters the queue, so the
        worker never sees it; the stats row carries the total (the
        per-CAUSE split lives in the fleet's ``serve_shed`` row, the
        one source of by-cause truth)."""
        del cause  # part of the call contract; fleet books the split
        self.registry.counter_add("serve.shed_total")

    # -- lifecycle ---------------------------------------------------------

    def swap(self, engine, force: bool = False) -> None:
        """Atomically replace the serving engine (newer artifact).  The
        in-flight batch completes on the old engine; every later batch
        scores on the new one."""
        with self._swap_lock:
            # digest check INSIDE the lock: two racing swaps must not
            # both pass the check against the same old engine and then
            # install in arbitrary order (XF008 check-then-act)
            if not force and engine.digest != self._engine.digest:
                raise ValueError(
                    f"hot-swap refused: new engine digest {engine.digest} "
                    f"!= serving digest {self._engine.digest} (different "
                    "config/geometry — pass force=True only if you mean it)"
                )
            self._engine = engine
        self.registry.counter_add("serve.swaps")

    def emit_stats(self) -> dict:
        """Snapshot-and-reset the latency window into a ``serve_stats``
        record (logged to the metrics JSONL when a logger is attached);
        returns the record."""
        snap = self.registry.snapshot(reset=True)
        row = stats_row_from_snapshot(snap)
        if self.metrics_logger is not None:
            self.metrics_logger.log("serve_stats", row)
        return row

    def close(self, join_timeout: float = 60.0) -> dict:
        """Drain the queue, stop the worker, flush ONE final
        ``serve_stats`` row; returns it.  Idempotent AND thread-safe:
        concurrent/later closers block on the drain event until the
        first closer has published the final row, so every caller gets
        the same stats (a bare ``first`` flag would let a second closer
        read ``_final_stats`` before the first finished joining).

        The worker join is BOUNDED (XF006): a device call wedged
        mid-batch must not hang close() forever — after
        ``join_timeout`` the leak is surfaced (warning + ``health``
        row for ``obs doctor``) and the stats flush from whatever
        drained."""
        with self._submit_lock:
            first = not self._closed
            if first:
                self._closed = True
                self._q.put(_STOP)
        if first:
            try:
                self._thread.join(timeout=join_timeout)
                if self._thread.is_alive():
                    warnings.warn(
                        "MicroBatcher worker thread outlived its "
                        f"close() join ({join_timeout:.1f}s) — a device "
                        "call is likely wedged; stats below cover only "
                        "what drained",
                        RuntimeWarning,
                        stacklevel=2,
                    )
                    if self.metrics_logger is not None:
                        from xflow_tpu_torch.obs.schema import health_row

                        self.metrics_logger.log("health", health_row(
                            cause="serve_worker_leak",
                            channel="serve",
                            silence_seconds=join_timeout,
                            threshold_seconds=join_timeout,
                            detail="worker outlived close() join",
                        ))
                self._final_stats = (
                    self.emit_stats() if self._emit_on_close else {}
                )
            finally:
                # set even on failure: a raising first closer must not
                # leave concurrent closers blocked forever (they fail
                # the assert below instead)
                self._drained.set()
        else:
            # bounded by construction: the FIRST closer sets _drained in
            # a finally even when draining raises, and its own joins are
            # join_timeout-bounded (xf: ignore[XF017])
            self._drained.wait()
        assert self._final_stats is not None
        return self._final_stats

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- worker ------------------------------------------------------------

    def _loop(self) -> None:
        stopping = False
        while not stopping:
            # sentinel-drain worker loop: close() always enqueues _STOP
            # (XF006-gated lifecycle), so the dequeue is never abandoned
            # (xf: ignore[XF017])
            item = self._q.get()
            if item is _STOP:
                return
            # busy from the FIRST dequeue: a request riding the
            # coalescing wait below is in flight even though the queue
            # may be empty — pending() must not read it as idle.  Each
            # dequeued request also retires its enqueue stamp so
            # depth()/queue_age_s() track only the waiting backlog.
            with self._submit_lock:
                self._busy = True
                if self._enq:
                    self._enq.popleft()
            try:
                reqs = [item]
                deadline = time.perf_counter() + self._max_wait
                while len(reqs) < self._max_batch:
                    timeout = deadline - time.perf_counter()
                    if timeout <= 0:
                        # deadline passed: take whatever is already
                        # queued, but don't wait for more
                        timeout = 0.0
                    try:
                        nxt = self._q.get(timeout=timeout) if timeout else (
                            self._q.get_nowait()
                        )
                    except queue.Empty:
                        break
                    if nxt is _STOP:
                        stopping = True
                        break
                    with self._submit_lock:
                        if self._enq:
                            self._enq.popleft()
                    reqs.append(nxt)
                self._run_batch(reqs)
            finally:
                with self._submit_lock:
                    self._busy = False
                if self._flight is not None:
                    # the heartbeat names the oldest still-queued
                    # request: the watchdog copies this
                    # detail into serve_queue_stall health rows, so a
                    # stall points at a concrete trace id
                    tid = self.oldest_trace()
                    self._flight.note_serve(
                        "batch" if tid is None
                        else f"batch oldest_trace={tid:016x}"
                    )

    def _run_batch(self, reqs: list) -> None:
        # the batch is SEALED here: no later arrival joins it.  The
        # engine is captured ONCE under the swap lock, so every member
        # scores on one digest — a batch span can never mix trace ids
        # across a rollout swap by construction.
        t_seal = time.perf_counter()
        with self._swap_lock:
            engine = self._engine
        t_deq = time.perf_counter()
        reg = self.registry
        spans = [s for _, _, _, s in reqs if s is not None]
        sink = spans[0].sink if spans else None
        bid = sink.next_batch_id() if sink is not None else None
        for _, _, t_enq, span in reqs:
            reg.observe("serve.queue_seconds", t_deq - t_enq)
            if span is not None:
                span.t_seal = t_seal
                span.t_deq = t_deq
                span.batch_id = bid
                span.digest = engine.digest
        try:
            t0 = time.perf_counter()
            # chaos site: a replica whose scoring raises — the batch's
            # futures resolve with the error (below) and the fleet's
            # eviction policy takes it out of routing (serve/fleet.py)
            failpoint("serve.replica_score")
            batch = engine.featurize([row for row, _, _, _ in reqs])
            t1 = time.perf_counter()
            for span in spans:
                span.t_feat = t1
            if self._topk:
                ids, scores, _ = engine.topk_prepared(batch)
            else:
                pctr = engine.predict_prepared(batch)[: len(reqs)]
            t2 = time.perf_counter()
        except BaseException as e:  # resolve, never wedge the callers
            if sink is not None:
                sink.note_batch(
                    bid,
                    [s.trace_id for s in spans],
                    engine.digest,
                    0,
                    {},
                    status="error",
                )
            for _, fut, _, span in reqs:
                # span first: the error record must exist by the time
                # the caller observes the failed Future
                if span is not None:
                    span.sink.complete(span, "error", detail=repr(e))
                fut.set_exception(e)
            return
        # featurize/device are shared per batch: every coalesced request
        # EXPERIENCED the whole batch's featurize+device wall, so each
        # observes the full value — that is its latency, not an
        # amortized share.
        feat, dev = t1 - t0, t2 - t1
        # featurize padded onto ONE bucket, so the prepared batch's row
        # count IS the bucket that served these requests — the
        # per-bucket e2e histograms (queue+featurize+device) feed the
        # load generator's p50/p99-per-bucket report (serve/loadgen.py)
        bucket = getattr(batch, "batch_size", len(reqs))
        if sink is not None:
            phases = {"featurize": feat, "device": dev}
            # engine's per-call device split (h2d vs execute) — same
            # worker thread, so this is the call we just made
            split = getattr(engine, "last_device_phases", None)
            if split:
                phases.update(split)
            # batch span BEFORE the member resolutions: a caller that
            # saw its result can already find the complete tree
            sink.note_batch(
                bid,
                [s.trace_id for s in spans],
                engine.digest,
                bucket,
                phases,
            )
        cache = self._cache
        cache_digest = (
            getattr(engine, "servable_digest", None)
            if cache is not None and not self._topk
            else None
        )
        for i, (row, fut, t_enq, span) in enumerate(reqs):
            reg.observe("serve.featurize_seconds", feat)
            reg.observe("serve.device_seconds", dev)
            reg.observe(f"serve.e2e.b{bucket}", t2 - t_enq)
            if span is not None:
                span.bucket = bucket
                span.sink.complete(span)
            if cache_digest is not None:
                # insert BEFORE resolving the Future: a caller that
                # saw its score can already hit the cache with it
                cache.insert(cache_digest, *row, float(pctr[i]))
            if self._topk:
                # the scoring engine's index rides along: candidate
                # ids are only meaningful against the index that
                # produced them, and during a rollout canary different
                # replicas serve different indexes — a consumer that
                # read "the fleet's" index instead would resolve ids
                # against the wrong catalog (serve/cascade.py)
                fut.set_result((ids[i], scores[i], engine.item_index))
            else:
                fut.set_result(float(pctr[i]))
        reg.counter_add("serve.requests", len(reqs))
        reg.counter_add("serve.batches", 1.0)
        reg.observe("serve.batch_size", float(len(reqs)))
