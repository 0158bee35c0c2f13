"""Micro-batching request queue — single-row scoring at device-batch
efficiency (the reference's serve/batcher.py, score mode).

Requests enqueue with a timestamp; a worker thread coalesces everything
that arrives within a ``max_wait_ms`` deadline (capped at the engine's
largest bucket) into ONE featurize + ONE bucketed device call, then
resolves each request's Future.  Per-request queue, featurize and
device seconds land in a metrics registry; ``emit_stats``/``close``
return a stats row with p50/p99 per phase.

Hot swap, admission control, the score cache, top-k mode and request
tracing come with the rest of the serving tier (ROADMAP A7).
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from concurrent.futures import Future
from typing import Any

from xflow_tpu_torch.obs.registry import MetricsRegistry, Snapshot

_STOP = object()


def stats_row_from_snapshot(snap: Snapshot) -> dict:
    """A ``serve_stats`` record body from one registry snapshot."""

    def pct(name: str, p: str) -> float:
        return round(snap.hists.get(name, {}).get(p, 0.0), 6)

    return {
        "requests": int(snap.counters.get("serve.requests", 0)),
        "batches": int(snap.counters.get("serve.batches", 0)),
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
    def __init__(self, engine, max_wait_ms: float = 2.0):
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        self.engine = engine
        self._max_wait = max_wait_ms / 1000.0
        # a coalesced batch must fit the engine's largest bucket
        # (featurize pads onto ONE bucket, it never chunks)
        self._max_batch = engine.buckets[-1]
        self.registry = MetricsRegistry()
        self._q: queue.Queue = queue.Queue()
        self._submit_lock = threading.Lock()
        self._closed = False
        self._final_stats: dict | None = None
        self._drained = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="xflow-torch-serve-batcher", daemon=True
        )
        self._thread.start()

    # -- request side ------------------------------------------------------

    def submit(self, keys, slots=None, vals=None) -> Future:
        """Enqueue one scoring request (raw hash-space features; vals
        default to 1.0 — the hash-mode convention) and return a Future
        resolving to its pctr."""
        # the closed-check + put is atomic w.r.t. close(), so every
        # accepted request is enqueued BEFORE the _STOP sentinel and is
        # guaranteed to be scored
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            fut: Future = Future()
            self._q.put(((keys, slots, vals), fut, time.perf_counter()))
        return fut

    def score(self, keys, slots=None, vals=None) -> float:
        return float(self.submit(keys, slots, vals).result())

    # -- lifecycle ---------------------------------------------------------

    def emit_stats(self) -> dict:
        """Snapshot-and-reset the latency window into a stats row."""
        return stats_row_from_snapshot(self.registry.snapshot(reset=True))

    def close(self, join_timeout: float = 60.0) -> dict:
        """Drain the queue, stop the worker, return ONE final stats row.
        Idempotent and thread-safe: later closers wait for the first
        one's row.  The worker join is bounded: a wedged device call
        must not hang close() forever."""
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
                self._final_stats = self.emit_stats()
            finally:
                self._drained.set()
        else:
            self._drained.wait()
        if self._final_stats is None:
            raise RuntimeError("MicroBatcher: the first close() failed")
        return self._final_stats

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- worker ------------------------------------------------------------

    def _loop(self) -> None:
        stopping = False
        while not stopping:
            item = self._q.get()
            if item is _STOP:
                return
            reqs = [item]
            deadline = time.perf_counter() + self._max_wait
            while len(reqs) < self._max_batch:
                timeout = deadline - time.perf_counter()
                try:
                    # past the deadline: take what is queued, wait no more
                    nxt = (
                        self._q.get(timeout=timeout)
                        if timeout > 0
                        else self._q.get_nowait()
                    )
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stopping = True
                    break
                reqs.append(nxt)
            self._run_batch(reqs)

    def _run_batch(self, reqs: list) -> None:
        engine = self.engine
        reg = self.registry
        t_deq = time.perf_counter()
        for _, _, t_enq in reqs:
            reg.observe("serve.queue_seconds", t_deq - t_enq)
        try:
            t0 = time.perf_counter()
            batch = engine.featurize([row for row, _, _ in reqs])
            t1 = time.perf_counter()
            pctr = engine.predict_prepared(batch)[: len(reqs)]
            t2 = time.perf_counter()
        except Exception as e:  # resolve, never wedge the callers
            for _, fut, _ in reqs:
                fut.set_exception(e)
            return
        # featurize/device are shared per batch: every coalesced request
        # experienced the whole batch's featurize+device wall
        feat, dev = t1 - t0, t2 - t1
        bucket = batch.batch_size
        for i, (_, fut, t_enq) in enumerate(reqs):
            reg.observe("serve.featurize_seconds", feat)
            reg.observe("serve.device_seconds", dev)
            reg.observe(f"serve.e2e.b{bucket}", t2 - t_enq)
            fut.set_result(float(pctr[i]))
        reg.counter_add("serve.requests", len(reqs))
        reg.counter_add("serve.batches", 1.0)
        reg.observe("serve.batch_size", float(len(reqs)))
