"""Retrieval→ranking cascade — candidate generation feeding the ranker.

A production recommender answers "what should we show this user?", not
"what is the pctr of this (user, item) pair?" — the point-scoring tier
(PRs 2/10) is only the second half.  The CascadeEngine composes the
full shape (arXiv:2501.10546, PAPERS.md):

    request (user features, k)
      → admission check at the front door
      → RETRIEVAL fleet: top-k item candidates from the serve-time
        item-embedding index (ReplicaFleet in topk mode over a
        two-tower artifact — one user-tower pass + dot scan)
      → RANKING fleet: point-score each candidate as a full
        user+item feature row (any point-score family; the DCN
        explicit-cross ranker is the built-for-it one)
      → results ranked by pctr

Both stages are ordinary :class:`~xflow_tpu_torch.serve.fleet.ReplicaFleet`
instances — replication, admission control, replica health, and staged
rollout all apply PER STAGE, independently: canary a new ranker while
the retriever serves untouched, or roll the retriever (a new index
rides the artifact) behind an unchanged ranker, each through the
existing digest-guarded canary gate.

Threading: the cascade owns NO threads.  ``submit`` enqueues on the
retrieval fleet and chains completions — the retrieval replica's
worker thread fans the candidates out to the ranking fleet (enqueue
only, never blocking on results), and the LAST ranking completion
resolves the caller's Future.  All mutable cascade state (stats
counters) lives under ``self._lock``, never held across a submit.

Observability: per-stage latency and candidate-count accounting in one
``cascade`` JSONL row per stats window (obs/schema.py) — retrieval
p50/p99 vs ranking p50/p99 so a slow cascade blames the right fleet
(``obs doctor`` reads exactly that), plus candidate starvation
(retrieval returning fewer than the requested k — an index smaller
than k, never silent).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any

import numpy as np

from xflow_tpu_torch.obs.registry import MetricsRegistry
from xflow_tpu_torch.serve.fleet import ReplicaFleet, ShedError


class CascadeEngine:
    def __init__(
        self,
        retrieval: ReplicaFleet,
        ranking: ReplicaFleet,
        k: int = 8,
        metrics_logger=None,
        registry: MetricsRegistry | None = None,
    ):
        if not getattr(retrieval, "topk", False):
            raise ValueError(
                "the retrieval stage must be a top-k fleet "
                "(ReplicaFleet(..., topk=True) over a retrieval "
                "artifact with an item index)"
            )
        if getattr(ranking, "topk", False):
            raise ValueError(
                "the ranking stage must be a point-score fleet, not "
                "top-k"
            )
        cap = retrieval.engines[0].topk_k
        if not 1 <= k <= cap:
            raise ValueError(
                f"cascade k={k} outside [1, retrieval topk_k={cap}] — "
                "the retrieval engines compile ONE top-k width; load "
                "them with a larger topk_k for deeper candidate sets"
            )
        self.retrieval = retrieval
        self.ranking = ranking
        self.k = int(k)
        self.metrics_logger = metrics_logger
        self.registry = registry if registry is not None else MetricsRegistry()
        self._lock = threading.Lock()
        self._requests = 0
        self._errors = 0
        self._shed = 0
        self._starved = 0
        self._closed = False

    # -- request side -------------------------------------------------------

    def _front_door(self) -> None:
        """Admission control BEFORE any stage sees the request: the
        retrieval fleet's own door guards stage 1 inside submit();
        here the RANKING backlog is checked too — admitting a request
        whose k candidate scores would only pile onto a past-deadline
        ranking queue wastes retrieval capacity on work the ranker
        will shed anyway."""
        rk = self.ranking
        depth_cap = rk.policy.depth_budget * len(rk.batchers)
        if rk.depth() >= depth_cap or (
            rk.queue_age_s() > rk.policy.deadline_budget_s
        ):
            with self._lock:
                self._shed += 1
            self.registry.counter_add("cascade.shed")
            raise ShedError(
                "ranking_backlog",
                rk.depth(),
                rk.queue_age_s(),
                f"front door: ranking {rk.policy.describe()} x"
                f"{len(rk.batchers)} replicas",
            )

    def submit(
        self, keys, slots=None, vals=None, k: int | None = None,
        trace=None,
    ) -> Future:
        """One cascade request: USER-side features in the
        featurize_raw protocol; resolves to ``{"items": [k'], "pctr":
        [k'], "retrieval_scores": [k']}`` ranked by pctr descending.
        Raises :class:`ShedError` at the front door (ranking backlog)
        or from the retrieval stage's admission control; ranking-stage
        sheds resolve the Future with the ShedError.

        ``trace`` is an optional ``obs.reqtrace.TraceContext``: ONE
        trace id spans both stages — the retrieval span and every
        candidate's ranking span carry it, so a flushed window shows
        the whole fan-out as one tree (obs/reqtrace.py).  When the
        retrieval fleet traces and no context was carried in, one is
        minted here so in-process cascade callers correlate too."""
        kk = self.k if k is None else int(k)
        if kk < 1:
            raise ValueError(f"k must be >= 1, got {kk}")
        # no upper-bound refusal here: a retrieval rollout can shrink
        # the index/topk width under live traffic — the cascade serves
        # best-effort (fewer candidates than requested) and counts it
        # as starvation instead of failing requests
        with self._lock:
            if self._closed:
                raise RuntimeError("CascadeEngine is closed")
            self._requests += 1
        sink = getattr(self.retrieval, "reqtrace", None)
        if trace is None and sink is not None:
            trace = sink.mint()
        self._front_door()
        t0 = time.perf_counter()
        out: Future = Future()
        try:
            rfut = self.retrieval.submit(keys, slots, vals, trace=trace)
        except ShedError:
            with self._lock:
                self._shed += 1
            self.registry.counter_add("cascade.shed")
            raise
        user_row = (np.asarray(keys), slots, vals)
        rfut.add_done_callback(
            lambda f: self._on_retrieved(f, out, user_row, kk, t0, trace)
        )
        return out

    def recommend(
        self, keys, slots=None, vals=None, k: int | None = None,
        timeout: float | None = 60.0, trace=None,
    ) -> dict:
        return self.submit(keys, slots, vals, k=k, trace=trace).result(
            timeout
        )

    def _fail(self, out: Future, exc: BaseException) -> None:
        with self._lock:
            self._errors += 1
        self.registry.counter_add("cascade.errors")
        out.set_exception(exc)

    def _on_retrieved(
        self, rfut: Future, out: Future, user_row, k: int, t0: float,
        trace=None,
    ) -> None:
        """Stage-1 completion (retrieval replica worker thread): book
        the stage latency, assemble user+candidate ranking rows, fan
        them out to the ranking fleet — enqueue only; stage-2
        completions resolve ``out``."""
        t1 = time.perf_counter()
        err = rfut.exception()
        if err is not None:
            self._fail(out, err)
            return
        self.registry.observe("cascade.retrieval_seconds", t1 - t0)
        # the index rides the result (serve/batcher.py): candidate ids
        # resolve against the EXACT index that produced them — during
        # a retrieval canary, replicas serve different indexes, so
        # reading "the fleet's" index here would mismatch.  rfut is
        # already resolved: this runs in its done-callback after the
        # .exception() check above (xf: ignore[XF017])
        ids, scores, index = rfut.result()
        ids, scores = ids[:k], scores[:k]
        by_id = index["item_ids"]
        # item_ids -> index rows: the precomputed sorted order from
        # attach_item_index (per-request argsort over a production
        # catalog would serialize O(N log N) onto the retrieval
        # worker); ids came FROM this index, but verify the
        # round-trip anyway and drop any mismatch — never silently
        # rank the wrong item's features
        order = index.get("ids_order")
        if order is None:
            order = np.argsort(by_id, kind="stable")
        pos = np.clip(
            np.searchsorted(by_id, ids, sorter=order), 0, len(by_id) - 1
        )
        rows_idx = order[pos]
        ok = by_id[rows_idx] == ids
        if not ok.all():
            ids, scores, rows_idx = ids[ok], scores[ok], rows_idx[ok]
        if len(ids) < k:
            # candidate starvation — an index smaller than k, or
            # round-trip drops: served best-effort, counted loudly
            # (obs doctor's candidate_starvation diagnosis)
            with self._lock:
                self._starved += 1
            self.registry.counter_add("cascade.starved")
        self.registry.observe("cascade.k_returned", float(len(ids)))
        if not len(ids):
            self._fail(out, RuntimeError(
                "retrieval returned zero candidates"
            ))
            return
        ukeys, uslots, uvals = user_row
        n_user = len(ukeys)
        uslots = (
            np.zeros(n_user, np.int32) if uslots is None
            else np.asarray(uslots, np.int32)
        )
        uvals = (
            np.ones(n_user, np.float32) if uvals is None
            else np.asarray(uvals, np.float32)
        )
        pctr = np.zeros(len(ids), np.float32)
        remaining = [len(ids)]
        resolved = [False]  # out resolves exactly once (first error
        rlock = threading.Lock()  # OR last success — never both)

        def resolve_once() -> bool:
            with rlock:
                if resolved[0]:
                    return False
                resolved[0] = True
                return True

        def on_ranked(i: int, fut: Future) -> None:
            rerr = fut.exception()
            if rerr is not None:
                if resolve_once():
                    self._fail(out, rerr)
                return
            # fut is already resolved: done-callback after the
            # .exception() check above (xf: ignore[XF017])
            pctr[i] = fut.result()
            with rlock:
                remaining[0] -= 1
                last = remaining[0] == 0 and not resolved[0]
                if last:
                    resolved[0] = True
            if last:
                t2 = time.perf_counter()
                self.registry.observe("cascade.rank_seconds", t2 - t1)
                self.registry.observe("cascade.e2e_seconds", t2 - t0)
                rank = np.argsort(-pctr, kind="stable")
                out.set_result({
                    "items": [int(ids[j]) for j in rank],
                    "pctr": [round(float(pctr[j]), 6) for j in rank],
                    "retrieval_scores": [
                        round(float(scores[j]), 6) for j in rank
                    ],
                })

        for i, ridx in enumerate(rows_idx):
            m = int(index["item_nnz"][ridx])
            row = (
                np.concatenate([ukeys, index["item_keys"][ridx, :m]]),
                np.concatenate([uslots, index["item_slots"][ridx, :m]]),
                np.concatenate([uvals, index["item_vals"][ridx, :m]]),
            )
            try:
                # same trace id as the retrieval span: the ranking
                # fan-out IS this request's second stage
                rk_fut = self.ranking.submit(*row, trace=trace)
            except (ShedError, RuntimeError) as e:
                with self._lock:
                    self._shed += 1
                self.registry.counter_add("cascade.shed")
                if resolve_once():  # a prior candidate may have failed first
                    self._fail(out, e)
                return
            rk_fut.add_done_callback(
                lambda f, i=i: on_ranked(i, f)
            )

    # -- stats / lifecycle --------------------------------------------------

    def _counters_locked(self) -> dict:
        return {
            "requests": self._requests,
            "errors": self._errors,
            "shed_total": self._shed,
            "starved": self._starved,
        }

    def _row_from(self, counters: dict, snap) -> dict:
        def pct(name: str, p: str) -> float:
            return round(snap.hists.get(name, {}).get(p, 0.0), 6)

        kh = snap.hists.get("cascade.k_returned", {})
        return {
            **counters,
            "k": self.k,
            "k_returned_mean": round(kh.get("mean", 0.0), 3),
            "retrieval_p50": pct("cascade.retrieval_seconds", "p50"),
            "retrieval_p99": pct("cascade.retrieval_seconds", "p99"),
            "rank_p50": pct("cascade.rank_seconds", "p50"),
            "rank_p99": pct("cascade.rank_seconds", "p99"),
            "e2e_p50": pct("cascade.e2e_seconds", "p50"),
            "e2e_p99": pct("cascade.e2e_seconds", "p99"),
        }

    def emit_stats(self) -> dict:
        """Flush one cascade window as a ``cascade`` JSONL row
        (obs/schema.py); window counters reset.  The per-stage fleets
        keep their own serve_stats/serve_shed windows — this row is
        the CROSS-stage view (per-stage latency attribution +
        candidate accounting) those cannot express."""
        snap = self.registry.snapshot(reset=True)
        with self._lock:
            counters = self._counters_locked()
            self._requests = 0
            self._errors = 0
            self._shed = 0
            self._starved = 0
        row = self._row_from(counters, snap)
        if self.metrics_logger is not None:
            self.metrics_logger.log("cascade", row)
        return row

    def stats(self) -> dict:
        """Non-destructive live view (the /v1/stats cascade block)."""
        snap = self.registry.snapshot(reset=False)
        with self._lock:
            counters = self._counters_locked()
        return dict(
            self._row_from(counters, snap),
            retrieval={
                "digest": self.retrieval.digest,
                "replicas": self.retrieval.replicas,
                "depth": self.retrieval.depth(),
                "rollout": self.retrieval.rollout_state(),
                "topk_k": self.retrieval.engines[0].topk_k,
                # shape, not the meta "count" key — attach_item_index
                # accepts bare dicts without export metadata
                "index_items": int(len(
                    self.retrieval.engines[0].item_index["item_index"]
                )),
            },
            ranking={
                "digest": self.ranking.digest,
                "replicas": self.ranking.replicas,
                "depth": self.ranking.depth(),
                "rollout": self.ranking.rollout_state(),
            },
        )

    def pending(self) -> bool:
        return self.retrieval.pending() or self.ranking.pending()

    def close(self) -> dict:
        """Drain both stages (retrieval first — its in-flight
        completions fan out to the ranking queues, which must still
        accept them — then ranking), then flush the final cascade
        window.  Idempotent."""
        with self._lock:
            first = not self._closed
            self._closed = True
        if not first:
            return {}
        self.retrieval.close()
        self.ranking.close()
        return self.emit_stats()

    def __enter__(self) -> "CascadeEngine":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
