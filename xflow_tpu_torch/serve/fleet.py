"""Replica fleet — N PredictEngine replicas behind one admission-
controlled router, with digest-guarded staged rollout.

The in-process serving stack (engine + MicroBatcher) serves one
replica.  Production traffic wants three more disciplines, modeled on
the replica/rollout/SLO structure of Google's ads scoring
infrastructure (PAPERS.md, arXiv:2501.10546) and the model-freshness
hot-swap hooks the online-advertising framework paper treats as table
stakes (arXiv:2201.05500):

* **Replication.**  ``ReplicaFleet.load`` loads ONE artifact and fans
  it out to N replicas via ``PredictEngine.clone()`` — shared weights
  and one executable key set fleet-wide, but a private MicroBatcher,
  stream and set of CUDA graphs per replica (serve/engine.py), so each
  replica's worker thread owns its host staging and its graphs' static
  buffers.  Requests route round-robin;
  every replica batcher pools ONE registry, so ``serve_stats`` rows
  are fleet-wide windows.

* **Admission control / load shedding.**  Before a request enqueues,
  the chosen replica's backlog is checked against the micro-batch
  deadline budget: queue DEPTH over ``depth_budget`` or queue AGE over
  ``deadline_budget_ms`` sheds the request with a typed
  :class:`ShedError` (cause ``queue_depth`` / ``queue_age``), counted
  per cause and reported in ``serve_shed`` JSONL rows.  Shedding at
  the door keeps the p99 of ADMITTED requests inside the deadline
  budget instead of letting the queue eat the SLO for everyone.

* **Staged rollout.**  ``begin_rollout(artifact)`` loads the candidate
  (digest-guarded: a different config digest is a redeploy, refused
  unless ``force``), swaps it into ONE canary replica, and routes
  ``canary_frac`` of traffic there.  The canary's completions/errors/
  latency accumulate under the fleet lock; ``commit_rollout`` refuses
  until the health gate passes (``min_canary_requests`` served,
  error fraction ≤ ``max_error_frac``) and then swaps every remaining
  replica atomically (each batcher swap is atomic per coalesced batch,
  so no batch ever mixes two artifacts).  ``abort_rollout`` swaps the
  canary back.  Every transition logs a ``rollout`` JSONL row;
  ``obs doctor`` flags a rollout that begins and never resolves
  (canary-stuck).

* **Replica health / self-healing** (docs/ROBUSTNESS.md).  A replica
  whose scoring keeps raising (``evict_after_errors`` consecutive
  errors — the ``serve.replica_score`` failpoint drives this in the
  chaos gate) is EVICTED from routing with a ``replica_evicted``
  health row; the shrunken fleet's backlog sheds at the door via
  ``AdmissionPolicy`` (typed 429s, never a silent SLO bleed), and a
  background revive thread re-clones the replica from the shared
  artifact state and swaps it back (``replica_revived``).  With every
  replica evicted, submits shed with cause ``replica_unavailable``.

Thread model (XF006–XF009 clean by construction): the fleet owns no
long-lived threads — replica MicroBatcher workers and the HTTP handler
threads (serve/server.py) drive it; the short-lived revive threads are
tracked in ``_revive_threads`` and joined (bounded) by ``close()``.  All mutable fleet state (router counter,
rollout state, shed/error counters) lives under ``self._lock``; the
lock is never held across a blocking call, a batcher submit, or an
engine swap's digest check... with one deliberate exception: commit/
abort swap replicas under the fleet lock so a concurrent ``submit``
can never route to a half-swapped fleet (lock order fleet._lock →
MicroBatcher._swap_lock, acyclic — batcher code never takes the fleet
lock).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Sequence

from xflow_tpu_torch.obs.registry import Histogram, MetricsRegistry
from xflow_tpu_torch.obs.schema import health_row
from xflow_tpu_torch.serve.batcher import MicroBatcher, stats_row_from_snapshot

# QoS admission classes, best-protected first.  All classes share one
# queue; lower classes see SCALED admission budgets (ReplicaFleet
# qos_normal_frac / qos_best_effort_frac), so as pressure mounts
# best_effort crosses its (smallest) budget and sheds first, normal
# next, and bidding — the auction-critical path — last, at the full
# budget.  The wire carries the class as the XFB1 frame's QoS byte
# (serve/binary.py) or the X-XFlow-QoS header (serve/server.py).
QOS_CLASSES = ("bidding", "normal", "best_effort")


class ShedError(RuntimeError):
    """Typed backpressure: the request was REJECTED by admission
    control, not failed — the caller should retry after backoff (the
    HTTP front end maps this to 429 with the cause in the body)."""

    def __init__(self, cause: str, depth: int, queue_age_s: float,
                 budget: str, qos: str | None = None):
        super().__init__(
            f"request shed: {cause} (depth {depth}, oldest queued "
            f"{queue_age_s * 1e3:.1f}ms, budget {budget}"
            + (f", class {qos}" if qos else "")
            + ")"
        )
        self.cause = cause
        self.depth = depth
        self.queue_age_s = queue_age_s
        self.qos = qos


class RolloutError(RuntimeError):
    """A rollout transition was refused (no rollout open, one already
    open, or the canary health gate has not passed)."""


class AdmissionPolicy:
    """Shed decision for ONE replica backlog against the micro-batch
    deadline budget.  ``deadline_budget_ms`` bounds the oldest queued
    request's age (a newcomer queues behind it, so its age floors the
    newcomer's wait); ``depth_budget`` bounds raw backlog depth."""

    def __init__(self, deadline_budget_ms: float = 50.0,
                 depth_budget: int = 256):
        if deadline_budget_ms <= 0 or depth_budget < 1:
            raise ValueError(
                "deadline_budget_ms must be > 0 and depth_budget >= 1"
            )
        self.deadline_budget_s = deadline_budget_ms / 1000.0
        self.depth_budget = depth_budget

    def check(self, batcher: MicroBatcher) -> str | None:
        """Shed cause for admitting one more request to ``batcher``
        right now, or None to admit."""
        if batcher.depth() >= self.depth_budget:
            return "queue_depth"
        if batcher.queue_age_s() > self.deadline_budget_s:
            return "queue_age"
        return None

    def describe(self) -> str:
        return (
            f"age<={self.deadline_budget_s * 1e3:.0f}ms,"
            f"depth<{self.depth_budget}"
        )

    def scaled(self, frac: float) -> "AdmissionPolicy":
        """A strictly-tighter copy for a lower QoS class: both budgets
        scaled by ``frac`` (depth floored at 1 so the class can still
        admit on an idle fleet)."""
        if not 0.0 < frac <= 1.0:
            raise ValueError("QoS budget fraction must be in (0, 1]")
        return AdmissionPolicy(
            deadline_budget_ms=self.deadline_budget_s * 1000.0 * frac,
            depth_budget=max(1, int(self.depth_budget * frac)),
        )


class ReplicaFleet:
    def __init__(
        self,
        engine,
        replicas: int = 2,
        *,
        max_wait_ms: float = 2.0,
        max_batch: int | None = None,
        deadline_budget_ms: float = 50.0,
        depth_budget: int = 256,
        metrics_logger=None,
        flight=None,
        registry: MetricsRegistry | None = None,
        evict_after_errors: int = 3,
        revive: bool = True,
        topk: bool = False,
        reqtrace=None,
        qos_normal_frac: float = 0.75,
        qos_best_effort_frac: float = 0.45,
        default_qos: str = "normal",
        cache=None,
    ):
        if replicas < 1:
            raise ValueError("a fleet needs at least 1 replica")
        if evict_after_errors < 1:
            raise ValueError("evict_after_errors must be >= 1")
        if default_qos not in QOS_CLASSES:
            raise ValueError(
                f"default_qos {default_qos!r} not in {QOS_CLASSES}"
            )
        if not (0.0 < qos_best_effort_frac <= qos_normal_frac <= 1.0):
            raise ValueError(
                "need 0 < qos_best_effort_frac <= qos_normal_frac <= 1 "
                "(best_effort sheds first, bidding last)"
            )
        self.policy = AdmissionPolicy(deadline_budget_ms, depth_budget)
        # per-class admission: bidding at the FULL budget, lower
        # classes strictly tighter — the ordering invariant `obs
        # doctor` checks as qos_inversion
        self.policies = {
            "bidding": self.policy,
            "normal": self.policy.scaled(qos_normal_frac),
            "best_effort": self.policy.scaled(qos_best_effort_frac),
        }
        self.default_qos = default_qos
        # topk fleets never cache: entries are scalar pctrs, not
        # (ids, scores) pairs
        if topk:
            cache = None
        self.registry = registry if registry is not None else MetricsRegistry()
        self.metrics_logger = metrics_logger
        self.flight = flight
        # request-scoped tracing (obs/reqtrace.py): when a
        # ReqTraceSink is attached, every submit opens a RequestSpan
        # (minting a root TraceContext when the caller carried none)
        # and emit_stats flushes the head+tail-sampled window.  None =
        # tracing off, zero per-request overhead.  A cascade's two
        # fleets share ONE sink and override reqtrace_stage so
        # retrieval/ranking spans of a trace land in the same window.
        self.reqtrace = reqtrace
        self.reqtrace_stage = "topk" if topk else "score"
        # top-k fleet (the cascade's retrieval stage): every replica
        # batcher runs the engine's topk leg; submit() Futures resolve
        # to (item_ids, scores).  Mode is fleet-wide — one fleet, one
        # endpoint semantics.
        self.topk = topk
        self.engines = [engine] + [
            engine.clone() for _ in range(replicas - 1)
        ]
        self.batchers = [
            MicroBatcher(
                e,
                max_wait_ms=max_wait_ms,
                max_batch=max_batch,
                registry=self.registry,
                metrics_logger=None,  # the fleet owns the stats rows
                flight=flight,
                emit_on_close=False,
                topk=topk,
                cache=cache,
            )
            for e in self.engines
        ]
        self._lock = threading.Lock()
        self._seq = 0  # request sequence (idle round-robin)
        # non-canary round-robin under an open rollout — its OWN
        # counter: _seq stays phase-locked with the canary stripe (at
        # canary_frac=0.5 every non-canary _seq is odd), so indexing
        # others[] by _seq would starve some replicas entirely
        self._rr = 0
        self._admitted = 0
        self._completed = 0
        self._errors = 0
        self._shed: dict[str, int] = {}
        # per-QoS-class window counters (serve_shed by_class)
        self._class_admitted = {c: 0 for c in QOS_CLASSES}
        self._class_shed = {c: 0 for c in QOS_CLASSES}
        # replica health (docs/ROBUSTNESS.md): a replica whose scoring
        # keeps raising is EVICTED from routing (capacity shrinks, so
        # AdmissionPolicy sheds the overflow at the door) and a
        # background revive thread re-clones it from the shared
        # artifact state.  All of it under self._lock; revive threads
        # are tracked and joined (bounded) by close() — XF006.
        self.evict_after_errors = evict_after_errors
        self._revive_enabled = revive
        self._err_streak = [0] * replicas
        self._unhealthy: set[int] = set()
        self._revive_threads: list[threading.Thread] = []
        self._evictions = 0
        self._revivals = 0
        self._rollout: dict[str, Any] | None = None
        # serializes rollout-row emission (terminal rows vs the stats
        # window's canary heartbeat) WITHOUT holding the fleet lock
        # across logger I/O — see emit_stats
        self._ro_log_lock = threading.Lock()
        self._closed = False
        self._drained = threading.Event()
        self._final_rows: dict = {}
        self._load_kw: dict[str, Any] = {}
        self.digest = engine.digest
        # servable identity (config digest @ step — serve/artifact.py
        # ::servable_digest): advances on every COMMITTED rollout,
        # including delta refreshes where the config digest does not
        # change; the continuous-training loop and /v1/stats read it to tell
        # which model VERSION traffic converged on
        self.servable = getattr(engine, "servable_digest", "?")
        # hot-key score cache (serve/scache.py) in front of the
        # batchers (they insert; submit() looks up).  The cache pins
        # THIS fleet's servable digest; commit_rollout re-pins it
        # inside the same critical section that swaps `servable`, so
        # lookups and inserts can never disagree about the current
        # version.
        self.cache = cache
        if self.cache is not None:
            self.cache.registry = self.registry
            self.cache.set_current(self.servable)

    # -- construction -------------------------------------------------------

    @classmethod
    def load(
        cls,
        artifact: str,
        replicas: int = 2,
        *,
        num_devices: int = 1,
        device="cuda",
        buckets: Sequence[int] | None = None,
        obs=None,
        warm: bool = True,
        topk_k: int | None = None,
        cache_capacity: int | None = None,
        **kw,
    ) -> "ReplicaFleet":
        """Load one artifact from the shared store and fan it out to
        ``replicas`` clones (one compile set, shared weights).
        ``topk_k`` sizes the compiled top-k width for retrieval
        artifacts (engine.load attaches their item index either
        way).  ``cache_capacity`` sizes the hot-key score cache
        (serve/scache.py; 0 = off, None = the artifact config's
        ``serve_cache_capacity`` knob); the artifact's QoS budget
        fractions seed the per-class admission policies unless
        overridden in ``kw``."""
        from xflow_tpu_torch.serve.engine import PredictEngine

        engine = PredictEngine.load(
            artifact,
            num_devices=num_devices,
            device=device,
            buckets=buckets,
            obs=obs,
            warm=warm,
            topk_k=topk_k,
        )
        cfg = engine.cfg
        kw.setdefault("qos_normal_frac", cfg.serve_qos_normal_frac)
        kw.setdefault(
            "qos_best_effort_frac", cfg.serve_qos_best_effort_frac
        )
        if "cache" not in kw:
            if cache_capacity is None:
                cache_capacity = cfg.serve_cache_capacity
            if cache_capacity > 0:
                from xflow_tpu_torch.serve.scache import ScoreCache

                kw["cache"] = ScoreCache(cache_capacity)
        fleet = cls(engine, replicas, **kw)
        # rollouts load candidates the same way this fleet was loaded
        fleet._load_kw = {
            "num_devices": num_devices,
            "device": device,
            "buckets": buckets,
            "obs": obs,
            "topk_k": topk_k,
        }
        fleet.log_load(artifact)
        return fleet

    def log_load(self, artifact: str) -> None:
        """One ``serve_load`` row for the artifact this fleet serves.
        ``load`` calls it; the CLI calls it AGAIN after attaching a
        metrics logger (the logger's run header needs the loaded
        digest, so it cannot exist before ``load`` returns)."""
        if self.metrics_logger is None:
            return
        with self._lock:  # engines[] mutates under rollout/revive
            e = self.engines[0]
        self.metrics_logger.log("serve_load", {
            "artifact": artifact,
            "config_digest": e.digest,
            "model": e.cfg.model,
            "buckets": list(e.buckets),
            "warm_seconds": round(e.warm_seconds, 6),
            "compiles": e.compile_count,
        })

    @property
    def cfg(self):
        with self._lock:  # engines[] mutates under rollout/revive
            e = self.engines[0]
        return e.cfg

    @property
    def replicas(self) -> int:
        return len(self.batchers)

    # -- request side -------------------------------------------------------

    def _route(self) -> tuple[int, dict | None]:
        """(replica index, rollout token) for the next request — the
        token is the open rollout dict when this request is canary
        traffic, else None (``_done`` compares it by IDENTITY, so a
        straggler from an aborted rollout can never pollute the next
        rollout's health gate).  Under an open rollout,
        ``canary_frac`` of the sequence goes to the canary replica —
        error-accumulator striping (Bresenham), so canary requests
        INTERLEAVE with fleet traffic at any fraction (a modulo split
        would aim a contiguous burst of full offered QPS at the one
        canary replica and shed it into a spurious gate failure) —
        and the rest round-robins the others; idle fleets round-robin
        everything."""
        with self._lock:
            if self._closed:
                raise RuntimeError("ReplicaFleet is closed")
            self._seq += 1
            healthy = [
                i for i in range(len(self.batchers))
                if i not in self._unhealthy
            ]
            if not healthy:
                # every replica is evicted: shed at the door with its
                # own typed cause — capacity is gone, not queued away
                self._shed["replica_unavailable"] = (
                    self._shed.get("replica_unavailable", 0) + 1
                )
                raise ShedError(
                    "replica_unavailable", 0, 0.0,
                    "all replicas evicted (revive pending)",
                )
            ro = self._rollout
            if ro is not None:
                # an evicted canary falls through to the healthy rest:
                # the rollout gate simply stops accumulating until the
                # revive lands (health rows make the overlap visible)
                if ro["canary"] in healthy:
                    ro["acc"] += ro["canary_frac"]
                    if ro["acc"] >= 1.0:
                        ro["acc"] -= 1.0
                        return ro["canary"], ro
                others = [i for i in healthy if i != ro["canary"]]
                if not others:  # single healthy replica: all canary
                    return ro["canary"], ro
                self._rr += 1
                return others[self._rr % len(others)], None
            return healthy[self._seq % len(healthy)], None

    def submit(self, keys, slots=None, vals=None, trace=None,
               qos: str | None = None) -> Future:
        """Admission-checked enqueue onto one replica; returns the
        pctr Future.  Raises :class:`ShedError` when the replica's
        backlog breaches the deadline budget — the typed backpressure
        signal, never silently queued past the SLO.  ``trace`` is an
        optional ``obs.reqtrace.TraceContext`` carried in from the
        wire; with a sink attached, the span opens HERE (t_arrival)
        so admission wait + routing are inside the tree — sheds
        complete immediately with status "shed" (always kept by the
        sampler).

        ``qos`` picks the admission class (QOS_CLASSES; None = the
        fleet's ``default_qos``) — each class checks ITS policy, so
        under pressure best_effort sheds first and bidding last.

        With a score cache attached, a row already scored by the
        CURRENT servable resolves right here — no routing, no queue,
        no device.  Cache lookups are suspended while a rollout is
        open so the canary stripe sees full traffic (a cache-starved
        health gate would never accumulate its min_requests)."""
        if qos is None:
            qos = self.default_qos
        elif qos not in QOS_CLASSES:
            raise ValueError(
                f"unknown QoS class {qos!r} (want one of {QOS_CLASSES})"
            )
        sink = self.reqtrace
        span = (
            sink.start(trace, self.reqtrace_stage)
            if sink is not None
            else None
        )
        if self.cache is not None:
            with self._lock:
                servable = self.servable
                cacheable = self._rollout is None and not self._closed
            if cacheable:
                score = self.cache.lookup(servable, keys, slots, vals)
                if score is not None:
                    with self._lock:
                        self._admitted += 1
                        self._completed += 1
                        self._class_admitted[qos] += 1
                    if span is not None:
                        sink.complete(span, "ok", detail="cache_hit")
                    fut: Future = Future()
                    fut.set_result(score)
                    return fut
        try:
            idx, ro_token = self._route()
        except ShedError as e:
            with self._lock:
                self._class_shed[qos] += 1
            if span is not None:
                sink.complete(span, "shed", detail=e.cause)
            e.qos = qos
            raise
        if span is not None:
            span.replica = idx
        batcher = self.batchers[idx]
        cause = self.policies[qos].check(batcher)
        if cause is not None:
            batcher.note_shed(cause)
            with self._lock:
                self._shed[cause] = self._shed.get(cause, 0) + 1
                self._class_shed[qos] += 1
            if span is not None:
                sink.complete(span, "shed", detail=cause)
            raise ShedError(
                cause,
                batcher.depth(),
                batcher.queue_age_s(),
                self.policies[qos].describe(),
                qos=qos,
            )
        t0 = time.perf_counter()
        fut = batcher.submit(keys, slots, vals, trace=span)
        with self._lock:
            self._admitted += 1
            self._class_admitted[qos] += 1
        fut.add_done_callback(
            lambda f, t0=t0, ro=ro_token, i=idx: self._done(f, t0, ro, i)
        )
        return fut

    def score(self, keys, slots=None, vals=None,
              timeout: float | None = 60.0) -> float:
        return float(self.submit(keys, slots, vals).result(timeout))

    def _done(self, fut: Future, t0: float,
              ro_token: dict | None, idx: int) -> None:
        """Completion bookkeeping (runs on the resolving replica's
        worker thread — worker context, so everything under the fleet
        lock).  Canary health only counts completions whose routing
        token IS the still-open rollout: a straggler from a resolved
        rollout must not feed the gate of the one that replaced it.
        Scoring errors feed the replica-health streak: at
        ``evict_after_errors`` consecutive errors the replica is
        evicted from routing and a background revive re-clones it."""
        err = fut.exception() is not None
        dt = time.perf_counter() - t0
        evict = False
        with self._lock:
            self._completed += 1
            if err:
                self._errors += 1
                self._err_streak[idx] += 1
                if (
                    self._err_streak[idx] >= self.evict_after_errors
                    and idx not in self._unhealthy
                    and not self._closed
                ):
                    self._unhealthy.add(idx)
                    self._evictions += 1
                    evict = True
            else:
                self._err_streak[idx] = 0
            ro = self._rollout
            if ro_token is not None and ro is ro_token:
                ro["requests"] += 1
                if err:
                    ro["errors"] += 1
                else:
                    # errors have their own gate (max_error_frac); a
                    # fast-failing or timed-out request must not skew
                    # the p99 gate's success-latency population
                    ro["latency"].observe(dt)
        if evict:
            self._evict(idx)

    # -- replica health (eviction / revive) ---------------------------------

    def _evict(self, idx: int) -> None:
        """One replica just crossed the error streak: it is already out
        of routing (``_unhealthy``, set by _done under the lock);
        here — outside the lock — comes the loud part (health row,
        counter) and the background revive.  Shrunk capacity is real:
        the survivors' queues grow and AdmissionPolicy sheds the
        overflow at the door, which is the design (never queue past
        the deadline budget on a sick fleet)."""
        self.registry.counter_add("serve.replica_evicted")
        if self.metrics_logger is not None:
            self.metrics_logger.log("health", health_row(
                cause="replica_evicted",
                channel="serve",
                silence_seconds=0.0,
                threshold_seconds=0.0,
                detail=f"replica {idx}: {self.evict_after_errors} "
                "consecutive scoring error(s) — evicted from routing",
            ))
        if not self._revive_enabled:
            return
        # not fire-and-forget: tracked in _revive_threads and joined
        # (bounded) by close()
        t = threading.Thread(  # xf: ignore[XF006]
            target=self._revive,
            args=(idx,),
            name=f"xflow-replica-revive-{idx}",
            daemon=True,
        )
        with self._lock:
            # prune finished revives so a flapping replica can't grow
            # the list for the process lifetime
            self._revive_threads = [
                rt for rt in self._revive_threads if rt.is_alive()
            ]
            self._revive_threads.append(t)
        t.start()

    def _revive(self, idx: int) -> None:
        """Background revive: re-clone the replica from the shared
        artifact state (PredictEngine.clone — shared weights + AOT
        executables, fresh host-side staging) and swap it back into
        routing.  A failed revive leaves the replica evicted (capacity
        stays shed) with its own health row — never a silent retry
        loop."""
        try:
            for _ in range(8):  # bounded: rollouts can't starve this
                with self._lock:
                    src = self.engines[idx]
                clone = src.clone()  # outside the lock: not free
                # re-verify under the lock before installing (the
                # commit_rollout discipline): a rollout that committed
                # while we cloned has already swapped engines[idx] —
                # force-installing our pre-commit clone would silently
                # revert this one replica to the old artifact, the
                # exact mixed-fleet state rollouts exist to prevent.
                # Lock order fleet._lock -> batcher._swap_lock matches
                # commit/abort.
                with self._lock:
                    if self.engines[idx] is not src:
                        continue  # re-clone from the new incumbent
                    self.batchers[idx].swap(clone, force=True)
                    self.engines[idx] = clone
                    self._unhealthy.discard(idx)
                    self._err_streak[idx] = 0
                    self._revivals += 1
                    break
            else:
                raise RuntimeError(
                    "engine kept changing under the revive (8 "
                    "rollout swaps mid-clone)"
                )
            self.registry.counter_add("serve.replica_revived")
            if self.metrics_logger is not None:
                self.metrics_logger.log("health", health_row(
                    cause="replica_revived",
                    channel="serve",
                    silence_seconds=0.0,
                    threshold_seconds=0.0,
                    detail=f"replica {idx}: re-cloned from the shared "
                    "artifact and returned to routing",
                ))
        except Exception as e:
            if self.metrics_logger is not None:
                self.metrics_logger.log("health", health_row(
                    cause="replica_revive_failed",
                    channel="serve",
                    silence_seconds=0.0,
                    threshold_seconds=0.0,
                    detail=f"replica {idx}: {type(e).__name__}: {e} — "
                    "left evicted, fleet serving at reduced capacity",
                ))

    def health(self) -> dict:
        """Live replica-health snapshot (the /v1/stats and chaos-gate
        surface)."""
        with self._lock:
            return {
                "unhealthy": sorted(self._unhealthy),
                "evictions": self._evictions,
                "revivals": self._revivals,
            }

    def pending(self) -> bool:
        """Any replica has queued or in-flight work — the watchdog's
        serve-channel pending probe for the whole fleet."""
        return any(b.pending() for b in self.batchers)

    def depth(self) -> int:
        return sum(b.depth() for b in self.batchers)

    def queue_age_s(self) -> float:
        return max(b.queue_age_s() for b in self.batchers)

    # -- staged rollout -----------------------------------------------------

    def _load_candidate(self, artifact):
        if not isinstance(artifact, str):
            return artifact  # pre-built engine (tests, live handoff)
        from xflow_tpu_torch.serve.engine import PredictEngine

        # candidates must match the incumbent's serving geometry; a
        # directly-constructed fleet (no load()) derives it from the
        # engine it was built around instead of silently loading the
        # defaults (1-device mesh, default buckets → recompiles and
        # latency shifts with no error)
        with self._lock:  # engines[] mutates under rollout/revive
            inc = self.engines[0]
        kw = self._load_kw or {
            "device": inc.device,
            "buckets": list(inc.buckets),
            "obs": inc.obs,
        }
        return PredictEngine.load(artifact, warm=True, **kw)

    def _log_rollout(self, event: str, ro: dict, detail: str) -> None:
        if self.metrics_logger is not None:
            self.metrics_logger.log("rollout", {
                "event": event,
                "from_digest": ro["from_digest"],
                "to_digest": ro["to_digest"],
                "canary_frac": ro["canary_frac"],
                "canary_requests": ro["requests"],
                "canary_errors": ro["errors"],
                "detail": detail,
            })

    def begin_rollout(
        self,
        artifact,
        canary_frac: float = 0.1,
        *,
        min_canary_requests: int = 32,
        max_error_frac: float = 0.0,
        max_p99_ms: float | None = None,
        auto_commit: bool = False,
        force: bool = False,
    ) -> dict:
        """Load the candidate artifact (or take a pre-built engine),
        swap it into one canary replica, and start routing
        ``canary_frac`` of traffic there.  Digest-guarded: a candidate
        whose config digest differs from the serving digest is refused
        unless ``force`` (that is a redeploy, not a rollout) — the
        check runs BEFORE any traffic shifts.  Returns the rollout
        state snapshot."""
        if not 0.0 < canary_frac <= 1.0:
            raise ValueError("canary_frac must be in (0, 1]")
        # cheap refusals BEFORE the candidate load: an already-open
        # rollout must not cost a full artifact load + warm compile on
        # the handler thread (the authoritative re-check still runs
        # under the lock below)
        with self._lock:
            if self._closed:
                raise RuntimeError("ReplicaFleet is closed")
            if self._rollout is not None:
                raise RolloutError(
                    "a rollout is already open (commit or abort it "
                    "first)"
                )
        candidate = self._load_candidate(artifact)
        if self.topk and getattr(candidate, "topk_k", 0) < 1:
            raise ValueError(
                "rollout refused: this is a top-k fleet but the "
                "candidate artifact has no item index — run "
                "serve.artifact.export_item_index on it first (a "
                "candidate that cannot answer top-k would evict every "
                "replica it reaches)"
            )
        if not force and candidate.digest != self.digest:
            raise ValueError(
                f"rollout refused: candidate digest {candidate.digest} "
                f"!= serving digest {self.digest} (different config/"
                "geometry is a redeploy — pass force=True only if you "
                "mean it)"
            )
        # _ro_log_lock held across rollout creation AND the begin row:
        # the rollout becomes routable the moment the fleet lock drops,
        # and a fast auto-commit (accept-loop tick) takes _ro_log_lock
        # for its terminal row — holding it here guarantees "begin" is
        # the stream's first row for this rollout.  Order matches
        # emit_stats: _ro_log_lock -> _lock.
        with self._ro_log_lock:
            ro = self._begin_rollout_locked(
                candidate, canary_frac, min_canary_requests,
                max_error_frac, max_p99_ms, auto_commit, force,
            )
            self._log_rollout(
                "begin", ro,
                f"canary replica {ro['canary']}; servable "
                f"{getattr(ro['old'], 'servable_digest', '?')} -> "
                f"{getattr(candidate, 'servable_digest', '?')}",
            )
        return self.rollout_state()

    def _begin_rollout_locked(
        self, candidate, canary_frac, min_canary_requests,
        max_error_frac, max_p99_ms, auto_commit, force,
    ) -> dict:
        with self._lock:
            if self._closed:
                raise RuntimeError("ReplicaFleet is closed")
            if self._rollout is not None:
                raise RolloutError(
                    "a rollout is already open (commit or abort it "
                    "first)"
                )
            canary = 0
            old = self.batchers[canary].engine
            self.batchers[canary].swap(candidate, force=force)
            # keep engines[] mirroring what each batcher serves: stats
            # reads compile_count through it, and a canary recompile
            # storm must be visible DURING the canary phase
            self.engines[canary] = candidate
            self._rollout = {
                "canary": canary,
                "candidate": candidate,
                "old": old,
                "from_digest": old.digest,
                "to_digest": candidate.digest,
                "canary_frac": float(canary_frac),
                "min_requests": int(min_canary_requests),
                "max_error_frac": float(max_error_frac),
                "max_p99_ms": max_p99_ms,
                "auto_commit": bool(auto_commit),
                # a forced begin (redeploy) implies forced swaps at
                # commit: the remaining replicas still run the OLD
                # digest, so the commit-side swap needs force too
                "force": bool(force),
                "acc": 0.0,  # canary striping accumulator (_route)
                "requests": 0,
                "errors": 0,
                "latency": Histogram(capacity=4096),
                "t0": time.perf_counter(),
            }
            return self._rollout

    def rollout_state(self) -> dict | None:
        """JSON-ready snapshot of the open rollout (None when idle):
        counters, health verdict, and the gate it is waiting on."""
        with self._lock:
            ro = self._rollout
            if ro is None:
                return None
            return dict(self._health_locked(ro), **{
                "from_digest": ro["from_digest"],
                "to_digest": ro["to_digest"],
                "canary_frac": ro["canary_frac"],
                "canary_replica": ro["canary"],
                "auto_commit": ro["auto_commit"],
                "age_seconds": round(
                    time.perf_counter() - ro["t0"], 3
                ),
            })

    def _health_locked(self, ro: dict) -> dict:
        """Canary health under the already-held fleet lock."""
        n, e = ro["requests"], ro["errors"]
        error_frac = e / n if n else 0.0
        p99_s = ro["latency"].percentile(99)
        healthy = n >= ro["min_requests"] and error_frac <= ro[
            "max_error_frac"
        ]
        if healthy and ro["max_p99_ms"] is not None:
            healthy = p99_s * 1000.0 <= ro["max_p99_ms"]
        return {
            "canary_requests": n,
            "canary_errors": e,
            "error_frac": round(error_frac, 6),
            "canary_p99_ms": round(p99_s * 1000.0, 3),
            "healthy": healthy,
            "gate": (
                f"requests>={ro['min_requests']},"
                f"error_frac<={ro['max_error_frac']}"
                + (
                    f",p99<={ro['max_p99_ms']}ms"
                    if ro["max_p99_ms"] is not None
                    else ""
                )
            ),
        }

    def commit_rollout(self, force: bool = False) -> dict:
        """Atomic fleet-wide swap to the candidate — refused until the
        canary health gate passes (``force`` overrides).  Every
        remaining replica gets its own clone of the candidate (shared
        weights + executables); each batcher swap is per-batch atomic,
        so in-flight batches finish on the old engine and no batch
        ever mixes artifacts."""
        with self._lock:
            ro = self._rollout
            if ro is None:
                raise RolloutError("no rollout open")
            health = self._health_locked(ro)
            if not force and not health["healthy"]:
                raise RolloutError(
                    f"commit refused: canary not healthy ({health}) — "
                    "wait for the gate or abort_rollout()"
                )
            candidate = ro["candidate"]
        # clone outside the lock (TrainStep construction is not free;
        # submits must not stall behind it), then re-take it and verify
        # the rollout is still THIS one before the atomic swap
        clones = [
            candidate.clone()
            for i in range(len(self.batchers))
            if i != ro["canary"]
        ]
        with self._lock:
            if self._rollout is not ro:
                raise RolloutError(
                    "rollout changed during commit (concurrent "
                    "commit/abort won)"
                )
            health = self._health_locked(ro)
            it = iter(clones)
            for i, b in enumerate(self.batchers):
                if i == ro["canary"]:
                    self.engines[i] = candidate
                    continue
                b.swap(next(it), force=force or ro["force"])
                self.engines[i] = b.engine
            self.digest = candidate.digest
            self.servable = getattr(candidate, "servable_digest", "?")
            if self.cache is not None:
                # re-pin + evict the old generation ATOMICALLY with
                # the servable swap (scache.py's whole contract): no
                # window where a lookup under the new digest could see
                # a pre-swap score, and old-engine stragglers that
                # resolve after this point insert under a digest the
                # cache no longer accepts.  Lock order fleet._lock →
                # ScoreCache._lock, acyclic (cache code never takes
                # the fleet lock — XF007).
                self.cache.set_current(self.servable)
            self._rollout = None
        with self._ro_log_lock:
            self._log_rollout("commit", ro, f"health {health}")
        return health

    def abort_rollout(self, detail: str = "") -> dict:
        """Swap the canary back to the old engine and close the
        rollout; traffic re-converges on the incumbent artifact."""
        with self._lock:
            ro = self._rollout
            if ro is None:
                raise RolloutError("no rollout open")
            health = self._health_locked(ro)
            self.batchers[ro["canary"]].swap(ro["old"], force=True)
            self.engines[ro["canary"]] = ro["old"]
            if self.cache is not None:
                # servable unchanged on abort — same-digest re-pin is
                # a no-op, but it defends the invariant explicitly
                self.cache.set_current(self.servable)
            self._rollout = None
        with self._ro_log_lock:
            self._log_rollout("abort", ro, detail or f"health {health}")
        return health

    def rollout_delta(self, delta_dir: str, **gate_kw) -> dict:
        """Begin a staged rollout of an incremental delta export
        (stream/delta.py): refused until ROADMAP A12 ports the
        digest-chained delta that ``PredictEngine.apply_delta`` folds
        onto the incumbent."""
        raise NotImplementedError(
            "rollout_delta: incremental delta exports are not ported "
            "yet (ROADMAP A12)"
        )

    def rollout_tick(self) -> str | None:
        """Advance an auto rollout: commit once the health gate passes,
        abort once the error gate is provably failed (enough canary
        traffic, too many errors).  Called periodically from the HTTP
        server's accept loop (serve/server.py ``service_actions``);
        returns the transition taken, if any."""
        with self._lock:
            ro = self._rollout
            if ro is None or not ro["auto_commit"]:
                return None
            health = self._health_locked(ro)
            doomed = (
                ro["requests"] >= ro["min_requests"]
                and health["error_frac"] > ro["max_error_frac"]
            )
        try:
            if health["healthy"]:
                self.commit_rollout()
                return "commit"
            if doomed:
                self.abort_rollout(detail="auto: error gate failed")
                return "abort"
        except RolloutError:
            # a concurrent manual commit/abort won the race — the
            # rollout resolved either way
            pass
        return None

    # -- stats / lifecycle --------------------------------------------------

    def _shed_row_locked(self) -> dict:
        total = sum(self._shed.values())
        denom = self._admitted + total
        return {
            "admitted": self._admitted,
            "completed": self._completed,
            "shed_total": total,
            "shed_frac": round(total / denom, 6) if denom else 0.0,
            "by_cause": dict(self._shed),
            # per-QoS-class split (additive-OPTIONAL in obs/schema.py:
            # pre-QoS streams without it still validate).  The
            # ordering invariant — bidding sheds only after best_effort
            # does — is what `obs doctor` checks as qos_inversion.
            "by_class": {
                c: {
                    "admitted": self._class_admitted[c],
                    "shed": self._class_shed[c],
                }
                for c in QOS_CLASSES
            },
            "errors": self._errors,
        }

    def emit_stats(self) -> dict:
        """Flush one fleet-wide window: a ``serve_stats`` row (pooled
        registry snapshot, with per-bucket e2e percentiles) and a
        ``serve_shed`` row (admitted/shed per cause + live backlog).
        Window counters reset; returns ``{"stats": ..., "shed": ...}``.
        """
        snap = self.registry.snapshot(reset=True)
        row = stats_row_from_snapshot(snap)
        per_bucket = {}
        pre = "serve.e2e.b"
        for name, h in sorted(snap.hists.items()):
            if name.startswith(pre):
                per_bucket[name[len(pre):]] = {
                    "requests": int(h["count"]),
                    "p50": round(h["p50"], 6),
                    "p99": round(h["p99"], 6),
                }
        row["per_bucket"] = per_bucket
        if self.cache is not None:
            # windowed cache counters ride the serve_stats row
            # (additive-OPTIONAL fields in obs/schema.py)
            row.update(self.cache.stats_row(reset=True))
        with self._lock:
            shed = self._shed_row_locked()
            self._admitted = 0
            self._completed = 0
            self._errors = 0
            self._shed = {}
            self._class_admitted = {c: 0 for c in QOS_CLASSES}
            self._class_shed = {c: 0 for c in QOS_CLASSES}
            ro = self._rollout
        shed["depth"] = self.depth()
        shed["queue_age_s"] = round(self.queue_age_s(), 6)
        if self.metrics_logger is not None:
            self.metrics_logger.log("serve_stats", row)
            self.metrics_logger.log("serve_shed", shed)
        if self.reqtrace is not None:
            # trace windows align with stats windows: the same tick
            # that flushes serve_stats emits the window's sampled
            # reqtrace rows (errors + sheds + slowest-k + head sample)
            self.reqtrace.flush()
        if ro is not None:
            # open-rollout heartbeat row: a stream that ends on one of
            # these (no commit/abort after) is what `obs doctor` flags
            # as canary-stuck.  Ordering discipline WITHOUT logger I/O
            # under the fleet lock: the still-open check runs under
            # the fleet lock, the log itself only under _ro_log_lock.
            # commit/abort clear _rollout (fleet lock) BEFORE taking
            # _ro_log_lock for their terminal row, so either we see
            # the rollout resolved and skip, or we hold _ro_log_lock
            # first and the terminal row lands after our heartbeat —
            # a stale "canary" can never be the stream's last word.
            with self._ro_log_lock:
                with self._lock:
                    still_open = self._rollout is ro
                if still_open:
                    self._log_rollout("canary", ro, "rollout open")
        return {"stats": row, "shed": shed}

    def stats(self) -> dict:
        """Non-destructive live view (the /v1/stats endpoint): pooled
        registry snapshot WITHOUT reset + admission counters + rollout
        state."""
        snap = self.registry.snapshot(reset=False)
        with self._lock:
            shed = self._shed_row_locked()
            engine0 = self.engines[0]
        return {
            "digest": self.digest,
            "servable": self.servable,
            "replicas": self.replicas,
            "stats": stats_row_from_snapshot(snap),
            "shed": shed,
            "depth": self.depth(),
            "queue_age_s": round(self.queue_age_s(), 6),
            "rollout": self.rollout_state(),
            "health": self.health(),
            "compiles": engine0.compile_count,
            "qos": {
                c: self.policies[c].describe() for c in QOS_CLASSES
            },
            "cache": (
                self.cache.stats_row(reset=False)
                if self.cache is not None
                else None
            ),
        }

    def close(self) -> dict:
        """Drain every replica (accepted requests all score), then
        flush the final fleet window.  Idempotent; a rollout still
        open at close stays UNRESOLVED in the stream — shutting down
        mid-canary IS the canary-stuck condition doctor should see."""
        with self._lock:
            first = not self._closed
            self._closed = True
        if first:
            try:
                for b in self.batchers:
                    b.close()
                # revive threads joined (bounded) before the final
                # window: a revive racing shutdown must not swap into
                # a closed fleet unobserved (XF006 — no thread outlives
                # close silently)
                with self._lock:
                    revives = list(self._revive_threads)
                for t in revives:
                    t.join(timeout=10.0)
                    if t.is_alive():
                        import warnings

                        warnings.warn(
                            f"replica revive thread {t.name} outlived "
                            "the close() join",
                            RuntimeWarning,
                            stacklevel=2,
                        )
                        self.registry.counter_add(
                            "serve.revive_thread_leak"
                        )
                final = self.emit_stats()
                with self._lock:
                    self._final_rows = final
            finally:
                # set even on failure so concurrent closers never hang
                self._drained.set()
        else:
            # bounded by construction: the FIRST closer sets _drained in
            # a finally even when drain raises, and its joins are
            # timeout-bounded (xf: ignore[XF017])
            self._drained.wait()
        with self._lock:
            return self._final_rows

    def __enter__(self) -> "ReplicaFleet":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
