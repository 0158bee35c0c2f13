"""Request-scoped tracing across the serve path.

The serve tier's aggregate histograms (``serve_stats`` p99s, per-bucket
e2e, ``cascade`` stage rows) say THAT the tail is slow, never WHY one
request was slow.  This module is the per-request spine: a
``TraceContext`` (64-bit trace id + parent span id + sampling decision)
is minted at the HTTP front door — or accepted from an
``X-XFlow-Trace`` header / packed-wire field so the loadgen and
external clients correlate — and rides submit() through
AdmissionPolicy → ReplicaFleet routing → MicroBatcher coalescing →
the PredictEngine device call → both CascadeEngine stages.  Each
request materialises one ``RequestSpan`` stamping the five phase
boundaries:

    admission_wait  arrival → enqueued (admission check + routing)
    coalesce_wait   enqueued → batch sealed (micro-batch wait)
    swap_stall      batch sealed → engine captured (_swap_lock wait)
    featurize       rows → prepared Batch
    device          h2d + execute + fetch

and the batcher emits ONE batch span fanning in its N request spans
(same engine digest for every member by construction — the engine is
captured once under the swap lock, so a batch can never mix trace ids
across a rollout swap).

Sampling is head+tail: errors, sheds, and the window's slowest-k
exemplars are ALWAYS kept; the rest keep at ``Config.obs_reqtrace_sample``
via a deterministic splitmix64 hash of the trace id, so client and
server make the same decision without coordination.  Kept spans land as
``reqtrace`` JSONL rows (obs/schema.py) on every ``flush()`` — wired
into ``ReplicaFleet.emit_stats`` so trace windows align with
``serve_stats`` windows.  ``obs doctor`` attributes the tail to its
dominant phase; ``obs summarize`` prints the per-phase decomposition.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

__all__ = [
    "TraceContext",
    "RequestSpan",
    "ReqTraceSink",
    "PHASES",
    "format_header",
    "parse_header",
    "head_keep",
]

_MASK64 = (1 << 64) - 1

# phase vocabulary, in causal order — every request row's ``phases``
# dict carries exactly these keys (0.0 when a stage was never reached,
# e.g. a shed collapses everything into admission_wait)
PHASES = (
    "admission_wait",
    "coalesce_wait",
    "swap_stall",
    "featurize",
    "device",
)


def _mix64(x: int) -> int:
    """splitmix64 finalizer (same construction as chaos/registry.py) —
    turns sequential ids into uniform 64-bit words, so the sampling
    decision below is unbiased even for counter-minted trace ids."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def head_keep(trace_id: int, sample: float) -> bool:
    """Deterministic head-sampling decision for one trace id.

    Hash-based rather than random so every hop (client, front door,
    both cascade stages) agrees without carrying the verdict — and so
    replays are reproducible.  ``sample`` is a keep fraction in [0, 1].
    """
    if sample <= 0.0:
        return False
    if sample >= 1.0:
        return True
    # top 53 bits → uniform in [0, 1) without float rounding surprises
    return (_mix64(trace_id) >> 11) * 2.0**-53 < sample


class TraceContext:
    """The wire-portable triple: who is this request (trace_id), who
    asked (parent_span_id), and did the head-sampler keep it."""

    __slots__ = ("trace_id", "parent_span_id", "sampled")

    def __init__(
        self, trace_id: int, parent_span_id: int = 0, sampled: bool = False
    ):
        self.trace_id = trace_id & _MASK64
        self.parent_span_id = parent_span_id & _MASK64
        self.sampled = bool(sampled)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"TraceContext({self.trace_id:016x}, "
            f"parent={self.parent_span_id:016x}, sampled={self.sampled})"
        )


def format_header(ctx: TraceContext) -> str:
    """``X-XFlow-Trace`` header value: ``<trace>-<parent>-<0|1>``
    (16 lowercase hex digits each)."""
    return (
        f"{ctx.trace_id:016x}-{ctx.parent_span_id:016x}-"
        f"{1 if ctx.sampled else 0}"
    )


def parse_header(value: str | None) -> TraceContext | None:
    """Parse an ``X-XFlow-Trace`` header; None for absent/malformed —
    a bad trace header must never fail the request it annotates."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 3:
        return None
    try:
        tid = int(parts[0], 16)
        pid = int(parts[1], 16)
        flag = int(parts[2], 10)
    except ValueError:
        return None
    if not 0 < tid <= _MASK64 or not 0 <= pid <= _MASK64 or flag not in (0, 1):
        return None
    return TraceContext(tid, pid, bool(flag))


class RequestSpan:
    """One request's passage through one fleet stage.

    Mutable scratch object stamped in place by the fleet (arrival,
    shed) and the batcher worker (enqueue/seal/dequeue/featurize/
    device) — each field is written by exactly one thread at one point
    in the request's life, so no lock is needed until ``ReqTraceSink.
    complete`` freezes it into a record under the sink lock."""

    __slots__ = (
        "trace_id",
        "span_id",
        "parent_span_id",
        "sampled",
        "stage",
        "replica",
        "t_arrival",
        "t_enq",
        "t_seal",
        "t_deq",
        "t_feat",
        "t_done",
        "batch_id",
        "bucket",
        "digest",
        "sink",
    )

    def __init__(
        self,
        sink: "ReqTraceSink",
        ctx: TraceContext,
        span_id: int,
        stage: str,
    ):
        self.sink = sink
        self.trace_id = ctx.trace_id
        self.span_id = span_id
        self.parent_span_id = ctx.parent_span_id
        self.sampled = ctx.sampled
        self.stage = stage
        self.replica: int | None = None
        self.t_arrival = time.perf_counter()
        self.t_enq: float | None = None
        self.t_seal: float | None = None
        self.t_deq: float | None = None
        self.t_feat: float | None = None
        self.t_done: float | None = None
        self.batch_id: int | None = None
        self.bucket: int | None = None
        self.digest: str | None = None

    def context(self) -> TraceContext:
        """A child context: downstream spans parent onto THIS span."""
        return TraceContext(self.trace_id, self.span_id, self.sampled)


class ReqTraceSink:
    """Collects completed spans, applies head+tail sampling on flush,
    emits ``reqtrace`` JSONL rows.

    One sink per serving process is the intended shape (a cascade's two
    fleets share one, so retrieval and ranking spans of one trace land
    in the same window).  Thread-safe throughout: submit paths mint and
    complete from handler/worker threads while ``flush`` runs on the
    stats-window thread."""

    def __init__(
        self,
        metrics_logger=None,
        sample: float = 0.0,
        slow_k: int = 3,
        capacity: int = 65536,
    ):
        if not 0.0 <= sample <= 1.0:
            raise ValueError("reqtrace sample must be in [0, 1]")
        if slow_k < 0:
            raise ValueError("slow_k must be >= 0")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.metrics_logger = metrics_logger
        self.sample = float(sample)
        self.slow_k = int(slow_k)
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        # fresh random base per process so ids don't collide across
        # restarts writing to one JSONL; sequential offsets are mixed
        # through splitmix64 at mint time
        base = int.from_bytes(os.urandom(8), "big")
        self._id_seq = itertools.count(base)
        self._batch_seq = itertools.count(1)
        self._done: list[dict] = []  # completed request records
        self._batches: dict[int, dict] = {}  # batch_id -> batch record
        self._last_kept: list[dict] = []  # request rows of last flush
        self.dropped = 0  # records lost to the capacity cap

    # -- minting -----------------------------------------------------------

    def mint(self) -> TraceContext:
        """A fresh root context (front door / loadgen), head-sampling
        decision baked in."""
        tid = _mix64(next(self._id_seq)) or 1  # trace id 0 is reserved
        return TraceContext(tid, 0, head_keep(tid, self.sample))

    def start(
        self,
        trace: TraceContext | None,
        stage: str,
        replica: int | None = None,
    ) -> RequestSpan:
        """Open one request span (mints a root context when the caller
        carried none).  Stamps t_arrival = now."""
        if trace is None:
            trace = self.mint()
        span = RequestSpan(self, trace, _mix64(next(self._id_seq)), stage)
        span.replica = replica
        return span

    def next_batch_id(self) -> int:
        return next(self._batch_seq)

    # -- completion --------------------------------------------------------

    def complete(
        self, span: RequestSpan, status: str = "ok", detail: str | None = None
    ) -> None:
        """Freeze one span into a record.  Missing stamps chain-fill
        forward from the last one reached, so the phase dict always
        sums to e2e exactly — a shed books its whole life as
        admission_wait, a featurize error books zero device, etc."""
        now = time.perf_counter()
        span.t_done = now
        t0 = span.t_arrival
        enq = span.t_enq if span.t_enq is not None else now
        seal = span.t_seal if span.t_seal is not None else enq
        deq = span.t_deq if span.t_deq is not None else seal
        feat = span.t_feat if span.t_feat is not None else deq
        phases = {
            "admission_wait": max(0.0, enq - t0),
            "coalesce_wait": max(0.0, seal - enq),
            "swap_stall": max(0.0, deq - seal),
            "featurize": max(0.0, feat - deq),
            "device": max(0.0, now - feat),
        }
        rec = {
            "span": "request",
            "trace_id": f"{span.trace_id:016x}",
            "span_id": f"{span.span_id:016x}",
            "parent_span_id": f"{span.parent_span_id:016x}",
            "stage": span.stage,
            "status": status,
            "sampled": span.sampled,
            "e2e": round(now - t0, 6),
            "phases": {k: round(v, 6) for k, v in phases.items()},
        }
        if span.replica is not None:
            rec["replica"] = span.replica
        if span.batch_id is not None:
            rec["batch"] = f"b{span.batch_id}"
        if span.bucket is not None:
            rec["bucket"] = span.bucket
        if span.digest is not None:
            rec["digest"] = span.digest
        if detail:
            rec["detail"] = str(detail)[:200]
        with self._lock:
            if len(self._done) >= self.capacity:
                self.dropped += 1
            else:
                self._done.append(rec)

    def note_batch(
        self,
        batch_id: int,
        trace_ids: list[int],
        digest: str,
        bucket: int,
        phases: dict,
        status: str = "ok",
    ) -> None:
        """Record one coalesced batch span fanning in its members.
        Exactly one engine digest per batch — the batcher captures the
        engine once under its swap lock."""
        rec = {
            "span": "batch",
            "batch": f"b{batch_id}",
            "n": len(trace_ids),
            "trace_ids": [f"{t:016x}" for t in trace_ids],
            "digest": digest,
            "bucket": bucket,
            "status": status,
            "phases": {k: round(v, 6) for k, v in phases.items()},
        }
        with self._lock:
            self._batches[batch_id] = rec

    # -- emission ----------------------------------------------------------

    def _keep_reason(self, rec: dict, slow_ids: set) -> str | None:
        if rec["status"] == "error":
            return "error"
        if rec["status"] == "shed":
            return "shed"
        if id(rec) in slow_ids:
            return "slow"
        if rec["sampled"]:
            return "head"
        return None

    def flush(self) -> list[dict]:
        """Drain the window: emit errors + sheds + slowest-k + the
        head-sampled remainder (whole trace trees — if ANY span of a
        trace is kept, its sibling spans and referenced batch spans are
        kept too, so every emitted trace id has a complete tree).
        Returns the emitted rows; idempotent on an empty window."""
        with self._lock:
            done, self._done = self._done, []
            batches, self._batches = self._batches, {}
        if not done and not batches:
            return []
        slow_ids = {
            id(r)
            for r in sorted(done, key=lambda r: r["e2e"], reverse=True)[
                : self.slow_k
            ]
        }
        kept_traces: set[str] = set()
        for rec in done:
            reason = self._keep_reason(rec, slow_ids)
            if reason is not None:
                rec["keep"] = reason
                kept_traces.add(rec["trace_id"])
        rows: list[dict] = []
        kept_batches: set[str] = set()
        for rec in done:
            if rec["trace_id"] not in kept_traces:
                continue
            rec.setdefault("keep", "tree")  # sibling of a kept span
            rows.append(rec)
            if "batch" in rec:
                kept_batches.add(rec["batch"])
        for _bid, b in sorted(batches.items()):
            if b["batch"] in kept_batches:
                b["keep"] = "batch"  # kept by member reference
                rows.append(b)
        if self.metrics_logger is not None:
            for row in rows:
                self.metrics_logger.log("reqtrace", row)
        with self._lock:
            self._last_kept = [r for r in rows if r["span"] == "request"]
        return rows

    # -- exemplar access (serve_bench / doctor cross-checks) ---------------

    def exemplars(self, k: int = 3) -> list[dict]:
        """Top-k slowest request rows of the LAST flush as serve_bench
        ``slowest_exemplars`` entries (trace id + phase breakdown)."""
        with self._lock:
            kept = list(self._last_kept)
        kept.sort(key=lambda r: r["e2e"], reverse=True)
        return [
            {
                "trace_id": r["trace_id"],
                "stage": r["stage"],
                "e2e_ms": round(r["e2e"] * 1e3, 3),
                "phases_ms": {
                    p: round(v * 1e3, 3) for p, v in r["phases"].items()
                },
            }
            for r in kept[:k]
        ]

    def phases_of(self, trace_id_hex: str) -> dict | None:
        """Phase breakdown (ms) for one kept trace id of the last
        flush — the loadgen's client-recorded exemplar lookup."""
        with self._lock:
            for r in self._last_kept:
                if r["trace_id"] == trace_id_hex:
                    return {
                        p: round(v * 1e3, 3) for p, v in r["phases"].items()
                    }
        return None
