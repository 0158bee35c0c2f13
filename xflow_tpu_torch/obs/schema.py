"""Metrics JSONL schema: every ``kind`` and its required fields.

This is the single source of truth for what the trainer emits
(docs/OBSERVABILITY.md documents the semantics).  Consumed by:

* ``obs.summary`` — tolerant reads, but warns on schema violations;
* ``scripts/check_metrics_schema.py`` — the CI lint that runs the toy
  pipeline and validates its output strictly;
* ``tests/test_observability.py`` — asserts every emitted row passes.

A field listed here must appear in EVERY row of that kind the current
code emits.  Adding a field is backward-compatible (old files still
summarize); removing or renaming one is a schema change — update this
module, the doc, and the lint together.
"""

from __future__ import annotations

import json
from typing import Any, Iterable

# kind -> {field: type-or-tuple-of-types} for isinstance checks.
# Backend-dependent values (e.g. device memory stats) are OMITTED from
# their row rather than emitted as null, so no nullable types exist.
SCHEMA: dict[str, dict[str, Any]] = {
    # one per MetricsLogger open (run delimiter — summarize splits here;
    # hostname/pid — OPTIONAL below — let `obs merge`/`obs doctor`
    # label hosts in multi-host runs; stamped centrally by
    # MetricsLogger, so every current emitter carries them)
    "run_start": {
        "t": (int, float),
        "kind": str,
        "run_id": str,
        "config_digest": str,
        "rank": int,
        "num_hosts": int,
        "time_unix": (int, float),
    },
    # one per training epoch
    "train_epoch": {
        "t": (int, float),
        "kind": str,
        "epoch": int,
        "examples": (int, float),
        "steps": int,
        "train_logloss": (int, float),
        "examples_per_sec": (int, float),
        "seconds": (int, float),
        "checkpoint_seconds": (int, float),
        "preempted": bool,
        # main-thread-exclusive phase seconds: disjoint intervals whose
        # sum accounts for (nearly all of) `seconds`
        "phases": dict,
        # worker-thread phase seconds (parse/pack/h2d under
        # transfer-ahead): overlap the main thread, NOT additive with it
        "overlapped": dict,
        "input_stall_frac": (int, float),
        "step_time_p50": (int, float),
        "step_time_p90": (int, float),
        "step_time_p99": (int, float),
    },
    # one per evaluate() call
    "eval": {
        "t": (int, float),
        "kind": str,
        "epoch": int,
        "logloss": (int, float),
        "auc": (int, float),
        "examples": int,
        "tp": int,
        "fp": int,
        "seconds": (int, float),
        "phases": dict,
        "overlapped": dict,
    },
    # one per finished training shard (per host; loader throughput)
    "shard": {
        "t": (int, float),
        "kind": str,
        "epoch": int,
        "shard": str,
        "index": int,
        "examples": int,
        "seconds": (int, float),
        "examples_per_sec": (int, float),
    },
    # one per reader stream per epoch under the input fan-out
    # (Config.input_streams > 1; io/fanout.py, docs/PERF.md "Input
    # fan-out"): finished-shard totals, producer wall seconds, and
    # backpressure stall seconds (producer blocked on a full queue —
    # the consumer's fault, not the stream's).  read_seconds is the
    # directly measured read+parse+compact time (queue waits
    # excluded); examples_per_sec = examples / read_seconds, so `obs
    # doctor` can rank a genuinely slow stream (shard skew, slow
    # disk) as a straggler without blaming a stream parked behind a
    # saturated device.
    "stream": {
        "t": (int, float),
        "kind": str,
        "epoch": int,
        "stream": int,
        "shards": int,
        "batches": int,
        "examples": int,
        "seconds": (int, float),
        "read_seconds": (int, float),
        "stall_seconds": (int, float),
        "examples_per_sec": (int, float),
    },
    # one per epoch: the devices' memory stats
    "device_mem": {
        "t": (int, float),
        "kind": str,
        "epoch": int,
        "devices": list,
    },
    # one per training epoch when any batch crossed the host->device
    # link: wire-format accounting (parallel/step.py::_book_wire;
    # docs/PERF.md "Wire format and compaction").  format names the
    # wire that ran ("dict" = host-compacted dictionary wire, "compact",
    # "full"); wire_bytes_per_example is what actually crossed the link
    # per real example; compaction_ratio is cold occurrences per
    # big-table touch after host dedup (1.0 = no dedup)
    "wire": {
        "t": (int, float),
        "kind": str,
        "epoch": int,
        "format": str,
        "wire_bytes_per_example": (int, float),
        "compaction_ratio": (int, float),
    },
    # one per training epoch under store_mode='tiered': hierarchical
    # parameter-store accounting (store/tiered.py; docs/STORE.md).
    # hot_hit_rate is occurrence-weighted (feature occurrences the HBM
    # hot tier served / all real occurrences); cold_fetch_seconds is
    # host time spent gathering miss rows; hot_occupancy is the
    # fraction of hot-tier slots assigned at epoch end.  `obs doctor`
    # reads these for the store-thrash diagnosis.
    "store": {
        "t": (int, float),
        "kind": str,
        "epoch": int,
        "hot_hit_rate": (int, float),
        "promotions": int,
        "demotions": int,
        "cold_fetch_seconds": (int, float),
        "hot_occupancy": (int, float),
    },
    # -- serving (serve/; docs/SERVING.md) ---------------------------------
    # one per PredictEngine artifact load: bucket geometry + warmup cost
    "serve_load": {
        "t": (int, float),
        "kind": str,
        "artifact": str,
        "config_digest": str,
        "model": str,
        "buckets": list,
        "warm_seconds": (int, float),
        "compiles": int,
    },
    # one per MicroBatcher flush/close: per-request latency percentiles
    # (queue = enqueue→dequeue, featurize = request→Batch assembly,
    # device = h2d + execute + fetch) over the window since the last
    # emission, plus coalescing effectiveness (requests/batches) and
    # the admission-control sheds booked against this window
    "serve_stats": {
        "t": (int, float),
        "kind": str,
        "requests": int,
        "batches": int,
        "swaps": int,
        "batch_fill_mean": (int, float),
        "queue_p50": (int, float),
        "queue_p99": (int, float),
        "featurize_p50": (int, float),
        "featurize_p99": (int, float),
        "device_p50": (int, float),
        "device_p99": (int, float),
    },
    # one per `python -m xflow_tpu_torch.serve bench` run: end-to-end serving
    # latency/throughput under concurrent load
    "serve_bench": {
        "t": (int, float),
        "kind": str,
        "requests": int,
        "concurrency": int,
        "seconds": (int, float),
        "requests_per_sec": (int, float),
        "e2e_p50": (int, float),
        "e2e_p99": (int, float),
        "queue_p50": (int, float),
        "queue_p99": (int, float),
        "featurize_p50": (int, float),
        "featurize_p99": (int, float),
        "device_p50": (int, float),
        "device_p99": (int, float),
        "compiles": int,
    },
    # one per fleet stats window (serve/fleet.py): admission-control
    # accounting — requests admitted vs shed (per cause) plus the live
    # backlog at emission.  A window whose shed_frac dominates is a
    # shed storm: admission control protected the deadline budget by
    # rejecting at the door (`obs doctor` blames capacity, not the
    # queue).
    "serve_shed": {
        "t": (int, float),
        "kind": str,
        "admitted": int,
        "shed_total": int,
        "shed_frac": (int, float),
        "by_cause": dict,
        "errors": int,
        "depth": int,
        "queue_age_s": (int, float),
    },
    # one per staged-rollout transition (serve/fleet.py): event is
    # begin / canary (open-rollout heartbeat, flushed with each stats
    # window) / commit / abort.  A stream whose LAST rollout row is
    # begin/canary died mid-rollout — `obs doctor` flags canary-stuck.
    "rollout": {
        "t": (int, float),
        "kind": str,
        "event": str,
        "from_digest": str,
        "to_digest": str,
        "canary_frac": (int, float),
        "canary_requests": int,
        "canary_errors": int,
        "detail": str,
    },
    # one per retrieval→ranking cascade stats window
    # (serve/cascade.py; docs/SERVING.md "Retrieval→ranking cascade"):
    # per-stage latency attribution (retrieval vs ranking p50/p99 —
    # `obs doctor` blames the right fleet) and candidate accounting
    # (k requested vs returned; `starved` counts requests the
    # retrieval stage answered with fewer than k candidates)
    "cascade": {
        "t": (int, float),
        "kind": str,
        "requests": int,
        "errors": int,
        "shed_total": int,
        "starved": int,
        "k": int,
        "k_returned_mean": (int, float),
        "retrieval_p50": (int, float),
        "retrieval_p99": (int, float),
        "rank_p50": (int, float),
        "rank_p99": (int, float),
        "e2e_p50": (int, float),
        "e2e_p99": (int, float),
    },
    # one per KEPT span per reqtrace flush (obs/reqtrace.py;
    # docs/OBSERVABILITY.md "Tracing a request"): span is "request"
    # (one request's passage through one fleet stage — trace/span/
    # parent ids, status ok|error|shed, e2e seconds, the five-phase
    # decomposition admission_wait/coalesce_wait/swap_stall/featurize/
    # device, and keep = WHY the sampler kept it: head|slow|error|
    # shed|tree) or "batch" (one coalesced batch fanning in its
    # member trace_ids — exactly one engine digest per batch).  The
    # two variants share only the trunk fields; the rest are
    # per-variant and OPTIONAL below.
    "reqtrace": {
        "t": (int, float),
        "kind": str,
        "span": str,
        "status": str,
        "phases": dict,
        "keep": str,
    },
    # one per continuous-training export/rollout transition
    # (stream/, docs/CONTINUOUS.md): event is export (a
    # delta/base was cut) / commit (the canary gate passed and the
    # fleet swapped — for commits, newest_event_age_s IS the
    # event-to-servable freshness the SLO is about) / abort (the gate
    # refused; the fleet stays on the incumbent and freshness keeps
    # aging).  `obs doctor` ranks a stream whose last row exceeds
    # slo_s, or whose rollouts repeatedly abort, as servable_stale.
    "freshness": {
        "t": (int, float),
        "kind": str,
        "event": str,
        "newest_event_age_s": (int, float),
        "slo_s": (int, float),
        "servable": str,
        "export_kind": str,
        "step": int,
        "rows": int,
        "delta_bytes": int,
        "deltas_since_base": int,
    },
    # -- robustness (xflow_tpu_torch/chaos/; docs/ROBUSTNESS.md) -----------------
    # one per failpoint FIRE when the chaos fabric is armed
    # (Config.chaos_spec / XFLOW_CHAOS): site is the failpoint name,
    # hit the site's crossing count at fire time, fires the site's
    # cumulative fire count.  scripts/check_chaos.py reconciles these
    # rows against the registry's in-memory fire counts and demands a
    # matching `health` row from the layer that healed each fault.
    "chaos": {
        "t": (int, float),
        "kind": str,
        "site": str,
        "hit": int,
        "fires": int,
        "detail": str,
    },
    # -- diagnosis (obs/watchdog.py, obs/flight.py; docs/OBSERVABILITY.md
    # "Diagnosing a sick run") ---------------------------------------------
    # one per watchdog incident transition: a trip (cause names the
    # classified stall) or a recovery (cause "recovered:<original>",
    # silence_seconds = how long the stall lasted)
    "health": {
        "t": (int, float),
        "kind": str,
        "cause": str,
        "channel": str,
        "silence_seconds": (int, float),
        "threshold_seconds": (int, float),
        "detail": str,
        # every channel's last-heartbeat age at emission — the
        # cross-channel context that separates "loader dead" from
        # "loader fine, transfer wedged"
        "channels": dict,
    },
    # one per flight-recorder dump: a pointer row so `obs doctor` finds
    # the dump file from the metrics stream alone
    "flight_dump": {
        "t": (int, float),
        "kind": str,
        "path": str,
        "reason": str,
        "active_phase": str,
    },
    # -- live telemetry plane (obs/live.py, obs/export.py;
    # docs/OBSERVABILITY.md "Operating a live fleet") ----------------------
    # one per SLO alert transition (obs/live.py AlertEvaluator): state
    # is firing (both the short AND the long burn-rate window breached
    # the rule's threshold) or resolved (the short window dropped back
    # under it).  value is the short-window mean at transition time;
    # `obs doctor` treats these rows as first-class evidence.
    "alert": {
        "t": (int, float),
        "kind": str,
        "rule": str,
        "state": str,
        "value": (int, float),
        "threshold": (int, float),
        "short_s": (int, float),
        "long_s": (int, float),
        "samples": int,
        "detail": str,
    },
    # one per host resource sample (obs/export.py ResourceSampler):
    # stdlib-only process telemetry — RSS, cumulative CPU seconds,
    # live thread count, open file descriptors, cumulative GC
    # collections — so a leak or a CPU-bound straggler shows up in the
    # same stream as the metrics it distorts.
    "resource": {
        "t": (int, float),
        "kind": str,
        "rss_bytes": int,
        "cpu_seconds": (int, float),
        "threads": int,
        "open_fds": int,
        "gc_collections": int,
    },
}


# kind -> {field: types} for fields that are type-checked when present
# but NOT required: added after files of that kind already existed in
# the wild (append-mode files span upgrades — a resumed run writes a
# new-format header into a file whose old headers predate the field).
OPTIONAL: dict[str, dict[str, Any]] = {
    "run_start": {
        "hostname": str,
        "pid": int,
    },
    "train_epoch": {
        # single-host runs under trainer._transfer_ahead only
        "transfer_ahead_depth_mean": (int, float),
        # loaders that report parse phase bytes only
        "parse_mb_per_sec": (int, float),
    },
    # fleet-mode rows only (serve/fleet.py pools N replicas into one
    # registry; rows written before the production tier predate these
    # fields, so requiring them would fail old streams)
    "serve_stats": {
        "per_bucket": dict,
        "shed_total": int,
        # hot-key score cache window (serve/scache.py) — only fleets
        # with a cache attached write these
        "cache_hits": int,
        "cache_misses": int,
        "cache_hit_rate": (int, float),
        "cache_entries": int,
        "cache_bytes": int,
        "cache_evictions": int,
        "cache_invalidations": int,
        "cache_inserts_dropped": int,
    },
    # scored-and-returned count alongside admitted (completions lag
    # admissions by the in-flight window; rows from before the counter
    # predate the field)
    "serve_shed": {
        "completed": int,
        # per-QoS-class admitted/shed split (serve/fleet.py
        # QOS_CLASSES) — additive like per_bucket: pre-QoS metrics
        # streams without it still validate (pinned by
        # tests/test_serve_binary.py back-compat test)
        "by_class": dict,
    },
    # loadgen rows only (serve/loadgen.py open-loop SLO accounting;
    # the closed-loop `bench` CLI predates these fields)
    "serve_bench": {
        "offered_qps": (int, float),
        "offered_qps_actual": (int, float),
        "achieved_qps": (int, float),
        "shed_frac": (int, float),
        "shed_by_cause": dict,
        "errors": int,
        "outstanding": int,
        "per_bucket": dict,
        # 429s the HttpTarget retried after honoring Retry-After
        # (capped exponential backoff) — chaos runs measure RECOVERY,
        # not just rejection; rows from before the field predate it
        "retried": int,
        # traced runs only (obs/reqtrace.py): client-observed
        # slowest-3 as {trace_id, e2e_ms, phases_ms?} — the bench
        # row NAMES its tail so `obs doctor`'s attribution and a
        # human reading the row point at the same span trees
        "slowest_exemplars": list,
        # which wire carried the traffic: "fleet" (in-process),
        # "http", or "binary" — the two-leg SLO gate
        # (check_serve_slo.py --compare-transports) keys on it
        "transport": str,
        # mixed-QoS runs only: offered/shed counts per class
        "qos_offered": dict,
        "qos_shed": dict,
    },
    # per-variant fields (span "request" vs "batch" share only the
    # trunk — requiring the union would fail every row)
    "reqtrace": {
        "trace_id": str,
        "span_id": str,
        "parent_span_id": str,
        "stage": str,
        "sampled": bool,
        "e2e": (int, float),
        "replica": int,
        "batch": str,
        "bucket": int,
        "digest": str,
        "detail": str,
        "n": int,
        "trace_ids": list,
    },
}


def health_row(
    cause: str,
    channel: str,
    silence_seconds: float,
    threshold_seconds: float,
    detail: str,
    channels: dict | None = None,
) -> dict:
    """A schema-complete ``health`` record body.  Every emitter
    (watchdog trips/recoveries, loader prefetch-leak, batcher
    worker-leak, gate smokes) builds the row HERE so a field added to
    the ``health`` schema breaks one constructor, not N inlined
    dicts."""
    return {
        "cause": cause,
        "channel": channel,
        "silence_seconds": round(silence_seconds, 3),
        "threshold_seconds": round(threshold_seconds, 3),
        "detail": detail,
        "channels": channels if channels is not None else {},
    }


def alert_row(
    rule: str,
    state: str,
    value: float,
    threshold: float,
    short_s: float,
    long_s: float,
    samples: int,
    detail: str,
) -> dict:
    """A schema-complete ``alert`` record body (health_row discipline:
    every emitter builds the row here)."""
    return {
        "rule": rule,
        "state": state,
        "value": round(float(value), 6),
        "threshold": round(float(threshold), 6),
        "short_s": round(float(short_s), 3),
        "long_s": round(float(long_s), 3),
        "samples": int(samples),
        "detail": detail,
    }


def resource_row(
    rss_bytes: int,
    cpu_seconds: float,
    threads: int,
    open_fds: int,
    gc_collections: int,
) -> dict:
    """A schema-complete ``resource`` record body."""
    return {
        "rss_bytes": int(rss_bytes),
        "cpu_seconds": round(float(cpu_seconds), 3),
        "threads": int(threads),
        "open_fds": int(open_fds),
        "gc_collections": int(gc_collections),
    }


def validate_row(row: dict, lineno: int | None = None) -> list[str]:
    """Schema errors for one parsed JSONL row ([] = valid)."""
    where = f"line {lineno}: " if lineno is not None else ""
    kind = row.get("kind")
    if kind is None:
        return [f"{where}row has no 'kind' field"]
    spec = SCHEMA.get(kind)
    if spec is None:
        return [f"{where}unknown kind {kind!r}"]
    errors = []
    for name, types in spec.items():
        if name not in row:
            errors.append(f"{where}kind {kind!r} missing field {name!r}")
            continue
        if not isinstance(row[name], types):
            errors.append(
                f"{where}kind {kind!r} field {name!r}: expected "
                f"{types}, got {type(row[name]).__name__}"
            )
    for name, types in OPTIONAL.get(kind, {}).items():
        if name in row and not isinstance(row[name], types):
            errors.append(
                f"{where}kind {kind!r} optional field {name!r}: "
                f"expected {types}, got {type(row[name]).__name__}"
            )
    return errors


def validate_rows(rows: Iterable[dict]) -> list[str]:
    errors = []
    for i, row in enumerate(rows, 1):
        errors.extend(validate_row(row, lineno=i))
    return errors


def load_jsonl(path: str) -> list[dict]:
    """Parse a metrics file; raises ValueError on a malformed line."""
    rows = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except ValueError as e:
                raise ValueError(f"{path}:{i}: not valid JSON: {e}")
    return rows


def load_jsonl_tolerant(path: str) -> tuple[list[dict], int]:
    """Parse a metrics file that may still be APPENDED to: a torn
    FINAL line (the writer is mid-``write``, or the file was copied
    mid-line) is skipped and counted instead of raising.  A malformed
    line anywhere else is still corruption and raises exactly like
    ``load_jsonl`` — torn tails are expected on live files, torn
    middles are not.  Returns ``(rows, skipped)`` with skipped in
    {0, 1}."""
    with open(path) as f:
        lines = f.readlines()
    rows: list[dict] = []
    skipped = 0
    last = len(lines)
    for i, line in enumerate(lines, 1):
        stripped = line.strip()
        if not stripped:
            continue
        try:
            rows.append(json.loads(stripped))
        except ValueError as e:
            if i == last:
                skipped = 1
                break
            raise ValueError(f"{path}:{i}: not valid JSON: {e}")
    return rows, skipped
