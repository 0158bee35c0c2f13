"""Concurrent HTTP front end over a ReplicaFleet — the RPC tier.

Dependency-free (stdlib ``http.server.ThreadingHTTPServer``): every
connection gets a handler thread, every scoring request routes through
the fleet's admission control into a replica MicroBatcher, so the
device still sees bucketed coalesced batches no matter how many
concurrent sockets are open.

Endpoints:

* ``POST /v1/score`` — JSON ``{"rows": [{"keys": [...], "slots":
  [...]?, "vals": [...]?}, ...]}`` → ``{"pctr": [...], "digest":
  ...}``.  A single row may be passed as ``{"keys": [...]}``.
* ``POST /v1/score_packed`` — the packed-binary wire (below), for
  callers who care about encode cost; same scoring path.
* ``GET /healthz`` — liveness + serving digest + rollout state.
* ``GET /v1/stats`` — non-destructive fleet stats snapshot.
* ``POST /v1/rollout`` — ``{"artifact": dir, "canary_frac": 0.1,
  "auto_commit": false, ...}`` begins a staged rollout;
  ``POST /v1/rollout/commit`` / ``/v1/rollout/abort`` resolve it.

Backpressure is TYPED: an admission-control shed returns **429** with
``{"error": "backpressure", "cause": "queue_depth"|"queue_age",
"retry_after_ms": ...}`` and a ``Retry-After`` header — clients
distinguish "slow down" from "broken" without string-matching.

Packed wire (little-endian): request ``b"XFS1" u32 nrows`` then per
row ``u16 nnz, nnz*u64 keys, nnz*u32 slots, nnz*f32 vals``; response
``u32 n, n*f32 pctr``.  ``encode_packed_request`` /
``decode_packed_response`` are the client halves (serve/loadgen.py
uses them).  A traced request uses magic ``b"XFS2"`` with a 17-byte
trace triple (``u64 trace_id, u64 parent_span_id, u8 sampled``)
between the magic and ``nrows`` — the packed-wire twin of the
``X-XFlow-Trace`` header (obs/reqtrace.py); either way the response
echoes the trace id in an ``X-XFlow-Trace`` response header so
clients can name their slow requests.

Liveness: the accept loop beats the flight recorder's ``http`` channel
from ``service_actions`` (called every poll of ``serve_forever``), so
a watchdog classifies a wedged accept loop as ``serve_accept_stall``
while the per-batch ``serve`` channel keeps covering the scoring path.
The same hook drives ``fleet.rollout_tick()`` — auto rollouts advance
even when no admin client is polling.

Shutdown (XF006): ``close()`` stops the accept loop, joins the server
thread with a timeout, waits briefly for in-flight handlers to drain
through the fleet, then closes the fleet (which drains every replica
queue — accepted requests all score) and flushes the final stats rows.
``python -m xflow_tpu_torch.serve serve`` routes SIGTERM here.
"""

from __future__ import annotations

import json
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from concurrent.futures import TimeoutError as FutureTimeout

from xflow_tpu_torch.chaos import ChaosError, failpoint
from xflow_tpu_torch.obs.reqtrace import TraceContext, format_header, parse_header
from xflow_tpu_torch.serve.fleet import (
    QOS_CLASSES,
    ReplicaFleet,
    RolloutError,
    ShedError,
)

PACKED_MAGIC = b"XFS1"
# traced packed request: magic + u64 trace_id + u64
# parent_span_id + u8 sampled, then the XFS1 body from nrows on
PACKED_TRACE_MAGIC = b"XFS2"
# how long a handler waits on its scoring futures before 504
# (ServeTier default; Config.serve_score_timeout_s overrides per tier)
SCORE_TIMEOUT_S = 60.0
# per-connection socket timeout on handler reads/writes (ServeTier
# default; Config.serve_socket_timeout_s overrides per tier): a client
# stalled mid-request releases its handler thread instead of pinning
# it forever (analysis rule XF017)
SOCKET_TIMEOUT_S = 30.0


# -- packed wire --------------------------------------------------------------


def encode_packed_request(rows: list, trace=None) -> bytes:
    """Rows are ``(keys, slots, vals)`` tuples (slots/vals may be
    None) or bare key arrays — the ``featurize_raw`` row protocol.
    With ``trace`` (a ``TraceContext``) the XFS2 traced variant is
    emitted so the server correlates its spans with this client."""
    if trace is None:
        out = [PACKED_MAGIC, struct.pack("<I", len(rows))]
    else:
        out = [
            PACKED_TRACE_MAGIC,
            struct.pack(
                "<QQB",
                trace.trace_id,
                trace.parent_span_id,
                1 if trace.sampled else 0,
            ),
            struct.pack("<I", len(rows)),
        ]
    for row in rows:
        keys, slots, vals = row if isinstance(row, tuple) else (
            row, None, None
        )
        k = np.asarray(keys, dtype=np.uint64)
        n = len(k)
        s = (
            np.zeros(n, np.uint32) if slots is None
            else np.asarray(slots, dtype=np.uint32)
        )
        v = (
            np.ones(n, np.float32) if vals is None
            else np.asarray(vals, dtype=np.float32)
        )
        if len(s) != n or len(v) != n:
            raise ValueError("keys/slots/vals length mismatch")
        out.append(struct.pack("<H", n))
        out.append(k.astype("<u8").tobytes())
        out.append(s.astype("<u4").tobytes())
        out.append(v.astype("<f4").tobytes())
    return b"".join(out)


def decode_packed_request(buf: bytes) -> list[tuple]:
    """Rows only — the pre-tracing signature every existing caller
    holds; traced callers use :func:`decode_packed_request_traced`."""
    return decode_packed_request_traced(buf)[0]


def decode_packed_request_traced(
    buf: bytes,
) -> tuple[list[tuple], TraceContext | None]:
    """(rows, trace) — ``trace`` is None for the untraced XFS1 magic."""
    trace: TraceContext | None = None
    off = 4
    if buf[:4] == PACKED_TRACE_MAGIC:
        if len(buf) < 25:  # magic + trace triple + nrows
            raise ValueError("truncated packed request (trace triple)")
        tid, pid, flag = struct.unpack_from("<QQB", buf, off)
        if tid == 0 or flag not in (0, 1):
            raise ValueError("bad packed-request trace triple")
        trace = TraceContext(tid, pid, bool(flag))
        off += 17
    elif buf[:4] != PACKED_MAGIC:
        raise ValueError(
            f"bad packed-request magic {buf[:4]!r} (want {PACKED_MAGIC!r}"
            f" or {PACKED_TRACE_MAGIC!r})"
        )
    (nrows,) = struct.unpack_from("<I", buf, off)
    off += 4
    rows: list[tuple] = []
    for _ in range(nrows):
        if off + 2 > len(buf):
            raise ValueError("truncated packed request (row header)")
        (nnz,) = struct.unpack_from("<H", buf, off)
        off += 2
        need = nnz * (8 + 4 + 4)
        if off + need > len(buf):
            raise ValueError("truncated packed request (row payload)")
        keys = np.frombuffer(buf, "<u8", nnz, off).astype(np.int64)
        off += nnz * 8
        slots = np.frombuffer(buf, "<u4", nnz, off).astype(np.int32)
        off += nnz * 4
        vals = np.frombuffer(buf, "<f4", nnz, off).astype(np.float32)
        off += nnz * 4
        rows.append((keys, slots, vals))
    if off != len(buf):
        raise ValueError(
            f"packed request has {len(buf) - off} trailing byte(s)"
        )
    return rows, trace


def encode_packed_response(pctr: np.ndarray) -> bytes:
    p = np.asarray(pctr, dtype=np.float32)
    return struct.pack("<I", len(p)) + p.astype("<f4").tobytes()


def decode_packed_response(buf: bytes) -> np.ndarray:
    (n,) = struct.unpack_from("<I", buf, 0)
    out = np.frombuffer(buf, "<f4", n, 4)
    if len(out) != n:
        raise ValueError("truncated packed response")
    return np.array(out)


# -- server -------------------------------------------------------------------


class _TierServer(ThreadingHTTPServer):
    # handler threads must not block process exit on a wedged socket.
    # NOTE: stdlib _Threads.append SKIPS daemon threads, so
    # server_close() joins nothing here — the drain contract ("every
    # accepted request scores and gets its response written") is
    # instead enforced by ServeTier's in-flight handler counter:
    # close() waits (bounded) for _inflight to hit zero BEFORE closing
    # the fleet, covering handlers still parsing a body (not yet
    # submitted) and handlers still writing a response
    daemon_threads = True
    tier: "ServeTier"

    def service_actions(self) -> None:
        # accept-loop heartbeat (every serve_forever poll): the
        # watchdog's `http` channel — silence here means the front
        # door is wedged, regardless of how the scoring path feels
        tier = self.tier
        try:
            # chaos site: a transient accept-loop/socket-layer error.
            # The loop SURVIVES it (the chaos row is already logged by
            # the registry; handler sockets are untouched) — an accept
            # loop that dies on one bad poll is a total outage, which
            # is exactly what the watchdog's serve_accept_stall exists
            # to catch if this discipline ever regresses.
            failpoint("serve.accept")
        except ChaosError:
            tier.accept_faults += 1
        if tier.flight is not None:
            tier.flight.note_http("accept")
        # auto rollouts advance here so they progress with no admin
        # client polling.  Known tradeoff: an auto-COMMIT clones the
        # candidate per replica on this thread, pausing accepts (new
        # connections queue in the listen backlog) for the clone time
        # — once per rollout; fleets where that outlasts the watchdog
        # http threshold should commit via POST /v1/rollout/commit
        # (handler thread) instead of auto_commit.
        try:
            for fleet in tier.fleets():
                fleet.rollout_tick()
        except Exception as e:
            # a failing transition (clone OOM, logger I/O) must not
            # unwind serve_forever and turn a rollout problem into a
            # total serving outage — the rollout stays open, so the
            # canary-stuck doctor diagnosis surfaces it
            import warnings

            warnings.warn(
                f"rollout_tick failed (rollout left open): {e!r}",
                RuntimeWarning,
                stacklevel=2,
            )


class _Handler(BaseHTTPRequestHandler):
    server_version = "xflow-serve/1"
    protocol_version = "HTTP/1.1"

    # -- plumbing -----------------------------------------------------------

    def setup(self) -> None:
        # BaseHTTPRequestHandler's `timeout` class attribute is None,
        # so a client that stalls mid-request (half-open TCP, paused
        # upload) would pin this handler thread indefinitely; a timed-
        # out read surfaces as ConnectionError/OSError in _do_post's
        # client-went-away handling
        self.timeout = self.server.tier.socket_timeout_s  # type: ignore[attr-defined]
        super().setup()

    def log_message(self, fmt: str, *args: Any) -> None:
        pass  # metrics rows, not stderr chatter

    @property
    def tier(self) -> "ServeTier":
        return self.server.tier  # type: ignore[attr-defined]

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length) if length else b""

    def _respond(self, code: int, payload: bytes, ctype: str,
                 headers: dict[str, str] | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def _json(self, code: int, doc: dict,
              headers: dict[str, str] | None = None) -> None:
        self._respond(
            code,
            json.dumps(doc, sort_keys=True).encode(),
            "application/json",
            headers,
        )

    def _shed(self, e: ShedError) -> None:
        retry_ms = max(
            1, int(self.tier.fleet.policy.deadline_budget_s * 1000)
        )
        doc = {
            "error": "backpressure",
            "cause": e.cause,
            "depth": e.depth,
            "queue_age_ms": round(e.queue_age_s * 1000.0, 3),
            "retry_after_ms": retry_ms,
        }
        if e.qos is not None:
            doc["qos"] = e.qos
        self._json(
            429, doc,
            headers={"Retry-After": str(max(1, retry_ms // 1000))},
        )

    # -- scoring ------------------------------------------------------------

    def _trace_ctx(self, fleet, wire=None) -> TraceContext | None:
        """The request's TraceContext at the front door: a packed-wire
        triple beats the ``X-XFlow-Trace`` header beats minting fresh
        (only when the target fleet traces at all — no sink, no ids).
        A malformed header is treated as absent, never a 400: a bad
        trace annotation must not fail the request it rides."""
        if wire is not None:
            return wire
        ctx = parse_header(self.headers.get("X-XFlow-Trace"))
        if ctx is not None:
            return ctx
        sink = getattr(fleet, "reqtrace", None)
        return sink.mint() if sink is not None else None

    def _trace_headers(self, ctx) -> dict[str, str] | None:
        """Echo the trace id on the response so clients correlate."""
        return None if ctx is None else {
            "X-XFlow-Trace": format_header(ctx)
        }

    def _qos(self) -> str | None:
        """The request's QoS admission class from the ``X-XFlow-QoS``
        header (the HTTP twin of the XFB1 frame's QoS byte); None =
        the fleet default.  Unlike a malformed trace header, an
        UNKNOWN class is a 400: the client asked for an admission
        contract the fleet does not have, and silently downgrading it
        would defeat the whole point of classed shedding."""
        raw = self.headers.get("X-XFlow-QoS")
        if raw is None:
            return None
        qos = raw.strip().lower()
        if qos not in QOS_CLASSES:
            raise ValueError(
                f"unknown QoS class {qos!r} (want one of {QOS_CLASSES})"
            )
        return qos

    def _score_rows(self, rows: list[tuple], trace=None,
                    qos: str | None = None) -> np.ndarray:
        """All-or-nothing admission: the first shed fails the whole
        request (already-admitted rows still score and resolve — the
        batcher drains them — but the client is told to back off).
        Every row of one HTTP request rides ONE trace id (each gets
        its own span)."""
        fleet = self.tier.fleet
        futs = [fleet.submit(*row, trace=trace, qos=qos) for row in rows]
        deadline = time.perf_counter() + self.tier.score_timeout_s
        return np.asarray([
            f.result(timeout=max(0.001, deadline - time.perf_counter()))
            for f in futs
        ], dtype=np.float32)

    def _handle_score_json(self, body: bytes) -> None:
        doc = json.loads(body.decode())
        if not isinstance(doc, dict):
            raise ValueError(
                "request body must be a JSON object "
                '({"rows": [...]} or one row {"keys": [...]})'
            )
        raw = doc["rows"] if "rows" in doc else [doc]
        if not isinstance(raw, list):
            raise ValueError('"rows" must be a list of row objects')
        rows = []
        for r in raw:
            if not isinstance(r, dict):
                raise ValueError('each row must be an object with "keys"')
            try:
                keys = np.asarray(r["keys"], dtype=np.int64)
                slots = (
                    np.asarray(r["slots"], dtype=np.int32)
                    if r.get("slots") is not None else None
                )
                vals = (
                    np.asarray(r["vals"], dtype=np.float32)
                    if r.get("vals") is not None else None
                )
            except TypeError as e:
                # np.asarray raises TypeError on ragged/object fields
                # — a client problem, not a server fault (400 not 500)
                raise ValueError(f"bad row field: {e}") from None
            rows.append((keys, slots, vals))
        ctx = self._trace_ctx(self.tier.fleet)
        pctr = self._score_rows(rows, trace=ctx, qos=self._qos())
        self._json(200, {
            "pctr": [round(float(p), 6) for p in pctr],
            "digest": self.tier.fleet.digest,
        }, headers=self._trace_headers(ctx))

    def _handle_score_packed(self, body: bytes) -> None:
        rows, wire_ctx = decode_packed_request_traced(body)
        ctx = self._trace_ctx(self.tier.fleet, wire=wire_ctx)
        pctr = self._score_rows(rows, trace=ctx, qos=self._qos())
        self._respond(
            200, encode_packed_response(pctr), "application/octet-stream",
            headers=self._trace_headers(ctx),
        )

    # -- HTTP verbs ---------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler protocol)
        self.tier._handler_enter()
        try:
            self._do_get()
        finally:
            self.tier._handler_exit()

    def _do_get(self) -> None:
        try:
            if self.path == "/healthz":
                fleet = self.tier.fleet
                doc = {
                    "status": "serving",
                    "digest": fleet.digest,
                    "model": fleet.cfg.model,
                    "replicas": fleet.replicas,
                    "depth": fleet.depth(),
                    "rollout": fleet.rollout_state(),
                }
                casc = self.tier.cascade
                if casc is not None:
                    doc["cascade"] = {
                        "retrieval_digest": casc.retrieval.digest,
                        "ranking_digest": casc.ranking.digest,
                        "k": casc.k,
                    }
                self._json(200, doc)
            elif self.path == "/v1/stats":
                doc = self.tier.fleet.stats()
                if self.tier.cascade is not None:
                    doc["cascade"] = self.tier.cascade.stats()
                if self.tier.watchdog is not None:
                    doc["watchdog"] = self.tier.watchdog.state()
                if self.tier.alerts is not None:
                    doc["alerts"] = self.tier.alerts.summary()
                self._json(200, doc)
            elif self.path == "/metrics":
                # Prometheus text exposition rendered from a lock-safe
                # registry snapshot (obs/export.py) — non-destructive,
                # so scraping never perturbs the stats-window counters
                from xflow_tpu_torch.obs.export import render_exposition

                text = render_exposition(
                    self.tier.fleet.registry.snapshot(reset=False)
                )
                self._respond(
                    200,
                    text.encode(),
                    ctype="text/plain; version=0.0.4; charset=utf-8",
                )
            else:
                self._json(404, {"error": f"no such path {self.path}"})
        except ConnectionError:
            pass  # client went away mid-read/write; nothing to answer
        except Exception as e:  # handler threads must answer, not die
            try:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
            except ConnectionError:
                pass  # the failure WAS the dead socket

    def do_POST(self) -> None:  # noqa: N802
        self.tier._handler_enter()
        try:
            self._do_post()
        finally:
            self.tier._handler_exit()

    def _rollout_fleet(self, doc: dict):
        """The fleet a rollout request targets: ``stage`` routes to a
        cascade stage ("retrieval"/"ranking"); default is the tier's
        primary fleet — either stage rolls out INDEPENDENTLY through
        its own canary gate."""
        stage = doc.get("stage")
        if stage is None:
            return self.tier.fleet
        casc = self.tier.cascade
        if casc is None:
            raise ValueError(
                f"stage {stage!r} given but this tier serves no "
                "cascade"
            )
        if stage == "retrieval":
            return casc.retrieval
        if stage == "ranking":
            return casc.ranking
        raise ValueError(
            f"unknown stage {stage!r} (want 'retrieval' or 'ranking')"
        )

    @staticmethod
    def _request_k(doc) -> int | None:
        """Validated optional per-request k (400 on garbage — a
        non-numeric k must not surface as a 500 TypeError)."""
        k = doc.get("k") if isinstance(doc, dict) else None
        if k is None:
            return None
        try:
            k = int(k)
        except (TypeError, ValueError):
            raise ValueError(f"bad k: {k!r}") from None
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        return k

    @staticmethod
    def _request_rows(doc) -> list[tuple]:
        """Validated rows from a JSON body — the _handle_score_json
        client-garbage contract (400, never 500, on malformed input),
        shared by the topk/recommend endpoints."""
        if not isinstance(doc, dict):
            raise ValueError(
                "request body must be a JSON object "
                '({"rows": [...]} or one row {"keys": [...]})'
            )
        raw = doc["rows"] if "rows" in doc else [doc]
        if not isinstance(raw, list):
            raise ValueError('"rows" must be a list of row objects')
        rows = []
        for r in raw:
            if not isinstance(r, dict):
                raise ValueError('each row must be an object with "keys"')
            try:
                rows.append((
                    np.asarray(r["keys"], dtype=np.int64),
                    np.asarray(r["slots"], dtype=np.int32)
                    if r.get("slots") is not None else None,
                    np.asarray(r["vals"], dtype=np.float32)
                    if r.get("vals") is not None else None,
                ))
            except TypeError as e:
                # np.asarray raises TypeError on ragged/object fields
                # — a client problem, not a server fault (400 not 500)
                raise ValueError(f"bad row field: {e}") from None
        return rows

    def _handle_topk(self, body: bytes) -> None:
        """Top-k retrieval over the tier's topk fleet: rows of
        USER-side features -> per-row candidate ids + dot scores."""
        fleet = self.tier.topk_fleet()
        doc = json.loads(body.decode())
        rows = self._request_rows(doc)
        k = self._request_k(doc)
        ctx = self._trace_ctx(fleet)
        futs = [fleet.submit(*row, trace=ctx) for row in rows]
        deadline = time.perf_counter() + self.tier.score_timeout_s
        items, scores = [], []
        for f in futs:
            ids, sc, _ = f.result(  # 3rd: the producing index (cascade's)
                timeout=max(0.001, deadline - time.perf_counter())
            )
            if k is not None:
                ids, sc = ids[:k], sc[:k]
            items.append([int(i) for i in ids])
            scores.append([round(float(s), 6) for s in sc])
        self._json(200, {
            "items": items,
            "scores": scores,
            "digest": fleet.digest,
        }, headers=self._trace_headers(ctx))

    def _handle_recommend(self, body: bytes) -> None:
        """The cascade front door: USER features -> retrieval top-k ->
        ranked candidates (serve/cascade.py)."""
        casc = self.tier.cascade
        if casc is None:
            raise ValueError("this tier serves no cascade")
        doc = json.loads(body.decode())
        rows = self._request_rows(doc)
        if len(rows) != 1:
            raise ValueError(
                f"recommend takes exactly one row, got {len(rows)}"
            )
        ctx = self._trace_ctx(casc.retrieval)
        result = casc.recommend(
            *rows[0], k=self._request_k(doc), trace=ctx
        )
        self._json(200, result, headers=self._trace_headers(ctx))

    def _do_post(self) -> None:
        try:
            body = self._body()
            if self.path == "/v1/score":
                self._handle_score_json(body)
            elif self.path == "/v1/score_packed":
                self._handle_score_packed(body)
            elif self.path == "/v1/topk":
                self._handle_topk(body)
            elif self.path == "/v1/recommend":
                self._handle_recommend(body)
            elif self.path == "/v1/rollout":
                doc = json.loads(body.decode()) if body else {}
                state = self._rollout_fleet(doc).begin_rollout(
                    doc["artifact"],
                    canary_frac=float(doc.get(
                        "canary_frac", self.tier.default_canary_frac
                    )),
                    min_canary_requests=int(
                        doc.get("min_canary_requests", 32)
                    ),
                    max_error_frac=float(doc.get("max_error_frac", 0.0)),
                    max_p99_ms=doc.get("max_p99_ms"),
                    auto_commit=bool(doc.get("auto_commit", False)),
                    force=bool(doc.get("force", False)),
                )
                self._json(200, {"rollout": state})
            elif self.path == "/v1/rollout/commit":
                doc = json.loads(body.decode()) if body else {}
                health = self._rollout_fleet(doc).commit_rollout(
                    force=bool(doc.get("force", False))
                )
                self._json(200, {"committed": health})
            elif self.path == "/v1/rollout/abort":
                doc = json.loads(body.decode()) if body else {}
                health = self._rollout_fleet(doc).abort_rollout(
                    detail="api"
                )
                self._json(200, {"aborted": health})
            else:
                self._json(404, {"error": f"no such path {self.path}"})
        except ShedError as e:
            self._shed(e)
        except RolloutError as e:
            self._json(409, {"error": str(e)})
        except (TimeoutError, FutureTimeout) as e:
            # admitted but the scoring future outlived the tier's
            # score_timeout_s: a gateway timeout, not a server bug
            self._json(504, {"error": f"scoring timed out: {e}"})
        except (ValueError, KeyError, json.JSONDecodeError,
                struct.error) as e:
            # struct.error: truncated/garbage packed wire is a client
            # problem, same as unparseable JSON
            self._json(400, {"error": f"{type(e).__name__}: {e}"})
        except ConnectionError:
            pass  # client went away mid-read/write; nothing to answer
        except Exception as e:
            try:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
            except ConnectionError:
                pass  # the failure WAS the dead socket


class ServeTier:
    """The running server: fleet + accept loop + drain discipline."""

    def __init__(
        self,
        fleet: ReplicaFleet,
        host: str = "127.0.0.1",
        port: int = 0,
        flight=None,
        poll_s: float = 0.25,
        drain_timeout_s: float = 30.0,
        default_canary_frac: float = 0.1,
        cascade=None,
        score_timeout_s: float = SCORE_TIMEOUT_S,
        socket_timeout_s: float = SOCKET_TIMEOUT_S,
    ):
        self.fleet = fleet
        # timeout discipline (XF017): every handler wait is bounded —
        # scoring futures by score_timeout_s (504 past it), socket
        # reads/writes by socket_timeout_s (_Handler.setup).  The serve
        # CLI wires these from Config.serve_{score,socket}_timeout_s.
        if score_timeout_s <= 0 or socket_timeout_s <= 0:
            raise ValueError(
                "score_timeout_s and socket_timeout_s must be > 0"
            )
        self.score_timeout_s = score_timeout_s
        self.socket_timeout_s = socket_timeout_s
        # retrieval→ranking cascade (serve/cascade.py): when set, the
        # tier additionally serves /v1/topk (the cascade's retrieval
        # fleet) and /v1/recommend, and rollout endpoints accept a
        # ``stage`` selector.  ``fleet`` stays the primary point-score
        # surface — conventionally the cascade's ranking fleet, so
        # /v1/score traffic and cascade traffic share replicas the
        # way mixed production traffic would.
        self.cascade = cascade
        self.flight = flight
        # optional live-telemetry attachments (serve CLI wires these):
        # a Watchdog whose .state() and an AlertEvaluator whose
        # .summary() enrich GET /v1/stats — set once before start(),
        # read-only from handler threads thereafter
        self.watchdog = None
        self.alerts = None
        self.default_canary_frac = default_canary_frac
        # survived serve.accept failpoint fires (written only from the
        # accept loop, read by tests/the chaos gate after close)
        self.accept_faults = 0
        self._poll_s = poll_s
        self._drain_timeout_s = drain_timeout_s
        self._httpd = _TierServer((host, port), _Handler)
        self._httpd.tier = self
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._closed = False
        self._final_rows: dict = {}
        # live handler-thread count (daemon handlers are NOT joined by
        # server_close — see _TierServer); close() drains on this
        self._inflight = 0

    def fleets(self) -> list:
        """Every fleet this tier fronts (primary + cascade stages,
        deduped by identity) — the accept loop ticks each one's auto
        rollout."""
        out = [self.fleet]
        if self.cascade is not None:
            for f in (self.cascade.retrieval, self.cascade.ranking):
                if all(f is not g for g in out):
                    out.append(f)
        return out

    def topk_fleet(self) -> ReplicaFleet:
        """The fleet behind /v1/topk: the cascade's retrieval stage,
        or the primary fleet when it is itself a topk fleet."""
        if self.cascade is not None:
            return self.cascade.retrieval
        if getattr(self.fleet, "topk", False):
            return self.fleet
        raise ValueError(
            "this tier serves no top-k fleet (load a retrieval "
            "artifact with ReplicaFleet(..., topk=True) or front a "
            "cascade)"
        )

    def _handler_enter(self) -> None:
        with self._lock:
            self._inflight += 1

    def _handler_exit(self) -> None:
        with self._lock:
            self._inflight -= 1

    def inflight(self) -> int:
        """Handler threads currently between accept and response-
        written — the drain barrier's second condition (a handler may
        hold an accepted request it has not yet submitted, which
        ``fleet.pending()`` cannot see)."""
        with self._lock:
            return self._inflight

    @property
    def running(self) -> bool:
        """The accept loop should be beating: started and not closed —
        the watchdog's pending probe for the ``http`` channel
        (``wd.set_pending("http", lambda: tier.running)``): silence
        while True is a serve_accept_stall, silence after close() is
        just a stopped server."""
        with self._lock:
            return self._thread is not None and not self._closed

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ServeTier":
        with self._lock:
            if self._closed:
                raise RuntimeError("ServeTier is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._serve,
                    name="xflow-serve-accept",
                    daemon=True,
                )
                self._thread.start()
        return self

    def _serve(self) -> None:
        self._httpd.serve_forever(poll_interval=self._poll_s)

    def close(self) -> dict:
        """Graceful drain: stop accepting, join the accept loop, wait
        for in-flight handlers to push their work into the replica
        queues, then close the fleet (drains every accepted request)
        and return the final stats rows.  Idempotent."""
        with self._lock:
            first = not self._closed
            self._closed = True
            thread = self._thread
            self._thread = None
        if not first:
            return self._final_rows
        if thread is not None:
            # shutdown() blocks on serve_forever's is-shut-down event;
            # on a never-started tier that event never sets, so only
            # a live accept loop gets the shutdown handshake
            self._httpd.shutdown()
            thread.join(timeout=10.0)
            if thread.is_alive():  # pragma: no cover - wedged socket
                import warnings

                warnings.warn(
                    "serve accept loop outlived shutdown join",
                    RuntimeWarning,
                    stacklevel=2,
                )
        self._httpd.server_close()
        # drain window: every live handler finishes (parse → submit →
        # result → response WRITTEN) and every replica queue empties;
        # only then may the fleet close — an accepted request must
        # never see "ReplicaFleet is closed"
        deadline = time.perf_counter() + self._drain_timeout_s
        while (
            (self.inflight() > 0 or self.fleet.pending())
            and time.perf_counter() < deadline
        ):
            time.sleep(0.01)
        if self.cascade is not None:
            # cascade drains retrieval→ranking in order (its in-flight
            # fan-outs must land before the ranking queues close);
            # fleet.close() below is then idempotent if the primary
            # fleet IS a cascade stage
            self.cascade.close()
        final = self.fleet.close()
        with self._lock:
            self._final_rows = final
        return final

    def __enter__(self) -> "ServeTier":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.close()
