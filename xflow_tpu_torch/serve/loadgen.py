"""Zipf-traffic load generator — offered-QPS open loop with SLO
accounting (`serve_bench` rows for scripts/check_serve_slo.py).

Closed-loop benchmarking (the ``bench`` CLI) measures latency at
whatever rate the system happens to sustain — it can never show load
shedding, because the clients slow down with the server.  Production
SLOs are stated the other way: *offered* traffic arrives on its own
clock and the tier either serves it inside the deadline or sheds it.
This generator models that:

* **Open loop.**  Arrivals are scheduled on a fixed global timeline
  (request *i* at ``i / offered_qps`` seconds); ``concurrency`` worker
  threads stripe the timeline and never wait for responses — each
  submit attaches a completion callback and moves to its next arrival.
  A slow tier therefore builds real queue depth and real sheds,
  exactly what admission control is for.
* **Zipf keys.**  Request keys are zipf(a)-ranked ids spread over the
  table by an odd multiplier (a bijection mod the power-of-two table
  size, so frequencies are preserved but hot keys aren't clustered) —
  the ads-traffic skew the whole input stack is built around.
* **SLO accounting.**  The summary carries offered vs achieved QPS,
  shed fraction per cause, error count, client-observed e2e p50/p99,
  and the fleet's per-bucket latency percentiles — everything
  ``check_serve_slo.py`` gates on, flushed as one ``serve_bench`` JSONL
  row (plus the fleet's ``serve_stats``/``serve_shed`` rows).

Targets: a :class:`~xflow_tpu_torch.serve.fleet.ReplicaFleet` directly
(in-process — the SLO gate's mode, and the only TRULY open-loop one:
``submit`` returns a Future immediately) or a running HTTP tier via
:class:`HttpTarget`.  **HTTP-mode caveat:** each worker scores
synchronously over its connection (429 → shed), so the offered rate
caps at ``concurrency / e2e_latency`` — size ``--concurrency`` at
least ``offered_qps × expected_e2e_s`` or the run degrades toward
closed-loop; the summary's ``offered_qps`` (requested) vs
``offered_qps_actual`` (what the timeline actually achieved) exposes
the gap, and ``check_serve_slo.py`` gates against the actual.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any

import numpy as np

from xflow_tpu_torch.obs.registry import Histogram
from xflow_tpu_torch.serve.fleet import ShedError

# spread multiplier: odd → bijective mod any power-of-two table size
_SPREAD = 0x9E3779B1


def zipf_rows(
    rng: np.random.Generator,
    n: int,
    *,
    table_size: int,
    nnz: int,
    zipf_a: float = 1.3,
    max_fields: int = 10,
) -> list[tuple]:
    """``n`` featurize_raw-protocol rows of zipf-skewed keys."""
    ranks = rng.zipf(zipf_a, size=(n, nnz)).astype(np.uint64)
    keys = ((ranks * _SPREAD) % table_size).astype(np.int64)
    slots = (np.arange(nnz, dtype=np.int32) % max(max_fields, 1))
    return [(keys[i], slots.copy(), None) for i in range(n)]


class HttpTarget:
    """Adapter giving an HTTP serving tier the fleet ``submit``
    protocol: synchronous single-row POST per call (the worker thread
    IS the connection), resolved-Future return, 429 → backoff-retry →
    ShedError.

    Each worker thread keeps ONE persistent HTTP/1.1 connection
    (thread-local, reconnect-once on a server-closed keep-alive
    socket): a per-request TCP handshake would inflate the client
    e2e percentiles that ``check_serve_slo.py`` gates on with a cost
    the tier never incurred.

    Typed 429s are honored, not just booked: the server's retry
    advice (the typed body's ``retry_after_ms``, falling back to the
    coarser ``Retry-After`` header) seeds a capped exponential backoff
    and the request is re-offered up to ``max_retries`` times before
    it counts as a shed — so chaos runs measure RECOVERY, not just
    rejection.  Retries are counted in ``self.retried`` and land in
    the ``serve_bench`` row."""

    transport = "http"

    def __init__(
        self,
        url: str,
        timeout_s: float = 30.0,
        max_retries: int = 2,
        backoff_cap_s: float = 1.0,
        qos: str | None = None,
    ):
        from urllib.parse import urlsplit

        # default QoS admission class for every request this target
        # offers (rides the X-XFlow-QoS header); per-submit qos=
        # overrides.  None = let the tier apply its fleet default.
        self.qos = qos
        self.url = url.rstrip("/")
        parts = urlsplit(self.url)
        if parts.scheme not in ("http", ""):
            raise ValueError(
                f"HttpTarget speaks plain http, got {parts.scheme!r}"
            )
        self._host = parts.hostname or "127.0.0.1"
        self._port = parts.port or 80
        self._path = parts.path.rstrip("/")
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.backoff_cap_s = backoff_cap_s
        self._local = threading.local()
        self._retry_lock = threading.Lock()
        self.retried = 0

    def _post(self, path: str, body: bytes,
              headers: dict | None = None) -> tuple[int, bytes, str]:
        """(status, payload, Retry-After header or "")."""
        import http.client

        hdrs = {"Content-Type": "application/octet-stream"}
        if headers:
            hdrs.update(headers)
        conn = getattr(self._local, "conn", None)
        reused = conn is not None
        for attempt in (0, 1):
            if conn is None:
                conn = http.client.HTTPConnection(
                    self._host, self._port, timeout=self.timeout_s
                )
                self._local.conn = conn
            try:
                conn.request(
                    "POST", self._path + path, body=body, headers=hdrs,
                )
                r = conn.getresponse()
                return (
                    r.status, r.read(), r.getheader("Retry-After") or ""
                )
            except ConnectionError:
                # the server may close an idle keep-alive socket
                # between arrivals (RemoteDisconnected subclasses
                # ConnectionResetError) — retry ONCE on a fresh
                # connection, and only when THIS socket had served
                # before.  Anything else (timeout after the request
                # was delivered, failure on a fresh connection) must
                # NOT be re-sent: the tier may have admitted the
                # request, and a duplicate both double-scores it and
                # double-loads a tier that is already struggling — it
                # surfaces as ONE failed request instead.
                conn.close()
                self._local.conn = conn = None
                if attempt or not reused:
                    raise
            except Exception:
                conn.close()
                self._local.conn = conn = None
                raise
        raise AssertionError("unreachable")

    def _retry_delay_s(self, retry_after: str, doc: dict,
                       attempt: int) -> float:
        """Backoff seed, most-precise source first: the typed body's
        ``retry_after_ms`` (our tier's millisecond advice), then the
        Retry-After header (HTTP-spec integer seconds — the tier
        floors it at 1s, so preferring it would park every retry a
        full second), then 50ms — doubled per attempt, capped."""
        base = 0.05
        if "retry_after_ms" in doc:
            base = max(float(doc["retry_after_ms"]) / 1000.0, 0.001)
        elif retry_after:
            try:
                base = max(float(retry_after), 0.001)
            except ValueError:
                pass  # HTTP-date form / garbage: keep the fallback
        return min(base * 2.0**attempt, self.backoff_cap_s)

    def submit(self, keys, slots=None, vals=None, trace=None,
               qos: str | None = None) -> Future:
        """``trace`` (a ``TraceContext``) rides the packed wire's XFS2
        traced variant so the tier's reqtrace spans correlate with
        this client's trace ids (obs/reqtrace.py).  ``qos`` overrides
        the target's default admission class for this request."""
        import json

        from xflow_tpu_torch.serve.server import (
            decode_packed_response,
            encode_packed_request,
        )

        qos = qos if qos is not None else self.qos
        headers = {"X-XFlow-QoS": qos} if qos is not None else None
        fut: Future = Future()
        body = encode_packed_request([(keys, slots, vals)], trace=trace)
        for attempt in range(self.max_retries + 1):
            try:
                status, payload, retry_after = self._post(
                    "/v1/score_packed", body, headers=headers
                )
            except Exception as e:  # connection errors → failed request
                fut.set_exception(e)
                return fut
            if status != 429:
                break
            try:
                doc = json.loads(payload.decode() or "{}")
            except ValueError:
                doc = {}  # a proxy's bare 429 is still a shed
            if attempt == self.max_retries:
                # retries exhausted: NOW it is a shed
                raise ShedError(
                    doc.get("cause", "unknown"),
                    int(doc.get("depth", 0)),
                    float(doc.get("queue_age_ms", 0.0)) / 1000.0,
                    "remote",
                    qos=doc.get("qos", qos),
                )
            with self._retry_lock:
                self.retried += 1
            time.sleep(self._retry_delay_s(retry_after, doc, attempt))
        if status != 200:
            fut.set_exception(RuntimeError(
                f"HTTP {status}: {payload[:200]!r}"
            ))
            return fut
        try:
            fut.set_result(float(decode_packed_response(payload)[0]))
        except Exception as e:
            fut.set_exception(e)
        return fut


class _BinConn:
    """One worker stripe's persistent XFB1 connection: a send side
    (the stripe's own thread), a reader thread resolving responses by
    request id, and a pipelining semaphore bounding frames in
    flight."""

    def __init__(self, sock, depth: int):
        self.sock = sock
        self.lock = threading.Lock()
        self.pending: dict[int, tuple[Future, str]] = {}
        # plain Semaphore, not Bounded: connection teardown releases
        # one permit per failed pending frame, racing normal releases
        self.sem = threading.Semaphore(depth)
        self.rid = 0
        self.buf = bytearray()
        self.off = 0
        self.reader: threading.Thread | None = None
        self.dead = False


class BinaryTarget:
    """The fleet ``submit`` protocol over the persistent XFB1 binary
    transport (serve/binary.py).  Unlike :class:`HttpTarget` — one
    synchronous request per worker connection — this target PIPELINES:
    each worker stripe keeps one persistent connection with up to
    ``pipeline_depth`` frames in flight, and ``submit`` returns its
    Future as soon as the frame is written (a per-connection reader
    thread matches responses by request id).  That makes binary runs
    truly open-loop like in-process fleet runs, at any latency.

    A shed response (status 1 — the wire's typed 429) resolves the
    Future with a :class:`ShedError`; the loadgen's recorder books it
    as a shed, not an error, so both transports produce comparable
    ``serve_bench`` rows.  No transparent retry on this path: a
    pipelined stream re-offering frames would reorder the open-loop
    timeline (``retried`` stays 0; the HTTP leg's backoff is its own
    transport's discipline)."""

    transport = "binary"

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        timeout_s: float = 30.0,
        pipeline_depth: int = 32,
        qos: str | None = None,
    ):
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self.pipeline_depth = pipeline_depth
        self.qos = qos
        self._local = threading.local()
        self._conns_lock = threading.Lock()
        self._conns: list[_BinConn] = []
        self._closed = False

    def _conn(self) -> _BinConn:
        import socket as _socket

        conn = getattr(self._local, "conn", None)
        if conn is not None and not conn.dead:
            return conn
        if self._closed:
            raise RuntimeError("BinaryTarget is closed")
        sock = _socket.create_connection(
            (self.host, self.port), timeout=self.timeout_s
        )
        sock.setsockopt(
            _socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1
        )
        conn = _BinConn(sock, self.pipeline_depth)
        # not fire-and-forget: tracked in self._conns and joined
        # (bounded) by close() (xf: ignore[XF006])
        conn.reader = threading.Thread(
            target=self._read_loop, args=(conn,),
            name="xflow-binary-reader", daemon=True,
        )
        conn.reader.start()
        with self._conns_lock:
            self._conns.append(conn)
        self._local.conn = conn
        return conn

    def _read_loop(self, conn: _BinConn) -> None:
        from xflow_tpu_torch.serve.binary import _frame_at

        try:
            # client-side reader, not a serving worker: bounded by the
            # socket timeout (recv raises) and exits on EOF/close —
            # the flight recorder lives server-side
            # (xf: ignore[XF009])
            while True:
                data = conn.sock.recv(1 << 16)
                if not data:
                    break
                conn.buf += data
                # bounded by the bytes just buffered (_frame_at breaks
                # on an incomplete frame) (xf: ignore[XF009])
                while True:
                    got = _frame_at(conn.buf, conn.off)
                    if got is None:
                        break
                    rid, status, body, conn.off = got
                    self._resolve(conn, rid, status, body)
                if conn.off:
                    del conn.buf[:conn.off]
                    conn.off = 0
        except (OSError, ValueError):
            pass  # teardown below fails whatever is still pending
        finally:
            self._teardown(
                conn, ConnectionError("binary connection closed")
            )

    def _resolve(self, conn: _BinConn, rid: int, status: int,
                 body: bytes) -> None:
        import json

        from xflow_tpu_torch.serve import binary
        from xflow_tpu_torch.serve.server import decode_packed_response

        with conn.lock:
            entry = conn.pending.pop(rid, None)
        if entry is None:
            return  # duplicate/unknown id: nothing is waiting
        conn.sem.release()
        fut, qos = entry
        try:
            if status == binary.STATUS_OK:
                fut.set_result(float(decode_packed_response(body)[0]))
                return
            doc = json.loads(body.decode() or "{}")
            if status == binary.STATUS_SHED:
                fut.set_exception(ShedError(
                    doc.get("cause", "unknown"),
                    int(doc.get("depth", 0)),
                    float(doc.get("queue_age_ms", 0.0)) / 1000.0,
                    "remote",
                    qos=doc.get("qos", qos),
                ))
            elif status == binary.STATUS_TIMEOUT:
                fut.set_exception(TimeoutError(
                    doc.get("error", "scoring timed out")
                ))
            else:
                fut.set_exception(RuntimeError(
                    doc.get("error", f"binary status {status}")
                ))
        except Exception as e:  # malformed body: still resolve
            if not fut.done():
                fut.set_exception(e)

    def _teardown(self, conn: _BinConn, err: Exception) -> None:
        with conn.lock:
            conn.dead = True
            pending = list(conn.pending.values())
            conn.pending.clear()
        for fut, _ in pending:
            conn.sem.release()
            if not fut.done():
                fut.set_exception(err)
        try:
            conn.sock.close()
        except OSError:
            pass

    def submit(self, keys, slots=None, vals=None, trace=None,
               qos: str | None = None) -> Future:
        from xflow_tpu_torch.serve.binary import encode_frame
        from xflow_tpu_torch.serve.server import encode_packed_request

        qos = qos if qos is not None else (self.qos or "normal")
        body = encode_packed_request([(keys, slots, vals)], trace=trace)
        conn = self._conn()
        # pipelining bound (XF017-bounded: the server's deadline sweep
        # answers every frame within its score timeout, so permits
        # always come back)
        if not conn.sem.acquire(timeout=self.timeout_s):
            raise TimeoutError(
                f"pipeline full for {self.timeout_s}s "
                f"(depth {self.pipeline_depth})"
            )
        fut: Future = Future()
        with conn.lock:
            if conn.dead:
                conn.sem.release()
                raise ConnectionError("binary connection closed")
            conn.rid += 1
            rid = conn.rid
            conn.pending[rid] = (fut, qos)
        try:
            conn.sock.sendall(encode_frame(rid, qos, body))
        except OSError:
            self._teardown(
                conn, ConnectionError("binary connection closed")
            )
            raise
        return fut

    def close(self) -> None:
        self._closed = True
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            try:
                conn.sock.shutdown(2)  # SHUT_RDWR: wake the reader
            except OSError:
                pass
            try:
                conn.sock.close()
            except OSError:
                pass
        for conn in conns:
            if conn.reader is not None:
                conn.reader.join(timeout=5.0)

    def __enter__(self) -> "BinaryTarget":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class _Recorder:
    """Thread-safe completion sink (callbacks run on replica worker
    threads; workers read nothing until the drain barrier)."""

    def __init__(self, slow_k: int = 3) -> None:
        self._lock = threading.Lock()
        self._lat = Histogram(capacity=65536)
        self.submitted = 0
        self.completed = 0
        self.errors = 0
        self.shed: dict[str, int] = {}
        self._shed_total = 0
        # per-QoS-class offered/shed counts (mixed-class runs)
        self.qos_offered: dict[str, int] = {}
        self.qos_shed: dict[str, int] = {}
        # client-observed slowest-k (e2e seconds, trace id hex) — the
        # serve_bench row names its slowest exemplars by trace id so a
        # p99 outlier maps straight onto its reqtrace span tree
        self._slow_k = slow_k
        self._slow: list[tuple[float, str]] = []

    def note_submit(self, qos: str | None = None) -> None:
        with self._lock:
            self.submitted += 1
            if qos is not None:
                self.qos_offered[qos] = self.qos_offered.get(qos, 0) + 1

    def note_shed(self, cause: str, qos: str | None = None) -> None:
        with self._lock:
            self.shed[cause] = self.shed.get(cause, 0) + 1
            self._shed_total += 1
            if qos is not None:
                self.qos_shed[qos] = self.qos_shed.get(qos, 0) + 1

    def note_error(self) -> None:
        """A request that failed AT submit (no Future ever existed) —
        books a completed-with-error so ``outstanding`` stays exact."""
        with self._lock:
            self.completed += 1
            self.errors += 1

    def note_done(
        self, fut: Future, t0: float, trace_id: str | None = None
    ) -> None:
        dt = time.perf_counter() - t0
        err = fut.exception()
        if isinstance(err, ShedError):
            # a shed delivered THROUGH the Future (the pipelined
            # binary transport's status-1 frame) is still a shed, not
            # an error — booked like a door-shed so both transports'
            # serve_bench rows compare like for like.  Not counted as
            # completed: `outstanding` subtracts sheds separately.
            self.note_shed(err.cause, qos=err.qos)
            return
        with self._lock:
            self.completed += 1
            if err is not None:
                self.errors += 1
            else:
                self._lat.observe(dt)
                if trace_id is not None:
                    self._slow.append((dt, trace_id))
                    self._slow.sort(reverse=True)
                    del self._slow[self._slow_k:]

    def slowest(self) -> list[tuple[float, str]]:
        with self._lock:
            return list(self._slow)

    def outstanding(self) -> int:
        """Offered requests still awaiting resolution.  Sheds resolved
        AT the door (no Future ever existed), so they must not count —
        the drain barrier would otherwise spin its full timeout on
        every run with a single shed."""
        with self._lock:
            return self.submitted - self.completed - self._shed_total

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "errors": self.errors,
                "shed": dict(self.shed),
                "qos_offered": dict(self.qos_offered),
                "qos_shed": dict(self.qos_shed),
                "e2e_p50": round(self._lat.percentile(50), 6),
                "e2e_p99": round(self._lat.percentile(99), 6),
            }


def run_loadgen(
    target,
    *,
    offered_qps: float,
    duration_s: float,
    concurrency: int = 8,
    nnz: int = 8,
    zipf_a: float = 1.3,
    table_size: int | None = None,
    seed: int = 0,
    drain_timeout_s: float = 30.0,
    metrics_logger=None,
    trace: bool | None = None,
    trace_sample: float = 0.01,
    qos_mix: dict[str, float] | None = None,
) -> dict:
    """Drive ``target`` (a ReplicaFleet or HttpTarget) with open-loop
    zipf traffic; returns (and optionally logs as ``serve_bench``) the
    SLO summary.  When the target is a fleet, its stats window is
    flushed into the summary (queue/featurize/device + per-bucket
    percentiles + shed rows).

    Tracing (obs/reqtrace.py): ``trace=None`` auto-enables when the
    target fleet has a ``reqtrace`` sink attached; ``trace=True``
    forces client-side minting (e.g. an HttpTarget against a traced
    tier — ids ride the XFS2 packed wire at ``trace_sample``).  With
    tracing on, every request carries a trace id and the summary's
    ``slowest_exemplars`` names the client-observed slowest-3 with
    their server-side phase breakdowns when available."""
    if offered_qps <= 0 or duration_s <= 0 or concurrency < 1:
        raise ValueError("offered_qps/duration_s/concurrency must be > 0")
    if zipf_a <= 1.0:
        raise ValueError("zipf_a must be > 1 (numpy zipf domain)")
    # mixed-class traffic: arrival i's class comes from a 100-slot
    # proportional pattern (deterministic — the same seed offers the
    # same class sequence over both transports of a two-leg run)
    qos_pattern: list[str] | None = None
    if qos_mix:
        from xflow_tpu_torch.serve.fleet import QOS_CLASSES

        bad = set(qos_mix) - set(QOS_CLASSES)
        if bad:
            raise ValueError(
                f"unknown QoS class(es) {sorted(bad)} in qos_mix "
                f"(want {QOS_CLASSES})"
            )
        total = sum(qos_mix.values())
        if total <= 0:
            raise ValueError("qos_mix fractions must sum > 0")
        # error-accumulator (Bresenham) spread: classes INTERLEAVE at
        # their fractions instead of arriving in per-class bursts —
        # the same striping discipline the fleet's canary router uses
        mix = {
            c: qos_mix[c] / total for c in QOS_CLASSES if c in qos_mix
        }
        acc = dict.fromkeys(mix, 0.0)
        qos_pattern = []
        for _ in range(100):
            for c in mix:
                acc[c] += mix[c]
            top = max(acc, key=lambda c: acc[c])
            acc[top] -= 1.0
            qos_pattern.append(top)
    sink = getattr(target, "reqtrace", None)
    if trace is None:
        trace = sink is not None
    mint = None
    if trace:
        if sink is None:
            # client-side minting against a remote tier: a local sink
            # used only for id/sampling-decision generation
            from xflow_tpu_torch.obs.reqtrace import ReqTraceSink

            sink_local = ReqTraceSink(sample=trace_sample)
            mint = sink_local.mint
        else:
            mint = sink.mint
    if table_size is None:
        cfg = getattr(target, "cfg", None)
        if cfg is None:
            # HttpTarget has no engine config to read the key space
            # from — a remote tier's table size isn't knowable here
            raise ValueError(
                "table_size is required for targets without a .cfg "
                "(e.g. HttpTarget): pass table_size=2**cfg_log2 "
                "matching the serving artifact"
            )
        table_size = int(cfg.table_size)
    count = max(1, int(offered_qps * duration_s))
    rec = _Recorder()
    # the open-loop clock starts AFTER every stripe has pre-generated
    # its rows (barrier action runs in the last arriving thread): a
    # start stamped before generation would put large runs behind
    # schedule from arrival 0 and turn the ramp into a burst that
    # inflates the very numbers check_serve_slo gates on
    start_cell = [0.0]

    def _stamp_start() -> None:
        start_cell[0] = time.perf_counter() + 0.05

    gen_barrier = threading.Barrier(concurrency + 1, action=_stamp_start)

    def worker(wid: int) -> None:
        # pre-generate this worker's rows so the hot loop is
        # sleep → submit, not RNG time
        idxs = range(wid, count, concurrency)
        rows = None
        try:
            rng = np.random.default_rng(seed + wid)
            rows = zipf_rows(
                rng, len(idxs),
                table_size=table_size, nnz=nnz, zipf_a=zipf_a,
            )
        except Exception:  # xf: ignore[XF015]
            # NOT a silent swallow: rows stays None and every arrival
            # of this stripe is booked as a failed request after the
            # barrier (the loud path lives below)
            pass
        try:
            gen_barrier.wait(timeout=60.0)
        except threading.BrokenBarrierError:
            rows = None  # no shared clock; this stripe cannot run
        if rows is None:
            # a stripe that cannot build its rows must not vanish: book
            # every one of its arrivals as a failed request, or the
            # summary reports a clean gate-passing run over traffic
            # that was never sent
            for _ in idxs:
                rec.note_submit()
                rec.note_error()
            return
        start = start_cell[0]
        for j, i in enumerate(idxs):
            delay = (start + i / offered_qps) - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            q = (
                qos_pattern[i % len(qos_pattern)]
                if qos_pattern is not None
                else None
            )
            rec.note_submit(qos=q)
            ctx = mint() if mint is not None else None
            tid = f"{ctx.trace_id:016x}" if ctx is not None else None
            kw: dict[str, Any] = {}
            if ctx is not None:
                kw["trace"] = ctx
            if q is not None:
                kw["qos"] = q
            t0 = time.perf_counter()
            try:
                fut = target.submit(*rows[j], **kw)
            except ShedError as e:
                rec.note_shed(e.cause, qos=getattr(e, "qos", None) or q)
                continue
            except Exception:
                # a submit-side failure is ONE failed request, not a
                # dead worker: the stripe must keep offering its
                # 1/concurrency share or the summary reports a clean
                # run over traffic that was never sent
                rec.note_error()
                continue
            fut.add_done_callback(
                lambda f, t0=t0, tid=tid: rec.note_done(f, t0, tid)
            )

    threads = [
        # daemon: the bounded join below already tolerates (and
        # reports) leaked workers — a non-daemon stripe wedged in a
        # socket timeout would hold interpreter shutdown hostage for
        # its whole remaining arrival schedule
        threading.Thread(
            target=worker, args=(w,), name=f"xflow-loadgen-{w}",
            daemon=True,
        )
        for w in range(concurrency)
    ]
    for t in threads:
        t.start()
    try:
        gen_barrier.wait(timeout=60.0)
    except threading.BrokenBarrierError:
        # a stripe died before generating (hard failure): workers see
        # the same break and book their arrivals as errors; fall back
        # to "now" so the deadlines below still bound the run
        start_cell[0] = time.perf_counter()
    start = start_cell[0]
    join_deadline = (
        start + duration_s + drain_timeout_s
    )
    for t in threads:
        t.join(timeout=max(0.1, join_deadline - time.perf_counter()))
    leaked = sum(t.is_alive() for t in threads)
    # open-loop drain: submissions stopped; wait (bounded) for the
    # tier to resolve what it admitted
    while rec.outstanding() > 0 and time.perf_counter() < join_deadline:
        time.sleep(0.01)
    seconds = time.perf_counter() - start
    snap = rec.snapshot()
    sheds = sum(snap["shed"].values())
    denom = snap["submitted"]
    summary: dict[str, Any] = {
        # serve_bench required fields
        "requests": snap["completed"] - snap["errors"],
        "concurrency": concurrency,
        "seconds": round(seconds, 6),
        "requests_per_sec": round(
            (snap["completed"] - snap["errors"]) / max(seconds, 1e-9), 1
        ),
        "e2e_p50": snap["e2e_p50"],
        "e2e_p99": snap["e2e_p99"],
        # SLO extras (schema-optional)
        "offered_qps": round(offered_qps, 1),
        "offered_qps_actual": round(denom / max(seconds, 1e-9), 1),
        "achieved_qps": round(
            (snap["completed"] - snap["errors"]) / max(seconds, 1e-9), 1
        ),
        "shed_frac": round(sheds / denom, 6) if denom else 0.0,
        "shed_by_cause": snap["shed"],
        "errors": snap["errors"] + leaked,
        "outstanding": rec.outstanding(),
        # 429s the target transparently retried (HttpTarget honoring
        # Retry-After; in-process fleets never retry — 0)
        "retried": int(getattr(target, "retried", 0)),
        # which wire carried the traffic ("fleet" = in-process): the
        # two-leg SLO gate (check_serve_slo.py --compare-transports)
        # picks its legs by this field
        "transport": getattr(target, "transport", "fleet"),
    }
    if qos_pattern is not None:
        summary["qos_offered"] = snap["qos_offered"]
        summary["qos_shed"] = snap["qos_shed"]
    if hasattr(target, "emit_stats"):
        rows = target.emit_stats()  # serve_stats + serve_shed flushed
        stats = rows["stats"]
        for f in (
            "queue_p50", "queue_p99", "featurize_p50", "featurize_p99",
            "device_p50", "device_p99",
        ):
            summary[f] = stats[f]
        summary["per_bucket"] = stats.get("per_bucket", {})
        summary["compiles"] = target.engines[0].compile_count
        if trace and sink is not None:
            # emit_stats just flushed the sink's window, so server-side
            # phase breakdowns for the client's slowest trace ids are
            # available via the last-flush exemplar view
            exemplars = []
            for dt, tid in rec.slowest():
                e: dict[str, Any] = {
                    "trace_id": tid, "e2e_ms": round(dt * 1e3, 3),
                }
                ph = sink.phases_of(tid)
                if ph is not None:
                    e["phases_ms"] = ph
                exemplars.append(e)
            summary["slowest_exemplars"] = exemplars
    else:
        for f in (
            "queue_p50", "queue_p99", "featurize_p50", "featurize_p99",
            "device_p50", "device_p99",
        ):
            summary[f] = 0.0
        summary["compiles"] = 0
        if trace:
            # remote tier: client e2e only — the server's phase
            # breakdowns live in ITS reqtrace stream under these ids
            summary["slowest_exemplars"] = [
                {"trace_id": tid, "e2e_ms": round(dt * 1e3, 3)}
                for dt, tid in rec.slowest()
            ]
    if metrics_logger is not None:
        metrics_logger.log("serve_bench", summary)
    return summary
