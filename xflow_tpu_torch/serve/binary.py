"""Persistent binary serve transport — the XFB1 pipelined framing
over the ReplicaFleet.

The HTTP/1.1 tier (serve/server.py) pays per-request framing tax:
request line + headers in, status line + headers out, one
request/response in flight per connection.  The auction-scoring tiers
the reference is modeled on (PAPERS.md, arXiv:2501.10546) engineer
that away first — a persistent length-prefixed binary channel with
many requests in flight, matched by id.  This module is that channel:

**Frame layout** (little-endian throughout — analysis rule XF020):

* request  frame: ``b"XFB1"  u32 length  u64 request_id  u8 qos
  body``, where ``length`` counts everything after itself
  (``9 + len(body)``) and ``body`` is a complete XFS1/XFS2 packed
  scoring request (serve/server.py — the SAME body bytes that POST to
  ``/v1/score_packed``, so both transports share one fuzz-hardened
  row codec);
* response frame: ``b"XFB1"  u32 length  u64 request_id  u8 status
  body`` with status ``0`` ok (body = packed pctr response), ``1``
  shed (JSON — the typed-429 body of the HTTP tier), ``2`` timeout
  (JSON), ``3`` error (JSON).  Responses carry the request's id and
  may arrive in ANY order — the client matches, not the stream.

**QoS byte**: ``0`` bidding, ``1`` normal, ``2`` best_effort — the
admission class (serve/fleet.py QOS_CLASSES); anything else is a
typed decode refusal.  The HTTP twin is the ``X-XFlow-QoS`` header.

**Server** (:class:`BinaryTier`): one ``selectors``-based acceptor
thread owns every socket — accepts, reads, frame-parses, submits into
the fleet (admission control included), and writes responses.
Completion callbacks run on replica worker threads; they hand the
encoded response frame to the acceptor through a queue + socketpair
wake, so all socket I/O stays on one thread (no per-connection
threads, no handler-thread pool — the throughput multiplier is
exactly that the transport costs one thread).  Every wait is bounded
(XF017): the selector polls, sockets are non-blocking, and a deadline
sweep answers status-2 (timeout) for any request whose scoring future
outlives ``score_timeout_s`` — the 504 of this wire.  The loop beats
the flight recorder's ``http`` channel and survives the
``serve.binary_accept`` chaos failpoint exactly like the HTTP accept
loop (XF009/XF018).

``close()`` (XF006): stop flag + wake, bounded join of the acceptor,
then every socket closes.  The tier never closes the fleet — it may
share one with an HTTP ServeTier (the CLI runs both); whoever owns
the fleet drains it.

The client half (persistent per-stripe connections, pipelining depth
knob) is :class:`~xflow_tpu_torch.serve.loadgen.BinaryTarget`.
"""

from __future__ import annotations

import json
import queue
import selectors
import socket
import struct
import threading
import time
from typing import Any, Callable

from xflow_tpu_torch.chaos import ChaosError, failpoint
from xflow_tpu_torch.serve.fleet import QOS_CLASSES, ShedError
from xflow_tpu_torch.serve.server import (
    SCORE_TIMEOUT_S,
    SOCKET_TIMEOUT_S,
    decode_packed_request_traced,
    encode_packed_response,
)

FRAME_MAGIC = b"XFB1"
# frame length ceiling: a length-inflation frame must be refused
# before any allocation, not buffered toward OOM (the wirefuzz
# inflation mutator drives this)
MAX_FRAME_BYTES = 64 << 20
# u64 request_id + u8 qos/status
_HEAD = struct.Struct("<QB")
_LEN = struct.Struct("<I")

QOS_BYTE = {"bidding": 0, "normal": 1, "best_effort": 2}
QOS_NAME = {v: k for k, v in QOS_BYTE.items()}
assert set(QOS_BYTE) == set(QOS_CLASSES)

STATUS_OK = 0
STATUS_SHED = 1
STATUS_TIMEOUT = 2
STATUS_ERROR = 3


# -- frame codec --------------------------------------------------------------


def encode_frame(request_id: int, qos: str, body: bytes) -> bytes:
    """One request frame; ``body`` is a complete XFS1/XFS2 blob."""
    if qos not in QOS_BYTE:
        raise ValueError(
            f"unknown QoS class {qos!r} (want one of {QOS_CLASSES})"
        )
    if not 0 <= request_id < (1 << 64):
        raise ValueError(f"request_id {request_id} out of u64 range")
    return (
        FRAME_MAGIC
        + _LEN.pack(_HEAD.size + len(body))
        + _HEAD.pack(request_id, QOS_BYTE[qos])
        + body
    )


def encode_response_frame(
    request_id: int, status: int, body: bytes
) -> bytes:
    if status not in (
        STATUS_OK, STATUS_SHED, STATUS_TIMEOUT, STATUS_ERROR
    ):
        raise ValueError(f"bad response status {status}")
    return (
        FRAME_MAGIC
        + _LEN.pack(_HEAD.size + len(body))
        + _HEAD.pack(request_id, status)
        + body
    )


def _frame_at(buf: bytes, off: int) -> tuple[int, int, bytes, int] | None:
    """Parse one frame at ``off``: (request_id, tag_byte, body,
    next_off), or None when the buffer holds only an incomplete prefix
    of a frame (stream caller: wait for more bytes).  Malformed
    framing (bad magic, out-of-range length) is a typed refusal —
    a pipelined stream cannot resync past garbage."""
    avail = len(buf) - off
    if avail < 8:
        if avail and not FRAME_MAGIC.startswith(buf[off:off + 4]):
            raise ValueError(
                f"bad frame magic {bytes(buf[off:off + 4])!r} "
                f"(want {FRAME_MAGIC!r})"
            )
        return None
    if bytes(buf[off:off + 4]) != FRAME_MAGIC:
        raise ValueError(
            f"bad frame magic {bytes(buf[off:off + 4])!r} "
            f"(want {FRAME_MAGIC!r})"
        )
    (length,) = _LEN.unpack_from(buf, off + 4)
    if length < _HEAD.size or length > MAX_FRAME_BYTES:
        raise ValueError(
            f"frame length {length} outside "
            f"[{_HEAD.size}, {MAX_FRAME_BYTES}]"
        )
    if avail < 8 + length:
        return None
    rid, tag = _HEAD.unpack_from(buf, off + 8)
    body = bytes(buf[off + 8 + _HEAD.size:off + 8 + length])
    return rid, tag, body, off + 8 + length


def decode_frame(buf: bytes) -> tuple[int, str, bytes]:
    """Exactly ONE request frame: (request_id, qos class, body).
    Trailing bytes, truncation, or an unknown QoS byte are typed
    refusals."""
    got = _frame_at(buf, 0)
    if got is None:
        raise ValueError("truncated frame")
    rid, qos_b, body, end = got
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing byte(s) after frame")
    if qos_b not in QOS_NAME:
        raise ValueError(f"unknown QoS byte {qos_b}")
    return rid, QOS_NAME[qos_b], body

def decode_response_frame(buf: bytes) -> tuple[int, int, bytes]:
    """Exactly ONE response frame: (request_id, status, body)."""
    got = _frame_at(buf, 0)
    if got is None:
        raise ValueError("truncated frame")
    rid, status, body, end = got
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing byte(s) after frame")
    if status not in (
        STATUS_OK, STATUS_SHED, STATUS_TIMEOUT, STATUS_ERROR
    ):
        raise ValueError(f"unknown response status {status}")
    return rid, status, body


def decode_request_stream(buf: bytes) -> list[tuple]:
    """STRICT parse of a whole pipelined request stream: every frame
    complete and well-formed, every body a valid XFS1/XFS2 request.
    Returns ``[(request_id, qos, rows, trace), ...]``.  A truncated
    final frame is a refusal here (the fuzz contract); the live server
    uses the incremental ``_frame_at`` and waits instead."""
    out = []
    off = 0
    while off < len(buf):
        got = _frame_at(buf, off)
        if got is None:
            raise ValueError(
                f"truncated frame at offset {off} "
                f"({len(buf) - off} byte(s) left)"
            )
        rid, qos_b, body, off = got
        if qos_b not in QOS_NAME:
            raise ValueError(f"unknown QoS byte {qos_b}")
        rows, trace = decode_packed_request_traced(body)
        out.append((rid, QOS_NAME[qos_b], rows, trace))
    return out


def _json_body(doc: dict) -> bytes:
    return json.dumps(doc, sort_keys=True).encode()


# -- server -------------------------------------------------------------------


class _Request:
    """One in-flight frame's fan-in: N row futures resolve (on replica
    worker threads) into ONE response frame, exactly once — the
    deadline sweep and the last future race through ``finish``."""

    __slots__ = (
        "conn", "rid", "deadline", "results", "left", "lock", "done",
    )

    def __init__(self, conn: "_Conn", rid: int, nrows: int,
                 deadline: float):
        self.conn = conn
        self.rid = rid
        self.deadline = deadline
        self.results: list = [0.0] * nrows
        self.left = nrows
        self.lock = threading.Lock()
        self.done = False

    def finish(self, emit: Callable[["_Conn", bytes], None],
               status: int, body: bytes) -> bool:
        with self.lock:
            if self.done:
                return False
            self.done = True
        emit(self.conn, encode_response_frame(self.rid, status, body))
        return True


class _Conn:
    __slots__ = ("sock", "inbuf", "outbuf", "off", "pending", "last")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.off = 0  # parse offset into inbuf
        self.pending: dict[int, _Request] = {}
        self.last = time.perf_counter()


class BinaryTier:
    """The running binary front end: one selector thread over a
    listening socket + its persistent connections, feeding the fleet.
    """

    def __init__(
        self,
        fleet,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        flight=None,
        poll_s: float = 0.25,
        score_timeout_s: float = SCORE_TIMEOUT_S,
        socket_timeout_s: float = SOCKET_TIMEOUT_S,
        drain_timeout_s: float = 30.0,
    ):
        if score_timeout_s <= 0 or socket_timeout_s <= 0:
            raise ValueError(
                "score_timeout_s and socket_timeout_s must be > 0"
            )
        self.fleet = fleet
        self.flight = flight
        self.score_timeout_s = score_timeout_s
        # idle-connection reap bound — a client that stalls mid-frame
        # (half-open TCP) releases its buffers after this long instead
        # of holding them forever (the XF017 discipline of the HTTP
        # tier's per-socket timeout, selector-style)
        self.socket_timeout_s = socket_timeout_s
        self._poll_s = poll_s
        self._drain_timeout_s = drain_timeout_s
        self.accept_faults = 0  # survived serve.binary_accept fires
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(128)
        self._lsock.setblocking(False)
        # wake pipe: completion callbacks (replica worker threads) and
        # close() nudge the selector out of its poll
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._done_q: "queue.Queue[tuple[_Conn, bytes]]" = queue.Queue()
        self._sel = selectors.DefaultSelector()
        self._conns: set[_Conn] = set()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._closed = False

    @property
    def port(self) -> int:
        return self._lsock.getsockname()[1]

    @property
    def address(self) -> str:
        host, port = self._lsock.getsockname()[:2]
        return f"{host}:{port}"

    @property
    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and not self._closed

    def start(self) -> "BinaryTier":
        with self._lock:
            if self._closed:
                raise RuntimeError("BinaryTier is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._serve,
                    name="xflow-serve-binary",
                    daemon=True,
                )
                self._thread.start()
        return self

    # -- selector loop ------------------------------------------------------

    def _serve(self) -> None:
        self._sel.register(self._lsock, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        # heartbeat IS pulsed each iteration (flight.note_http below);
        # the select() poll bounds every pass (xf: ignore[XF009])
        while not self._stop.is_set():
            try:
                # chaos site (XF018): a transient accept-loop fault —
                # the loop SURVIVES it, exactly like the HTTP tier's
                # serve.accept discipline
                failpoint("serve.binary_accept")
            except ChaosError:
                self.accept_faults += 1
            if self.flight is not None:
                self.flight.note_http("binary_accept")
            for key, _ in self._sel.select(timeout=self._poll_s):
                if key.data == "accept":
                    self._accept()
                elif key.data == "wake":
                    self._drain_wake()
                else:
                    self._service(key.data, key.events)
            self._drain_done()
            self._sweep()
        # shutdown: selector unregistered, sockets closed; pending
        # requests' futures keep resolving into _done_q and are dropped
        self._sel.close()

    def _accept(self) -> None:
        try:
            sock, _ = self._lsock.accept()
        except (BlockingIOError, OSError):
            return
        sock.setblocking(False)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Conn(sock)
        with self._lock:
            self._conns.add(conn)
        self._sel.register(sock, selectors.EVENT_READ, conn)

    def _drain_wake(self) -> None:
        try:
            # bounded by the wake pipe's buffered bytes: the socket is
            # non-blocking, so an empty pipe exits via BlockingIOError
            # (xf: ignore[XF009])
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass  # closing; the loop is exiting anyway

    def _emit(self, conn: _Conn, frame: bytes) -> None:
        """Queue one response frame for ``conn`` — safe from ANY
        thread (replica workers, the sweep, the loop itself)."""
        self._done_q.put((conn, frame))
        self._wake()

    def _drain_done(self) -> None:
        # bounded by the queue's contents at entry: get_nowait exits
        # on Empty, never blocks (xf: ignore[XF009])
        while True:
            try:
                conn, frame = self._done_q.get_nowait()
            except queue.Empty:
                return
            with self._lock:
                live = conn in self._conns
            if not live:
                continue  # client went away; nothing to answer
            conn.outbuf += frame
            self._flush(conn)

    def _want_write(self, conn: _Conn, want: bool) -> None:
        events = selectors.EVENT_READ | (
            selectors.EVENT_WRITE if want else 0
        )
        try:
            self._sel.modify(conn.sock, events, conn)
        except (KeyError, ValueError, OSError):
            pass  # already unregistered (connection died)

    def _service(self, conn: _Conn, events: int) -> None:
        if events & selectors.EVENT_WRITE:
            self._flush(conn)
        if events & selectors.EVENT_READ:
            self._read(conn)

    def _flush(self, conn: _Conn) -> None:
        conn.last = time.perf_counter()
        try:
            # bounded by the buffered bytes: the socket is non-blocking,
            # so a full kernel buffer exits via BlockingIOError
            # (xf: ignore[XF009])
            while conn.outbuf:
                n = conn.sock.send(conn.outbuf)
                if n <= 0:
                    break
                del conn.outbuf[:n]
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._drop(conn)
            return
        self._want_write(conn, bool(conn.outbuf))

    def _read(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(conn)
            return
        if not data:
            self._drop(conn)
            return
        conn.last = time.perf_counter()
        conn.inbuf += data
        try:
            # bounded by the bytes just buffered: _frame_at returns
            # None (break) once only an incomplete frame remains
            # (xf: ignore[XF009])
            while True:
                got = _frame_at(conn.inbuf, conn.off)
                if got is None:
                    break
                rid, qos_b, body, conn.off = got
                self._handle(conn, rid, qos_b, body)
        except (ValueError, struct.error):
            # unframeable garbage: a pipelined stream cannot resync
            # past it — drop the connection (the client's typed signal
            # is the reset; intra-frame garbage with GOOD framing gets
            # a STATUS_ERROR response instead, in _handle)
            self._drop(conn)
            return
        if conn.off:
            del conn.inbuf[:conn.off]
            conn.off = 0

    def _handle(self, conn: _Conn, rid: int, qos_b: int,
                body: bytes) -> None:
        if qos_b not in QOS_NAME:
            self._emit(conn, encode_response_frame(
                rid, STATUS_ERROR,
                _json_body({"error": f"unknown QoS byte {qos_b}"}),
            ))
            return
        qos = QOS_NAME[qos_b]
        try:
            rows, trace = decode_packed_request_traced(body)
        except (ValueError, KeyError, struct.error) as e:
            # the HTTP tier's 400 taxonomy, framed
            self._emit(conn, encode_response_frame(
                rid, STATUS_ERROR,
                _json_body({"error": f"{type(e).__name__}: {e}"}),
            ))
            return
        req = _Request(
            conn, rid, len(rows),
            time.perf_counter() + self.score_timeout_s,
        )
        conn.pending[rid] = req
        try:
            for i, row in enumerate(rows):
                fut = self.fleet.submit(*row, trace=trace, qos=qos)
                fut.add_done_callback(
                    lambda f, req=req, i=i: self._row_done(req, f, i)
                )
        except ShedError as e:
            conn.pending.pop(rid, None)
            retry_ms = max(
                1, int(self.fleet.policy.deadline_budget_s * 1000)
            )
            req.finish(self._emit, STATUS_SHED, _json_body({
                "error": "backpressure",
                "cause": e.cause,
                "qos": qos,
                "depth": e.depth,
                "queue_age_ms": round(e.queue_age_s * 1000.0, 3),
                "retry_after_ms": retry_ms,
            }))
        except Exception as e:
            conn.pending.pop(rid, None)
            req.finish(self._emit, STATUS_ERROR, _json_body({
                "error": f"{type(e).__name__}: {e}",
            }))

    def _row_done(self, req: _Request, fut, i: int) -> None:
        """One row future resolved (replica worker thread).  The LAST
        row emits the response frame; an error resolves the whole
        frame immediately (remaining rows still score and are ignored
        — the all-or-nothing contract of the HTTP tier)."""
        err = fut.exception()
        if err is not None:
            req.finish(self._emit, STATUS_ERROR, _json_body({
                "error": f"{type(err).__name__}: {err}",
            }))
            return
        with req.lock:
            if req.done:
                return
            # a done-callback's future is resolved by definition —
            # this .result() can never block
            req.results[i] = float(fut.result())  # xf: ignore[XF017]
            req.left -= 1
            last = req.left == 0
        if last:
            req.finish(
                self._emit, STATUS_OK,
                encode_packed_response(req.results),
            )

    def _sweep(self) -> None:
        """Bound every in-flight request (XF017): a scoring future
        that outlives ``score_timeout_s`` answers STATUS_TIMEOUT now —
        the wire's 504.  Also reaps idle connections past the socket
        timeout."""
        now = time.perf_counter()
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            for rid in [
                r for r, q in conn.pending.items() if q.deadline <= now
            ]:
                req = conn.pending.pop(rid)
                req.finish(self._emit, STATUS_TIMEOUT, _json_body({
                    "error": "scoring timed out",
                    "timeout_s": self.score_timeout_s,
                }))
            if (
                now - conn.last > self.socket_timeout_s
                and not conn.pending
                and not conn.outbuf
            ):
                self._drop(conn)

    def _drop(self, conn: _Conn) -> None:
        with self._lock:
            self._conns.discard(conn)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        conn.pending.clear()

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Stop accepting, drain in-flight frames (bounded), join the
        acceptor (bounded — XF006), close every socket.  Never closes
        the fleet (it may be shared with an HTTP tier)."""
        with self._lock:
            first = not self._closed
            self._closed = True
            thread = self._thread
            self._thread = None
        if not first:
            return
        # drain window: frames already submitted resolve through the
        # loop before it stops (bounded)
        deadline = time.perf_counter() + self._drain_timeout_s
        while time.perf_counter() < deadline:
            with self._lock:
                busy = any(c.pending or c.outbuf for c in self._conns)
            if not busy:
                break
            time.sleep(0.01)
        self._stop.set()
        self._wake()
        if thread is not None:
            thread.join(timeout=10.0)
            if thread.is_alive():  # pragma: no cover - wedged socket
                import warnings

                warnings.warn(
                    "binary serve acceptor outlived its close() join",
                    RuntimeWarning,
                    stacklevel=2,
                )
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            try:
                conn.sock.close()
            except OSError:
                pass
        for s in (self._lsock, self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    def __enter__(self) -> "BinaryTier":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.close()
