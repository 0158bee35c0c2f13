"""Structured metrics logging (a copy of the reference's
utils/logging.py).

Every epoch and eval emits a JSON line with a timestamp so runs are
machine-comparable; stdout keeps the human-readable reference-style
lines.  The file opens in APPEND mode, so every open stamps a
``run_start`` header row (run id, config digest, rank, host count).
The record schema is the reference's obs/schema.py, so its
``obs summarize`` and ``obs doctor`` read the port's runs.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, IO


class MetricsLogger:
    """Thread-safe: one lock serializes the closed-check + write so
    lines never interleave and a log racing close() can't hit a closed
    file."""

    def __init__(self, path: str, run_header: dict[str, Any] | None = None):
        self._lock = threading.Lock()
        self._f: IO[str] = open(path, "a", buffering=1)
        self._t0 = time.time()
        self.closed = False
        if run_header is not None:
            import os
            import socket

            header = {
                "time_unix": round(self._t0, 3),
                "hostname": socket.gethostname(),
                "pid": os.getpid(),
            }
            header.update(run_header)
            self.log("run_start", header)

    def log(self, kind: str, record: dict[str, Any]) -> None:
        row = {"t": round(time.time() - self._t0, 3), "kind": kind}
        row.update(record)
        line = json.dumps(row, sort_keys=True) + "\n"
        with self._lock:
            if self.closed:  # late log after an exception close
                return
            self._f.write(line)

    def close(self) -> None:
        with self._lock:
            if not self.closed:
                self.closed = True
                self._f.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
