"""Observability: the metrics registry and the ``Obs`` facade the
trainer threads through its hot path (a cut of the reference's
obs/__init__.py).

``Obs.phase(name)`` times a block and books it as a ``phase.<name>``
counter (wall-second accounting: ``input_stall``, ``h2d``,
``dispatch``, ``device_block``, ``parse``, ``pack``, ``pred_write``,
``metrics_compute``); ``counter`` and ``observe`` feed the registry;
``span`` is a no-op until the span tracer is ported.  The tracer,
flight recorder, watchdog and exporters come with ROADMAP A14.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

from xflow_tpu_torch.obs.registry import MetricsRegistry, Snapshot

__all__ = ["Obs", "MetricsRegistry", "Snapshot", "emit_health", "health_row"]

_NULL_SPAN = contextlib.nullcontext()


class _Phase:
    """Times a block and books it as a ``phase.<name>`` counter."""

    __slots__ = ("_registry", "_name", "_t0")

    def __init__(self, registry: MetricsRegistry, name: str):
        self._registry = registry
        self._name = name

    def __enter__(self) -> "_Phase":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._registry.counter_add(
            "phase." + self._name, time.perf_counter() - self._t0
        )


class Obs:
    """One registry shared by everything in a run.  ``metrics_logger``
    is the ``health``-row sink (the loader's quarantine reports through
    it when the run has a metrics stream); ``flight`` is always None
    here (the flight recorder is ROADMAP A14)."""

    __slots__ = ("registry", "metrics_logger")
    enabled = True
    flight = None

    def __init__(self, registry: MetricsRegistry | None = None,
                 metrics_logger=None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.metrics_logger = metrics_logger

    def phase(self, name: str) -> _Phase:
        return _Phase(self.registry, name)

    def span(self, name: str, tags: dict | None = None):
        return _NULL_SPAN

    def counter(self, name: str, v: float = 1.0) -> None:
        self.registry.counter_add(name, v)

    def observe(self, name: str, v: float) -> None:
        self.registry.observe(name, v)


def health_row(
    cause: str,
    channel: str,
    silence_seconds: float,
    threshold_seconds: float,
    detail: str,
    channels: dict | None = None,
) -> dict:
    """A schema-complete ``health`` record body (the reference's
    obs/schema.py::health_row)."""
    return {
        "cause": cause,
        "channel": channel,
        "silence_seconds": round(silence_seconds, 3),
        "threshold_seconds": round(threshold_seconds, 3),
        "detail": detail,
        "channels": channels if channels is not None else {},
    }


def emit_health(
    obs,
    cause: str,
    channel: str,
    detail: str,
    silence_seconds: float = 0.0,
    threshold_seconds: float = 0.0,
) -> None:
    """A ``health`` row through ``obs.metrics_logger`` when the run has
    a metrics stream; skipped otherwise (the healing never depends on
    observability being on)."""
    logger = getattr(obs, "metrics_logger", None)
    if logger is not None:
        logger.log("health", health_row(
            cause, channel, silence_seconds, threshold_seconds, detail,
        ))
