"""Live telemetry exposition (a cut of the reference's obs/export.py).

``render_exposition`` renders one registry snapshot as Prometheus text
exposition: counters and gauges map 1:1; histograms render as summaries
(p50/p90/p99 quantile lines + ``_count``/``_sum``/``_max``).  The
snapshot IS the lock-safety: ``MetricsRegistry.snapshot(reset=False)``
copies every structure under the registry lock, so a scrape never
observes a half-written histogram ring.  Served at ``GET /metrics`` on
ServeTier (serve/server.py).  ``parse_exposition`` is its inverse.  The
reference's resource sampler and standalone exporter come with ROADMAP
A14.
"""

from __future__ import annotations

from xflow_tpu_torch.obs.registry import Snapshot

# quantile label in the exposition -> key in Histogram.summary()
_QUANTILES = (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99"))

def metric_name(name: str, prefix: str = "xflow") -> str:
    """Registry name -> exposition name: ``serve.e2e.b8`` ->
    ``xflow_serve_e2e_b8`` ([a-zA-Z0-9_] only, prefixed)."""
    safe = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    if safe and safe[0].isdigit():
        safe = "_" + safe
    return f"{prefix}_{safe}" if prefix else safe


def _fmt(v: float) -> str:
    # repr keeps full float precision (round-trip exactness is what the
    # scrape-vs-snapshot parity gate checks); integers render bare
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def render_exposition(snap: Snapshot, prefix: str = "xflow") -> str:
    """One registry snapshot as Prometheus text exposition format.

    Rendered names sort deterministically; every histogram becomes a
    summary family: quantile lines over the percentile ring, ``_count``
    and ``_sum`` (= count * mean) over all time, ``_max`` as a
    companion gauge (not part of the summary spec, but the watermark is
    too diagnostic to drop)."""
    out: list[str] = []
    for name in sorted(snap.counters):
        m = metric_name(name, prefix)
        out.append(f"# TYPE {m} counter")
        out.append(f"{m} {_fmt(snap.counters[name])}")
    for name in sorted(snap.gauges):
        m = metric_name(name, prefix)
        out.append(f"# TYPE {m} gauge")
        out.append(f"{m} {_fmt(snap.gauges[name])}")
    for name in sorted(snap.hists):
        m = metric_name(name, prefix)
        h = snap.hists[name]
        out.append(f"# TYPE {m} summary")
        for label, key in _QUANTILES:
            out.append(f'{m}{{quantile="{label}"}} {_fmt(h[key])}')
        count = h.get("count", 0)
        out.append(f"{m}_count {_fmt(count)}")
        out.append(f"{m}_sum {_fmt(h.get('mean', 0.0) * count)}")
        out.append(f"# TYPE {m}_max gauge")
        out.append(f"{m}_max {_fmt(h.get('max', 0.0))}")
    return "\n".join(out) + "\n"


def parse_exposition(text: str) -> dict[str, dict]:
    """Inverse of ``render_exposition`` (tests + the check_live_obs
    gate): ``{"counter": {name: v}, "gauge": {...}, "summary":
    {name: {"0.5": v, "0.9": v, "0.99": v, "count": n, "sum": s,
    "max": m}}}`` keyed by EXPOSITION names."""
    types: dict[str, str] = {}
    out: dict[str, dict] = {"counter": {}, "gauge": {}, "summary": {}}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        name, value = line.rsplit(None, 1)
        v = float(value)
        if "{" in name:
            base, label = name.split("{", 1)
            q = label.split('"')[1]
            out["summary"].setdefault(base, {})[q] = v
        elif types.get(name) == "counter":
            out["counter"][name] = v
        elif types.get(name) == "gauge":
            base = name[: -len("_max")] if name.endswith("_max") else ""
            if types.get(base) == "summary":
                out["summary"].setdefault(base, {})["max"] = v
            else:
                out["gauge"][name] = v
        else:
            for suffix in ("_count", "_sum"):
                if name.endswith(suffix):
                    base = name[: -len(suffix)]
                    out["summary"].setdefault(base, {})[suffix[1:]] = v
                    break
    return out
