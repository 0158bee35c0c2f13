"""CLI: ``python -m xflow_tpu_torch.serve <score|bench> ARTIFACT``

    score   ARTIFACT --input FILE     pctr per libffm line (stdout/--out)
    bench   ARTIFACT [--requests N]   closed-loop concurrent load through
                                      one MicroBatcher; prints a JSON
                                      summary with queue/featurize/
                                      device/e2e p50+p99

Both run on the card (``--device cuda``, the default) unless
``--device cpu`` is given; with no card, the default refuses to start.
The HTTP and binary serving tiers, the fleet and the load generator
come with ROADMAP A7.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np


def _buckets(text: str | None) -> tuple[int, ...] | None:
    if not text:
        return None
    return tuple(int(b) for b in text.split(","))


def _percentile(vals: list[float], p: float) -> float:
    # one percentile definition for the package: obs.registry.Histogram
    from xflow_tpu_torch.obs.registry import Histogram

    h = Histogram(capacity=max(len(vals), 1))
    for v in vals:
        h.observe(v)
    return round(h.percentile(p), 6)


def cmd_score(args) -> int:
    from xflow_tpu_torch.serve.engine import PredictEngine

    engine = PredictEngine.load(
        args.artifact,
        device=args.device,
        buckets=_buckets(args.buckets),
        warm=not args.no_warm,
    )
    src = open(args.input) if args.input else sys.stdin
    try:
        lines = [l for l in src.read().splitlines() if l.strip()]
    finally:
        if args.input:
            src.close()
    pctr = engine.score_text(lines)
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        for p in pctr:
            out.write(f"{p:.6f}\n")
    finally:
        if args.out:
            out.close()
    return 0


def run_bench(
    engine, requests: int, concurrency: int, nnz: int, seed: int = 0,
    max_wait_ms: float = 2.0,
) -> dict:
    """Closed-loop load: ``concurrency`` client threads each submit
    their share of ``requests`` seed-made single-row requests (``nnz``
    random keys each) one at a time through one MicroBatcher.  Returns
    the summary row (seconds, requests/s, e2e/queue/featurize/device
    p50 and p99)."""
    from xflow_tpu_torch.serve.batcher import MicroBatcher

    cfg = engine.cfg
    batcher = MicroBatcher(engine, max_wait_ms=max_wait_ms)
    rng = np.random.default_rng(seed)
    nnz = min(nnz, cfg.max_nnz)
    rows = [
        (
            rng.integers(0, cfg.table_size, size=nnz).astype(np.int64),
            np.arange(nnz, dtype=np.int32) % max(cfg.max_fields, 1),
            None,
        )
        for _ in range(requests)
    ]
    e2e: list[float] = []
    e2e_lock = threading.Lock()

    def worker(my_rows) -> None:
        for row in my_rows:
            t0 = time.perf_counter()
            fut = batcher.submit(*row)
            fut.result(timeout=600.0)
            dt = time.perf_counter() - t0
            with e2e_lock:
                e2e.append(dt)

    threads = [
        threading.Thread(target=worker, args=(rows[i::concurrency],))
        for i in range(concurrency)
    ]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t_start
    stats = batcher.close()
    if len(e2e) != requests:
        raise RuntimeError(f"bench: {len(e2e)} of {requests} requests resolved")
    return {
        "requests": requests,
        "concurrency": concurrency,
        "seconds": round(seconds, 6),
        "requests_per_sec": round(requests / max(seconds, 1e-9), 1),
        "e2e_p50": _percentile(e2e, 50),
        "e2e_p99": _percentile(e2e, 99),
        "queue_p50": stats["queue_p50"],
        "queue_p99": stats["queue_p99"],
        "featurize_p50": stats["featurize_p50"],
        "featurize_p99": stats["featurize_p99"],
        "device_p50": stats["device_p50"],
        "device_p99": stats["device_p99"],
        "batches": stats["batches"],
        "batch_fill_mean": stats["batch_fill_mean"],
        "compiles": engine.compile_count,
    }


def cmd_bench(args) -> int:
    from xflow_tpu_torch.serve.engine import PredictEngine

    engine = PredictEngine.load(
        args.artifact,
        device=args.device,
        buckets=_buckets(args.buckets),
        warm=True,
    )
    summary = run_bench(
        engine, args.requests, args.concurrency, args.nnz, args.seed,
        args.max_wait_ms,
    )
    print(json.dumps(
        dict(summary, buckets=list(engine.buckets), device=str(engine.device)),
        sort_keys=True,
    ))
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m xflow_tpu_torch.serve",
        description="serving toolchain of the PyTorch/CUDA port",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("artifact", help="artifact dir (serve/artifact.py)")
        sp.add_argument(
            "--device", default="cuda",
            help="cuda (default; refuses to start without a card) or cpu",
        )
        sp.add_argument(
            "--buckets", default="",
            help="comma-separated batch-size buckets (default 1,8,64,512)",
        )

    ps = sub.add_parser("score", help="pctr per libffm input line")
    common(ps)
    ps.add_argument("--input", default="", help="libffm file (default stdin)")
    ps.add_argument("--out", default="", help="output file (default stdout)")
    ps.add_argument("--no-warm", action="store_true")

    pb = sub.add_parser("bench", help="concurrent serving latency bench")
    common(pb)
    pb.add_argument("--requests", type=int, default=256)
    pb.add_argument("--concurrency", type=int, default=8)
    pb.add_argument("--max-wait-ms", type=float, default=2.0)
    pb.add_argument("--nnz", type=int, default=16, help="features/request")
    pb.add_argument("--seed", type=int, default=0)

    args = p.parse_args(argv)
    if args.cmd == "score":
        return cmd_score(args)
    return cmd_bench(args)


if __name__ == "__main__":
    sys.exit(main())
