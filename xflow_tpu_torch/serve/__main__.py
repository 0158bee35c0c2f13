"""CLI: ``python -m xflow_tpu_torch.serve <serve|index|cascade|loadgen|bench|score>``

    score   ARTIFACT --input FILE     pctr per libffm line (stdout/--out)
    bench   ARTIFACT [--requests N]   closed-loop concurrent load through
                                      one MicroBatcher; prints a JSON
                                      summary with queue/featurize/
                                      device/e2e p50+p99
    index   ARTIFACT --input FILE     build the serve-time item index of
                                      a retrieval (two_tower) artifact
                                      from libffm lines (the reference's
                                      ``index``; serve.artifact.
                                      export_item_index)

    serve   ARTIFACT --port P         the production tier: HTTP front
                                      end (serve/server.py) and, with
                                      --binary-port, the XFB1 transport
                                      (serve/binary.py) over a replica
                                      fleet (--replicas) with admission
                                      control, the score cache and
                                      staged rollout; prints one JSON
                                      line with the bound addresses,
                                      then serves until SIGTERM/SIGINT,
                                      which drain through the tier's
                                      close()
    cascade RETRIEVAL RANKING --port P
                                      retrieval→ranking cascade tier
                                      (serve/cascade.py): a top-k fleet
                                      over the retrieval artifact's
                                      item index feeding a point-score
                                      fleet, behind one HTTP front end
                                      (/v1/recommend, /v1/topk,
                                      /v1/score)
    loadgen ARTIFACT --qps Q          open-loop zipf traffic
                                      (serve/loadgen.py) against an
                                      in-process fleet, --url of a
                                      running tier or --binary-addr of
                                      its XFB1 port; logs the
                                      serve_bench row that
                                      scripts/check_serve_slo.py judges

All run on the card (``--device cuda``, the default) unless
``--device cpu`` is given; with no card, the default refuses to start.
The reference's serve tier also runs a flight recorder, a watchdog, a
request-trace sink, alert rules and a resource sampler (ROADMAP A14):
the port's runs without them, and a flag that asks for one of them
(``--watchdog-serve-s`` or ``--reqtrace-sample`` off its default) or an
``XFLOW_CHAOS`` spec is refused by name, as is ``--num-devices`` above
1 (ROADMAP A13).
"""

from __future__ import annotations

import argparse
import json
import os
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


def cmd_index(args) -> int:
    """Build the serve-time item index beside a retrieval artifact from
    libffm lines: each line's item-side features (fields >= the
    artifact's tower_split_field) become one catalog item, deduplicated
    by feature set, embedded through the item tower (K7 and the tower on
    the card), and frozen by serve.artifact.export_item_index."""
    from xflow_tpu_torch.io.loader import make_parse_fn
    from xflow_tpu_torch.serve.artifact import export_item_index, item_catalog_from_block
    from xflow_tpu_torch.serve.engine import PredictEngine

    engine = PredictEngine.load(args.artifact, device=args.device,
                                buckets=_buckets(args.buckets), warm=False)
    cfg = engine.cfg
    parse = make_parse_fn(cfg.table_size, cfg.hash_mode, cfg.seed,
                          prefer_native=cfg.native_parser)
    src = open(args.input, "rb") if args.input else sys.stdin.buffer
    try:
        block = parse(src.read())
    finally:
        if args.input:
            src.close()
    items = item_catalog_from_block(block, cfg.tower_split_field, args.max_items)
    if not items:
        print("error: no item-side features found (fields >= "
              f"tower_split_field={cfg.tower_split_field})", file=sys.stderr)
        return 1
    meta = export_item_index(engine, args.artifact, items)
    print(json.dumps({"artifact": args.artifact, "items": meta["count"],
                      "dim": meta["dim"], "servable": meta["servable"]}, sort_keys=True))
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



# -- the production tiers ----------------------------------------------------

_WATCHDOG_SERVE_S = 10.0
_REQTRACE_SAMPLE = 0.01


def _refuse_unported(args) -> None:
    """Refuse, by name, what asks for a part of the reference's tier
    that is not ported: a serving mesh (A13), the watchdog, the
    request-trace sink and, where the reference's ``serve`` arms it,
    the chaos fabric (A14)."""
    if getattr(args, "num_devices", 1) > 1:
        raise SystemExit(
            f"--num-devices {args.num_devices}: a multi-GPU serving mesh "
            "is not ported yet (ROADMAP A13)"
        )
    if getattr(args, "watchdog_serve_s", _WATCHDOG_SERVE_S) != _WATCHDOG_SERVE_S:
        raise SystemExit(
            "--watchdog-serve-s: the flight recorder and watchdog are not "
            "ported yet (ROADMAP A14)"
        )
    if getattr(args, "reqtrace_sample", _REQTRACE_SAMPLE) != _REQTRACE_SAMPLE:
        raise SystemExit(
            "--reqtrace-sample: the request-trace sink is not ported yet "
            "(ROADMAP A14)"
        )
    if args.cmd == "serve" and os.environ.get("XFLOW_CHAOS"):
        raise SystemExit(
            "XFLOW_CHAOS: the chaos fabric is not ported yet (ROADMAP A14)"
        )


def _serve_logger(path: str, digest: str, model: str, tag: str):
    from xflow_tpu_torch.utils.logging import MetricsLogger

    if not path:
        return None
    return MetricsLogger(path, run_header={
        "run_id": f"{int(time.time() * 1000):x}-{tag}",
        "config_digest": digest,
        "rank": 0,
        "num_hosts": 1,
        "model": model,
    })


def _wait_for_signal(stop: threading.Event) -> None:
    import signal

    def _drain(signum, frame) -> None:
        stop.set()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)


def cmd_serve(args) -> int:
    """The production tier: fleet + HTTP front end (+ the XFB1 binary
    transport), alive until SIGTERM/SIGINT, then a graceful drain
    through ``ServeTier.close()`` → ``ReplicaFleet.close()`` (every
    accepted request scores; the final serve_stats/serve_shed rows
    flush)."""
    from xflow_tpu_torch.serve.fleet import ReplicaFleet
    from xflow_tpu_torch.serve.server import ServeTier

    fleet = ReplicaFleet.load(
        args.artifact,
        replicas=args.replicas,
        device=args.device,
        buckets=_buckets(args.buckets),
        max_wait_ms=args.max_wait_ms,
        deadline_budget_ms=args.deadline_budget_ms,
        depth_budget=args.depth_budget,
        cache_capacity=args.cache_capacity,
    )
    logger = _serve_logger(args.metrics_out, fleet.digest, fleet.cfg.model, "serve")
    fleet.metrics_logger = logger
    fleet.log_load(args.artifact)
    tier = ServeTier(
        fleet,
        host=args.host,
        port=args.port,
        default_canary_frac=args.canary_frac,
        score_timeout_s=fleet.cfg.serve_score_timeout_s,
        socket_timeout_s=fleet.cfg.serve_socket_timeout_s,
    )
    # binary front end (serve/binary.py): the persistent XFB1
    # transport over the SAME fleet (admission control, cache, stats)
    btier = None
    if args.binary_port >= 0:
        from xflow_tpu_torch.serve.binary import BinaryTier

        btier = BinaryTier(
            fleet,
            host=args.host,
            port=args.binary_port,
            score_timeout_s=fleet.cfg.serve_score_timeout_s,
            socket_timeout_s=fleet.cfg.serve_socket_timeout_s,
        ).start()
    stop = threading.Event()
    _wait_for_signal(stop)
    tier.start()
    print(json.dumps({
        "serving": tier.address,
        "binary": btier.address if btier is not None else None,
        "digest": fleet.digest,
        "model": fleet.cfg.model,
        "replicas": fleet.replicas,
        "buckets": list(fleet.engines[0].buckets),
        "admission": fleet.policy.describe(),
        "cache_capacity": (
            fleet.cache.capacity if fleet.cache is not None else 0
        ),
    }, sort_keys=True), flush=True)
    # the stats-window loop IS the main thread's job until a signal
    while not stop.wait(args.stats_every_s):
        fleet.emit_stats()
    # binary front end first: it only submits into the fleet, so the
    # tier/fleet close below still drains whatever it admitted
    if btier is not None:
        btier.close()
    final = tier.close()
    if logger is not None:
        logger.close()
    print(json.dumps({"drained": final}, sort_keys=True), flush=True)
    return 0


def cmd_cascade(args) -> int:
    """The cascade tier: retrieval top-k fleet + ranking fleet +
    CascadeEngine behind one HTTP front end, alive until
    SIGTERM/SIGINT, then a graceful drain (retrieval first, then
    ranking)."""
    from xflow_tpu_torch.serve.cascade import CascadeEngine
    from xflow_tpu_torch.serve.fleet import ReplicaFleet
    from xflow_tpu_torch.serve.server import ServeTier

    common = dict(
        replicas=args.replicas,
        device=args.device,
        buckets=_buckets(args.buckets),
        max_wait_ms=args.max_wait_ms,
        deadline_budget_ms=args.deadline_budget_ms,
        depth_budget=args.depth_budget,
    )
    retrieval = ReplicaFleet.load(args.retrieval, topk_k=args.topk_k, topk=True,
                                  **common)
    ranking = ReplicaFleet.load(args.ranking, **common)
    logger = _serve_logger(args.metrics_out, ranking.digest, ranking.cfg.model,
                           "cascade")
    retrieval.metrics_logger = logger
    ranking.metrics_logger = logger
    retrieval.reqtrace_stage = "retrieval"
    ranking.reqtrace_stage = "ranking"
    cascade = CascadeEngine(retrieval, ranking, k=args.k, metrics_logger=logger)
    tier = ServeTier(
        ranking,
        host=args.host,
        port=args.port,
        default_canary_frac=args.canary_frac,
        cascade=cascade,
        score_timeout_s=ranking.cfg.serve_score_timeout_s,
        socket_timeout_s=ranking.cfg.serve_socket_timeout_s,
    )
    stop = threading.Event()
    _wait_for_signal(stop)
    tier.start()
    print(json.dumps({
        "serving": tier.address,
        "retrieval_digest": retrieval.digest,
        "ranking_digest": ranking.digest,
        "k": cascade.k,
        "topk_k": retrieval.engines[0].topk_k,
        "index_items": int(len(retrieval.engines[0].item_index["item_index"])),
        "replicas": args.replicas,
    }, sort_keys=True), flush=True)
    while not stop.wait(args.stats_every_s):
        cascade.emit_stats()
        retrieval.emit_stats()
        ranking.emit_stats()
    final = tier.close()
    if logger is not None:
        logger.close()
    print(json.dumps({"drained": final}, sort_keys=True), flush=True)
    return 0


def _parse_qos_mix(text: str) -> dict | None:
    """"bidding=0.3,normal=0.5,best_effort=0.2" → class fractions."""
    if not text:
        return None
    mix = {}
    for part in text.split(","):
        name, sep, frac = part.partition("=")
        if not sep:
            raise ValueError(f"bad --qos-mix entry {part!r} (want class=frac)")
        mix[name.strip()] = float(frac)
    return mix


def cmd_loadgen(args) -> int:
    from xflow_tpu_torch.obs.schema import load_jsonl, validate_rows
    from xflow_tpu_torch.serve.loadgen import BinaryTarget, HttpTarget, run_loadgen

    qos_mix = _parse_qos_mix(args.qos_mix)
    remote_target = None
    if args.url or args.binary_addr:
        # remote mode: the artifact supplies only the key space
        from xflow_tpu_torch.config import Config
        from xflow_tpu_torch.serve.artifact import load_manifest

        manifest = load_manifest(args.artifact)
        digest = manifest["config_digest"]
        model = manifest["model"]
        cfg = Config.from_json(manifest["config"])
        table_size = int(cfg.table_size)
        if args.binary_addr:
            host, _, port = args.binary_addr.rpartition(":")
            depth = (args.pipeline_depth if args.pipeline_depth is not None
                     else cfg.serve_pipeline_depth)
            remote_target = BinaryTarget(
                host or "127.0.0.1", int(port),
                timeout_s=cfg.serve_client_timeout_s,
                pipeline_depth=depth, qos=args.qos or None,
            )
        else:
            remote_target = HttpTarget(
                args.url, timeout_s=cfg.serve_client_timeout_s,
                qos=args.qos or None,
            )
        target: object = remote_target
        fleet = None
    else:
        from xflow_tpu_torch.serve.fleet import ReplicaFleet

        fleet = ReplicaFleet.load(
            args.artifact,
            replicas=args.replicas,
            device=args.device,
            buckets=_buckets(args.buckets),
            max_wait_ms=args.max_wait_ms,
            deadline_budget_ms=args.deadline_budget_ms,
            depth_budget=args.depth_budget,
            cache_capacity=args.cache_capacity,
            **({"default_qos": args.qos} if args.qos else {}),
        )
        digest, model = fleet.digest, fleet.cfg.model
        table_size = None
        target = fleet
    logger = _serve_logger(args.metrics_out, digest, model, "loadgen")
    if fleet is not None:
        fleet.metrics_logger = logger
        fleet.log_load(args.artifact)
    remote = bool(args.url or args.binary_addr)
    try:
        summary = run_loadgen(
            target,
            offered_qps=args.qps,
            duration_s=args.duration_s,
            concurrency=args.concurrency,
            nnz=args.nnz,
            zipf_a=args.zipf_a,
            table_size=table_size,
            seed=args.seed,
            metrics_logger=logger,
            # remote tier: client-side trace ids ride the XFS2 wire
            trace=(args.reqtrace_sample > 0) if remote else None,
            trace_sample=args.reqtrace_sample,
            qos_mix=qos_mix,
        )
    finally:
        if fleet is not None:
            fleet.close()
        if remote_target is not None and hasattr(remote_target, "close"):
            remote_target.close()
        if logger is not None:
            logger.close()
    if args.metrics_out:
        errors = validate_rows(load_jsonl(args.metrics_out))
        if errors:
            for e in errors:
                print(f"schema violation: {e}", file=sys.stderr)
            return 1
    print(json.dumps(summary, sort_keys=True))
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m xflow_tpu_torch.serve",
        description="serving toolchain of the PyTorch/CUDA port",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def placement(sp):
        sp.add_argument(
            "--device", default="cuda",
            help="cuda (default; refuses to start without a card) or cpu",
        )
        sp.add_argument(
            "--num-devices", type=int, default=1,
            help="serving mesh size: 1 (more is ROADMAP A13)",
        )
        sp.add_argument(
            "--buckets", default="",
            help="comma-separated batch-size buckets (default 1,8,64,512)",
        )

    def common(sp):
        sp.add_argument("artifact", help="artifact dir (serve/artifact.py)")
        placement(sp)

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

    pi = sub.add_parser("index", help="build a retrieval artifact's item index")
    common(pi)
    pi.add_argument("--input", default="",
                    help="libffm file of item rows (default stdin); item-side "
                    "features (fields >= the artifact's tower_split_field) are "
                    "deduplicated into the catalog")
    pi.add_argument("--max-items", type=int, default=0,
                    help="cap the catalog size (0 = no cap)")

    def fleet_args(sp):
        sp.add_argument(
            "--replicas", type=int, default=2,
            help="PredictEngine replicas behind the router (clones of "
            "one loaded artifact — shared weights, a graph set each)",
        )
        sp.add_argument("--max-wait-ms", type=float, default=2.0)
        sp.add_argument(
            "--deadline-budget-ms", type=float, default=50.0,
            help="admission control: shed when the oldest queued "
            "request is older than this",
        )
        sp.add_argument(
            "--depth-budget", type=int, default=256,
            help="admission control: shed when a replica backlog "
            "reaches this depth",
        )
        sp.add_argument(
            "--reqtrace-sample", type=float, default=_REQTRACE_SAMPLE,
            help="head-sampling rate of request-scoped traces; the sink "
            "is ROADMAP A14, so only the default is accepted (a remote "
            "loadgen still mints trace ids on the XFS2 wire)",
        )
        sp.add_argument("--metrics-out", default="")

    pv = sub.add_parser(
        "serve", help="HTTP serving tier (fleet + admission + rollout)"
    )
    common(pv)
    fleet_args(pv)
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8000)
    pv.add_argument(
        "--binary-port", type=int, default=-1,
        help="also serve the persistent XFB1 binary transport on this "
        "port (0 = ephemeral, -1 = off; serve/binary.py) — same "
        "fleet, admission control, and cache as the HTTP tier",
    )
    pv.add_argument(
        "--cache-capacity", type=int, default=None,
        help="hot-key score cache entries (serve/scache.py; 0 = off; "
        "default = the artifact config's serve_cache_capacity)",
    )
    pv.add_argument(
        "--canary-frac", type=float, default=0.1,
        help="default canary traffic fraction for POST /v1/rollout",
    )
    pv.add_argument(
        "--stats-every-s", type=float, default=10.0,
        help="serve_stats/serve_shed window flush period",
    )
    pv.add_argument(
        "--watchdog-serve-s", type=float, default=_WATCHDOG_SERVE_S,
        help="the watchdog is ROADMAP A14: only the default is accepted",
    )

    pc = sub.add_parser("cascade", help="retrieval→ranking cascade tier")
    pc.add_argument(
        "retrieval",
        help="retrieval artifact dir (two-tower family with an item "
        "index — serve.artifact.export_item_index)",
    )
    pc.add_argument("ranking", help="ranking artifact dir (any point-score family)")
    placement(pc)
    fleet_args(pc)
    pc.add_argument("--host", default="127.0.0.1")
    pc.add_argument("--port", type=int, default=8000)
    pc.add_argument("--k", type=int, default=8,
                    help="candidates retrieved and ranked per request")
    pc.add_argument(
        "--topk-k", type=int, default=None,
        help="top-k width on the retrieval engines (default 16, capped "
        "at the index size); per-request k slices it",
    )
    pc.add_argument("--canary-frac", type=float, default=0.1)
    pc.add_argument("--stats-every-s", type=float, default=10.0)

    pl = sub.add_parser("loadgen", help="open-loop zipf load generator (SLO rows)")
    common(pl)
    fleet_args(pl)
    pl.add_argument(
        "--url", default="",
        help="target a RUNNING tier instead of an in-process fleet "
        "(the artifact then only supplies the key space)",
    )
    pl.add_argument(
        "--binary-addr", default="",
        help="target a RUNNING binary tier at HOST:PORT over the "
        "pipelined XFB1 transport instead of HTTP",
    )
    pl.add_argument(
        "--pipeline-depth", type=int, default=None,
        help="max in-flight XFB1 frames per connection (default = the "
        "artifact config's serve_pipeline_depth)",
    )
    pl.add_argument(
        "--qos", default="",
        help="QoS admission class for ALL offered traffic "
        "(bidding|normal|best_effort; default = the tier default)",
    )
    pl.add_argument(
        "--qos-mix", default="",
        help="mixed-class traffic, e.g. "
        "'bidding=0.3,normal=0.5,best_effort=0.2'",
    )
    pl.add_argument(
        "--cache-capacity", type=int, default=None,
        help="hot-key score cache entries for the in-process fleet "
        "(0 = off; default = the artifact config knob)",
    )
    pl.add_argument("--qps", type=float, default=500.0)
    pl.add_argument("--duration-s", type=float, default=10.0)
    pl.add_argument("--concurrency", type=int, default=8)
    pl.add_argument("--nnz", type=int, default=8)
    pl.add_argument("--zipf-a", type=float, default=1.3)
    pl.add_argument("--seed", type=int, default=0)

    args = p.parse_args(argv)
    _refuse_unported(args)
    if args.cmd == "score":
        return cmd_score(args)
    if args.cmd == "serve":
        return cmd_serve(args)
    if args.cmd == "index":
        return cmd_index(args)
    if args.cmd == "cascade":
        return cmd_cascade(args)
    if args.cmd == "loadgen":
        return cmd_loadgen(args)
    return cmd_bench(args)


if __name__ == "__main__":
    sys.exit(main())
