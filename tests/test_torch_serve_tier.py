"""The port's production serving tier against the reference's, on the
CPU: the ReplicaFleet, the score cache, ServeTier (HTTP) and BinaryTier
(XFB1), the open-loop load generator and the serve CLI.

* Parity: one artifact, exported by the JAX trainer and written again
  by the port from the same tables, scores through the port's 2-replica
  fleet, its cache's hit path, its HTTP tier (JSON and packed wire) and
  its XFB1 tier within atol 1e-6 of the JAX ``PredictEngine.predict``
  on the same rows (tests/test_serve.py's bar).
* Codecs and generators byte-equal to the reference's for the same
  inputs: the XFS1/XFS2 packed request and response, the XFB1 frames,
  ``zipf_rows`` and ``ScoreCache.row_key``; each copied module equal to
  its original once the package name is mapped, apart from a pinned
  count of lines.
* Semantics as the reference's tests pin them: typed shed by cause and
  QoS class, no mixed artifacts in a rollout mid-traffic, the digest
  guard and the health gate, ``swap`` refusing another digest unless
  forced, no stale cached score after a commit, malformed HTTP and
  XFB1 bodies refused with a 400 / a typed status, ``compile_count`` =
  ``len(buckets)`` fleet-wide and flat, a key per ``hot_nnz``, and the
  A12/A13/A14 refusals by name.

No timing gates: throughput ratios are measured on the card
(chip_smoke.py phase 42).  Every server closes with a bounded join and
every socket has a timeout."""

import difflib
import http.client
import json
import os
import re
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.serve import binary as ref_binary
from xflow_tpu.serve import loadgen as ref_loadgen
from xflow_tpu.serve import scache as ref_scache
from xflow_tpu.serve import server as ref_server
from xflow_tpu.serve.artifact import export_artifact as ref_export_artifact
from xflow_tpu.serve.engine import PredictEngine as RefEngine
from xflow_tpu.trainer import Trainer as RefTrainer
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.io.batch import Batch
from xflow_tpu_torch.obs.schema import load_jsonl, validate_rows
from xflow_tpu_torch.serve import binary, loadgen, scache, server
from xflow_tpu_torch.serve.__main__ import main as cli_main
from xflow_tpu_torch.serve.artifact import load_manifest, write_artifact
from xflow_tpu_torch.serve.engine import PredictEngine
from xflow_tpu_torch.serve.fleet import ReplicaFleet, RolloutError, ShedError
from xflow_tpu_torch.serve.loadgen import BinaryTarget, HttpTarget, run_loadgen
from xflow_tpu_torch.serve.scache import ScoreCache
from xflow_tpu_torch.serve.server import ServeTier
from xflow_tpu_torch.utils.logging import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6
BUCKETS = (1, 8, 64)
TIMEOUT = 30.0
# admission budgets no loaded CPU box reaches, for the tests whose subject
# is not shedding (the default 50 ms queue age sheds under a stall)
UNSHED = dict(deadline_budget_ms=60_000.0, depth_budget=100_000)

# copied modules: lines that differ from the reference once its package
# name is mapped (each line counts twice, removed and added).  Besides
# the changes named here, the copies leave the reference's issue
# numbers out of their comments.
COPIES = {
    "obs/reqtrace.py": 2,
    "serve/scache.py": 2,
    "obs/schema.py": 4,  # and a comment naming the reference's device API
    "serve/batcher.py": 4,
    "serve/server.py": 2,
    "serve/binary.py": 2,
    "serve/loadgen.py": 0,  # byte-equal apart from the package name
    "serve/cascade.py": 0,
    # the docstring's graphs, load's device, the candidate's placement
    # and rollout_delta's refusal (ROADMAP A12)
    "serve/fleet.py": 41,
}


def _kw(ds, **kw):
    base = dict(train_path=ds.train_prefix, test_path=ds.test_prefix, model="fm",
                epochs=1, batch_size=64, table_size_log2=12, max_nnz=24,
                num_devices=1)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def arts(toy_dataset, tmp_path_factory):
    """fm trained by the JAX trainer: artifact ``a`` after one epoch and
    ``b`` (same config digest) after a second; ``port`` is ``a``'s
    tables written again by the port."""
    root = tmp_path_factory.mktemp("serve_tier")
    trainer = RefTrainer(RefConfig(**_kw(toy_dataset)))
    trainer.train()
    a = str(root / "a")
    ref_export_artifact(trainer, a)
    trainer.train_epoch()
    b = str(root / "b")
    ref_export_artifact(trainer, b)
    trainer.close()
    manifest = load_manifest(a)
    cfg = Config.from_json(manifest["config"])
    eng = PredictEngine.load(a, device="cpu", warm=False)
    tables = {n: t["param"].numpy() for n, t in eng.state["tables"].items()}
    port = write_artifact(str(root / "port"), cfg, tables, step=manifest["step"])
    with open(toy_dataset.test_prefix + "-00000") as f:
        lines = f.read().splitlines()
    ref = RefEngine.load(a, buckets=BUCKETS, warm=False)
    rows = _trained_rows(ref, lines, 24)
    return {"a": a, "b": b, "port": port, "cfg": cfg, "rows": rows,
            "want": ref.predict(ref.featurize_raw(rows)),
            "want_b": RefEngine.load(b, buckets=BUCKETS, warm=False).predict(
                ref.featurize_raw(rows))}


def _trained_rows(ref, lines, n):
    """``n`` rows of trained keys (keys, slots, None) from test lines."""
    from xflow_tpu.io.batch import pack_batch
    from xflow_tpu.io.libffm import parse_block

    cfg = ref.cfg
    block = parse_block(("\n".join(lines[:n]) + "\n").encode(), cfg.table_size,
                        cfg.hash_mode, cfg.seed)
    b = pack_batch(block, 0, n, n, cfg.max_nnz)
    return [(b.keys[i][b.mask[i] > 0].astype(np.int64),
             b.slots[i][b.mask[i] > 0].astype(np.int32), None) for i in range(n)]


def _http(tier, method, path, body=None, headers=None):
    """(status, doc or bytes, headers) over one connection with a timeout."""
    conn = http.client.HTTPConnection("127.0.0.1", tier.port, timeout=TIMEOUT)
    try:
        data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
        conn.request(method, path, body=data, headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        ctype = resp.getheader("Content-Type", "")
        doc = json.loads(raw) if "json" in ctype else raw
        return resp.status, doc, dict(resp.getheaders())
    finally:
        conn.close()


def _slowed(engine, delay_s):
    orig = engine.predict_prepared
    engine.predict_prepared = lambda b: (time.sleep(delay_s), orig(b))[1]
    return engine


# -- copies and codecs -------------------------------------------------------


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copied_module_equals_reference(rel):
    with open(os.path.join(REPO, "xflow_tpu", rel), "rb") as f:
        ref_bytes = f.read()
    with open(os.path.join(REPO, "xflow_tpu_torch", rel), "rb") as f:
        port_bytes = f.read()
    ref = re.sub(r"\bxflow_tpu\b", "xflow_tpu_torch", ref_bytes.decode()).splitlines()
    port = port_bytes.decode().splitlines()
    changed = [line for line in difflib.unified_diff(ref, port, lineterm="", n=0)
               if line[:1] in "+-" and not line.startswith(("+++", "---"))]
    assert len(changed) == COPIES[rel], "\n".join(changed)
    if COPIES[rel] == 0 and "xflow_tpu" not in ref_bytes.decode():
        assert port_bytes == ref_bytes


def test_exposition_cut_equals_reference():
    import inspect

    from xflow_tpu.obs import export as ref_export
    from xflow_tpu_torch.obs import export

    for name in ("metric_name", "_fmt", "render_exposition", "parse_exposition"):
        assert inspect.getsource(getattr(export, name)) == inspect.getsource(
            getattr(ref_export, name)), name


def test_codecs_and_generators_byte_equal_to_reference():
    from xflow_tpu.obs.reqtrace import TraceContext as RefCtx
    from xflow_tpu_torch.obs.reqtrace import TraceContext

    rng = np.random.default_rng(11)
    rows = [(rng.integers(0, 4096, size=n).astype(np.int64),
             None if n % 2 else np.arange(n, dtype=np.int32),
             None if n % 3 else rng.random(n).astype(np.float32)) for n in (0, 1, 5, 24)]
    assert server.encode_packed_request(rows) == ref_server.encode_packed_request(rows)
    ctx, rctx = TraceContext(0x1234, 0x5678, True), RefCtx(0x1234, 0x5678, True)
    assert server.encode_packed_request(rows, trace=ctx) == \
        ref_server.encode_packed_request(rows, trace=rctx)
    pctr = rng.random(7).astype(np.float32)
    assert server.encode_packed_response(pctr) == ref_server.encode_packed_response(pctr)
    body = server.encode_packed_request(rows)
    for qos in ("bidding", "normal", "best_effort"):
        assert binary.encode_frame(7, qos, body) == ref_binary.encode_frame(7, qos, body)
    for status in (binary.STATUS_OK, binary.STATUS_SHED, binary.STATUS_TIMEOUT,
                   binary.STATUS_ERROR):
        assert binary.encode_response_frame(9, status, b"xy") == \
            ref_binary.encode_response_frame(9, status, b"xy")
    ours = loadgen.zipf_rows(np.random.default_rng(3), 50, table_size=1 << 20, nnz=8)
    ref = ref_loadgen.zipf_rows(np.random.default_rng(3), 50, table_size=1 << 20, nnz=8)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert o[0].tobytes() == r[0].tobytes() and o[1].tobytes() == r[1].tobytes()
        assert o[2] is None and r[2] is None
    for row in rows:
        assert scache.row_key(*row) == ref_scache.row_key(*row)


def test_xfb1_and_packed_refusals_are_typed():
    body = server.encode_packed_request([(np.asarray([3, 99]), None, None)])
    frame = binary.encode_frame(7, "bidding", body)
    for cut in (1, 4, 8, len(frame) - 1):
        with pytest.raises(ValueError, match="truncat|magic|length"):
            binary.decode_frame(frame[:cut])
    with pytest.raises(ValueError, match="trailing"):
        binary.decode_frame(frame + b"\x00")
    with pytest.raises(ValueError, match="magic"):
        binary.decode_frame(body)
    inflated = bytearray(frame)
    struct.pack_into("<I", inflated, 4, binary.MAX_FRAME_BYTES + 1)
    with pytest.raises(ValueError, match="length"):
        binary.decode_frame(bytes(inflated))
    bad_qos = bytearray(frame)
    bad_qos[16] = 9
    with pytest.raises(ValueError, match="QoS byte"):
        binary.decode_frame(bytes(bad_qos))
    with pytest.raises(ValueError, match="QoS class"):
        binary.encode_frame(1, "platinum", body)


# -- the engine's keys -------------------------------------------------------


def test_compile_count_keys_every_plane_shape(arts):
    """A key per (leg, topk_k, rows, max_nnz, hot_nnz): two batches that
    differ only in hot_nnz are two keys, as the reference keys its
    executables (its engine.py:569-571, :733)."""
    from xflow_tpu_torch.convert import state_from_numpy
    from xflow_tpu_torch.io.freq import build_remap

    engine = PredictEngine.load(arts["port"], device="cpu", buckets=BUCKETS, warm=True)
    assert engine.compile_count == len(BUCKETS)
    assert engine.captures == 0 and engine.graph_replays == {}  # the CPU captures nothing
    cfg = Config(model="fm", table_size_log2=12, max_nnz=24, hot_size_log2=6, hot_nnz=8)
    rng = np.random.default_rng(0)
    tables = {"w": rng.normal(size=(cfg.table_size, 1)).astype(np.float32),
              "v": rng.normal(size=(cfg.table_size, cfg.v_dim)).astype(np.float32)}
    hot = PredictEngine(cfg, state_from_numpy(cfg, tables, "cpu"), device="cpu",
                        buckets=(8,), remap=build_remap(rng.random(cfg.table_size),
                                                        cfg.hot_size), warm=True)
    assert hot.compile_count == 1
    k = cfg.max_nnz  # remap_batch keeps the cold width beside the hot planes

    def batch(kh):
        z, zf = np.zeros((8, k), np.int32), np.zeros((8, k), np.float32)
        h, hf = np.zeros((8, kh), np.int32), np.zeros((8, kh), np.float32)
        return Batch(keys=z, slots=z, vals=zf, mask=zf, labels=zf[:, 0],
                     weights=zf[:, 0], hot_keys=h, hot_slots=h, hot_vals=hf, hot_mask=hf)

    hot.predict_prepared(batch(cfg.hot_nnz))  # the warmed key
    assert hot.compile_count == 1
    hot.predict_prepared(batch(4))  # differs only in hot_nnz
    assert hot.compile_count == 2
    assert hot._keys == {("predict", 0, 8, k, cfg.hot_nnz), ("predict", 0, 8, k, 4)}


# -- the fleet ---------------------------------------------------------------


@pytest.mark.parametrize("writer", ["a", "port"])
def test_fleet_and_cache_match_jax_engine(arts, writer):
    """Two replicas behind the router with the score cache: every
    routed score, misses and hits, within 1e-6 of the JAX engine; one
    key set fleet-wide, flat under mixed batch sizes."""
    fleet = ReplicaFleet.load(arts[writer], replicas=2, device="cpu", buckets=BUCKETS,
                              cache_capacity=256, max_wait_ms=1.0, **UNSHED)
    try:
        assert fleet.replicas == 2
        assert fleet.engines[1].state is fleet.engines[0].state
        assert fleet.engines[1]._keys is fleet.engines[0]._keys
        assert fleet.engines[1].compile_count == len(BUCKETS)
        rows = arts["rows"]
        futs = [fleet.submit(*r) for r in rows]
        miss = np.asarray([f.result(timeout=TIMEOUT) for f in futs])
        np.testing.assert_allclose(miss, arts["want"], atol=ATOL)
        hit = np.asarray([fleet.score(*r, timeout=TIMEOUT) for r in rows])
        assert np.array_equal(hit, miss)  # the cache returns the engine's own bits
        assert fleet.cache.stats_row(reset=False)["cache_hits"] == len(rows)
        engine = fleet.engines[0]
        for n in (1, 3, 8, 50, 64, 130):  # direct mixed sizes add no key
            engine.predict(engine.featurize_raw(rows[:1] * n))
        assert engine.compile_count == len(BUCKETS)
        assert fleet.stats()["compiles"] == len(BUCKETS)
    finally:
        final = fleet.close()
    assert final["stats"]["requests"] == len(arts["rows"])
    assert fleet.close() == final


def test_swap_refuses_another_digest_unless_forced(arts, toy_dataset, tmp_path):
    from xflow_tpu_torch.serve.batcher import MicroBatcher

    ea = PredictEngine.load(arts["a"], device="cpu", buckets=(8,))
    cfg = Config(**_kw(toy_dataset, alpha=0.9))
    other_tables = {n: t["param"].numpy() for n, t in ea.state["tables"].items()}
    other = PredictEngine.load(write_artifact(str(tmp_path / "c"), cfg, other_tables,
                                              step=0), device="cpu", buckets=(8,))
    assert other.digest != ea.digest
    with MicroBatcher(ea, max_wait_ms=0.5) as mb:
        with pytest.raises(ValueError, match="hot-swap refused"):
            mb.swap(other)
        assert mb.engine is ea
        mb.swap(other, force=True)
        assert mb.engine is other
        mb.swap(PredictEngine.load(arts["b"], device="cpu", buckets=(8,)), force=True)
        row = arts["rows"][0]
        assert abs(mb.score(*row) - arts["want_b"][0]) <= ATOL


def test_typed_shed_by_cause_and_class(arts, tmp_path):
    """A backlog past the budgets sheds with a typed ShedError, by cause;
    under a mixed-class overload best_effort sheds and bidding does not;
    the serve_bench row validates and scripts/check_serve_slo.py
    --qos-ordering passes it."""
    engine = _slowed(PredictEngine.load(arts["a"], device="cpu", buckets=(8,)), 0.15)
    fleet = ReplicaFleet(engine, replicas=1, max_wait_ms=0.0, deadline_budget_ms=10.0,
                         depth_budget=2)
    row = arts["rows"][0]
    futs, sheds = [], []
    for _ in range(12):
        try:
            futs.append(fleet.submit(*row))
        except ShedError as e:
            sheds.append(e)
    assert sheds and {e.cause for e in sheds} <= {"queue_depth", "queue_age"}
    assert len([f.result(timeout=TIMEOUT) for f in futs]) == len(futs)
    final = fleet.close()
    assert final["shed"]["shed_total"] == len(sheds)
    assert sum(final["shed"]["by_cause"].values()) == len(sheds)

    engine = _slowed(PredictEngine.load(arts["a"], device="cpu", buckets=(8, 64)), 0.03)
    metrics = tmp_path / "qos.jsonl"
    logger = MetricsLogger(str(metrics), run_header={
        "run_id": "t", "config_digest": engine.digest, "rank": 0, "num_hosts": 1})
    fleet = ReplicaFleet(engine, replicas=1, max_wait_ms=1.0, deadline_budget_ms=10_000.0,
                         depth_budget=10_000, qos_normal_frac=0.5,
                         qos_best_effort_frac=0.002, metrics_logger=logger)
    try:
        summary = run_loadgen(fleet, offered_qps=300, duration_s=0.8, concurrency=4,
                              nnz=6, seed=7, drain_timeout_s=60.0, metrics_logger=logger,
                              qos_mix={"bidding": 0.2, "normal": 0.5, "best_effort": 0.3})
    finally:
        fleet.close()
        logger.close()
    assert validate_rows(load_jsonl(str(metrics))) == []
    assert summary["errors"] == 0
    assert summary["qos_shed"].get("bidding", 0) == 0
    assert summary["qos_shed"].get("best_effort", 0) > 0, summary
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "check_serve_slo.py"),
         str(metrics), "--qos-ordering", "--max-shed-frac", "0.9"],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_rollout_mid_traffic_cache_and_gates(arts, toy_dataset, tmp_path):
    """A staged rollout under concurrent traffic: every score is exactly
    artifact a's or b's (no mixed batch), the gate holds commit until
    the canary is healthy, the cache returns nothing of a after the
    commit, and the rollout rows validate."""
    ea = PredictEngine.load(arts["a"], device="cpu", buckets=(8,))
    pa, pb = float(arts["want"][0]), float(arts["want_b"][0])
    assert abs(pa - pb) > 1e-4
    out = tmp_path / "rollout.jsonl"
    logger = MetricsLogger(str(out), run_header={
        "run_id": "t", "config_digest": ea.digest, "rank": 0, "num_hosts": 1})
    cache = ScoreCache(capacity=64)
    fleet = ReplicaFleet(ea, replicas=2, max_wait_ms=1.0, metrics_logger=logger,
                         cache=cache, **UNSHED)
    row = arts["rows"][0]
    results, failures = [], []
    stop = threading.Event()

    def traffic():
        while not stop.is_set():
            try:
                results.append(fleet.score(*row, timeout=TIMEOUT))
            except BaseException as e:  # noqa: BLE001 - recorded, asserted
                failures.append(e)
                return

    try:
        assert fleet.score(*row) == fleet.score(*row)  # miss, then a hit
        other = tmp_path / "other"
        cfg = Config(**_kw(toy_dataset, alpha=0.9))
        write_artifact(str(other), cfg, {n: t["param"].numpy()
                                         for n, t in ea.state["tables"].items()}, step=0)
        with pytest.raises(ValueError, match="redeploy"):
            fleet.begin_rollout(str(other))
        assert fleet.rollout_state() is None
        threads = [threading.Thread(target=traffic) for _ in range(3)]
        for t in threads:
            t.start()
        fleet.begin_rollout(arts["b"], canary_frac=0.5, min_canary_requests=8)
        with pytest.raises(RolloutError, match="already open"):
            fleet.begin_rollout(arts["b"])
        deadline = time.perf_counter() + TIMEOUT
        while not fleet.rollout_state()["healthy"] and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert fleet.rollout_state()["healthy"]
        fleet.emit_stats()
        assert fleet.commit_rollout()["canary_errors"] == 0
        n = len(results)
        while len(results) < n + 8 and not failures:
            time.sleep(0.01)
        with pytest.raises(RolloutError, match="no rollout open"):
            fleet.abort_rollout()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=TIMEOUT)
        fleet.close()
        logger.close()
    assert not failures, failures
    for p in results:
        assert abs(p - pa) <= ATOL or abs(p - pb) <= ATOL, (p, pa, pb)
    assert abs(results[-1] - pb) <= ATOL
    # after the commit the cache holds only b's generation
    assert cache.lookup(fleet.servable, *row) in (None, results[-1])
    events = [r["event"] for r in load_jsonl(str(out)) if r["kind"] == "rollout"]
    assert events == ["begin", "canary", "commit"]
    assert validate_rows(load_jsonl(str(out))) == []


# -- the front ends ----------------------------------------------------------


def test_http_tier_matches_jax_and_refuses_garbage(arts):
    fleet = ReplicaFleet.load(arts["a"], replicas=2, device="cpu", buckets=BUCKETS,
                              cache_capacity=0, **UNSHED)
    tier = ServeTier(fleet, port=0, poll_s=0.05).start()
    try:
        rows = arts["rows"][:6]
        status, health, _ = _http(tier, "GET", "/healthz")
        assert status == 200 and health["digest"] == fleet.digest
        status, doc, _ = _http(tier, "POST", "/v1/score", {"rows": [
            {"keys": [int(k) for k in r[0]], "slots": [int(s) for s in r[1]]}
            for r in rows]})
        assert status == 200
        np.testing.assert_allclose(doc["pctr"], arts["want"][:6], atol=ATOL)
        status, raw, _ = _http(tier, "POST", "/v1/score_packed",
                               server.encode_packed_request(rows),
                               {"Content-Type": "application/octet-stream"})
        assert status == 200
        np.testing.assert_allclose(server.decode_packed_response(raw),
                                   arts["want"][:6], atol=ATOL)
        status, stats, _ = _http(tier, "GET", "/v1/stats")
        assert status == 200 and stats["shed"]["admitted"] == 12
        assert "watchdog" not in stats and "alerts" not in stats  # ROADMAP A14
        status, text, _ = _http(tier, "GET", "/metrics")
        assert status == 200 and b"xflow_serve_requests" in text
        assert _http(tier, "GET", "/nope")[0] == 404
        code, doc, _ = _http(tier, "POST", "/v1/score", [{"keys": [1, 2]}])
        assert code == 400 and "JSON object" in doc["error"]
        code, doc, _ = _http(tier, "POST", "/v1/score", {"rows": [[1, 2]]})
        assert code == 400 and "row" in doc["error"]
        assert _http(tier, "POST", "/v1/score", b"not json",
                     {"Content-Type": "application/json"})[0] == 400
        assert _http(tier, "POST", "/v1/score_packed", b"XFS1\x01",
                     {"Content-Type": "application/octet-stream"})[0] == 400
        code, doc, _ = _http(tier, "POST", "/v1/rollout/commit", {})
        assert code == 409 and "no rollout" in doc["error"]
        code, doc, _ = _http(tier, "POST", "/v1/score", {"keys": [3, 99]})
        assert code == 200 and len(doc["pctr"]) == 1
    finally:
        final = tier.close()
    assert not tier.running and tier.close() == final


def test_http_backpressure_typed_429_by_class(arts):
    engine = _slowed(PredictEngine.load(arts["a"], device="cpu", buckets=(8,)), 0.25)
    fleet = ReplicaFleet(engine, replicas=1, max_wait_ms=0.0, deadline_budget_ms=15.0,
                         depth_budget=1)
    tier = ServeTier(fleet, port=0, poll_s=0.05).start()
    statuses, lock = [], threading.Lock()

    def hit(qos):
        out = _http(tier, "POST", "/v1/score", {"keys": [1, 2, 3]},
                    {"X-XFlow-QoS": qos, "Content-Type": "application/json"})
        with lock:
            statuses.append(out)

    try:
        threads = [threading.Thread(target=hit, args=(q,))
                   for q in ("bidding", "normal", "best_effort") * 3]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        code, doc, _ = _http(tier, "POST", "/v1/score", {"keys": [1]},
                             {"X-XFlow-QoS": "platinum"})
        assert code == 400
    finally:
        tier.close()
    codes = sorted(s for s, _, _ in statuses)
    assert 200 in codes and 429 in codes, codes
    shed = next((doc, h) for s, doc, h in statuses if s == 429)
    assert shed[0]["error"] == "backpressure"
    assert shed[0]["cause"] in ("queue_depth", "queue_age")
    assert shed[0]["qos"] in ("bidding", "normal", "best_effort")
    assert "Retry-After" in shed[1]


def test_binary_tier_matches_jax_and_refuses_garbage(arts):
    from xflow_tpu_torch.serve.binary import BinaryTier

    fleet = ReplicaFleet.load(arts["port"], replicas=2, device="cpu", buckets=BUCKETS,
                              cache_capacity=0, **UNSHED)
    btier = BinaryTier(fleet, port=0).start()
    try:
        host, _, port = btier.address.rpartition(":")
        target = BinaryTarget(host, int(port), timeout_s=TIMEOUT, pipeline_depth=4)
        try:
            futs = [target.submit(*r) for r in arts["rows"]]
            got = np.asarray([f.result(timeout=TIMEOUT) for f in futs])
        finally:
            target.close()
        np.testing.assert_allclose(got, arts["want"], atol=ATOL)
        with socket.create_connection((host, int(port)), timeout=TIMEOUT) as sock:
            sock.sendall(binary.encode_frame(5, "normal", b"XFS9garbage"))
            rid, status, body = _recv_response(sock)
        assert (rid, status) == (5, binary.STATUS_ERROR)
        assert b"error" in body
    finally:
        btier.close()
        fleet.close()


def _recv_response(sock):
    buf = b""
    while len(buf) < 8:
        buf += sock.recv(4096)
    (length,) = struct.unpack_from("<I", buf, 4)
    while len(buf) < 8 + length:
        buf += sock.recv(4096)
    return binary.decode_response_frame(buf[:8 + length])


def test_loadgen_over_both_transports(arts):
    """The open loop drives the HTTP and XFB1 tiers over one fleet; 0
    errors, every request accounted for, and the per-bucket rows."""
    from xflow_tpu_torch.serve.binary import BinaryTier

    fleet = ReplicaFleet.load(arts["a"], replicas=2, device="cpu", buckets=BUCKETS,
                              **UNSHED)
    tier = ServeTier(fleet, port=0, poll_s=0.05).start()
    btier = BinaryTier(fleet, port=0).start()
    try:
        host, _, port = btier.address.rpartition(":")
        legs = {"http": HttpTarget(tier.address, timeout_s=TIMEOUT),
                "binary": BinaryTarget(host, int(port), timeout_s=TIMEOUT)}
        for name, target in legs.items():
            try:
                s = run_loadgen(target, offered_qps=150, duration_s=0.5, concurrency=4,
                                table_size=arts["cfg"].table_size, seed=1)
            finally:
                if hasattr(target, "close"):
                    target.close()
            assert s["errors"] == 0 and s["outstanding"] == 0, (name, s)
            assert s["requests"] > 0 and s["achieved_qps"] > 0
    finally:
        btier.close()
        tier.close()


# -- refusals and the CLI ----------------------------------------------------


def test_unported_parts_refused_by_name(arts, monkeypatch):
    with pytest.raises(NotImplementedError, match="A13"):
        PredictEngine.load(arts["a"], device="cpu", num_devices=2)
    with pytest.raises(NotImplementedError, match="A13"):
        ReplicaFleet.load(arts["a"], device="cpu", num_devices=2)
    engine = PredictEngine.load(arts["a"], device="cpu", buckets=(8,))
    with pytest.raises(NotImplementedError, match="A12"):
        engine.apply_delta(arts["b"])
    fleet = ReplicaFleet(engine, replicas=1)
    try:
        with pytest.raises(NotImplementedError, match="A12"):
            fleet.rollout_delta(arts["b"])
    finally:
        fleet.close()
    base = ["serve", arts["a"], "--device", "cpu", "--port", "0"]
    for extra, item in ((["--num-devices", "2"], "A13"),
                        (["--watchdog-serve-s", "3"], "A14"),
                        (["--reqtrace-sample", "0.5"], "A14")):
        with pytest.raises(SystemExit, match=item):
            cli_main(base + extra)
    with pytest.raises(SystemExit, match="A13"):
        cli_main(["score", arts["a"], "--device", "cpu", "--num-devices", "2"])
    with pytest.raises(SystemExit, match="A14"):
        cli_main(["loadgen", arts["a"], "--device", "cpu", "--reqtrace-sample", "0"])
    monkeypatch.setenv("XFLOW_CHAOS", "serve.accept:p=1")
    with pytest.raises(SystemExit, match="A14"):
        cli_main(base)


def test_serve_cli_scores_drains_and_loadgen_judges(arts, tmp_path):
    """``serve`` in a subprocess: the startup line keeps the reference's
    keys, /v1/score answers the JAX engine's pctr, ``loadgen --url``
    writes a serve_bench row that validates and check_serve_slo.py
    passes, and SIGTERM drains."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "xflow_tpu_torch.serve", "serve", arts["a"],
         "--device", "cpu", "--port", "0", "--binary-port", "0", "--buckets", "1,8",
         "--stats-every-s", "0.5", "--deadline-budget-ms", "60000"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        start = json.loads(proc.stdout.readline())
        assert set(start) == {"serving", "binary", "digest", "model", "replicas",
                              "buckets", "admission", "cache_capacity"}
        port = int(start["serving"].rpartition(":")[2])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
        r = arts["rows"][0]
        conn.request("POST", "/v1/score", body=json.dumps(
            {"keys": [int(k) for k in r[0]], "slots": [int(s) for s in r[1]]}))
        doc = json.loads(conn.getresponse().read())
        conn.close()
        assert abs(doc["pctr"][0] - arts["want"][0]) <= ATOL
        metrics = tmp_path / "lg.jsonl"
        rc = cli_main(["loadgen", arts["a"], "--url", start["serving"], "--qps", "60",
                       "--duration-s", "0.5", "--concurrency", "2",
                       "--metrics-out", str(metrics)])
        assert rc == 0
        assert validate_rows(load_jsonl(str(metrics))) == []
        gate = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", "check_serve_slo.py"),
             str(metrics)], capture_output=True, text=True, timeout=120)
        assert gate.returncode == 0, gate.stdout + gate.stderr
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    # the stats loop flushed the windows; the drain prints the last one
    assert set(json.loads(out.strip().splitlines()[-1])["drained"]) >= {"stats", "shed"}
