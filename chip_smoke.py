#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``xflow_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for sm_90a) and the CUDA
toolkit's ``nvcc``; exits non-zero, printing no result, without them.
Phases, in order; any failure raises and the exit code is 1:

1. identify the card (``nvidia-smi`` name and power limit) and build
   every kernel of the package from ``xflow_tpu_torch/csrc``;
2. hold K1 (ops/score.py, csrc/score.cu) against its plain PyTorch
   version on the card at the full-width tables (T=2^24, D=10), every
   serving bucket B in {1, 8, 64, 512} x K=40, LR and FM, compact wire
   (x = 1) and full wire (values other than 1), with padding, rows that
   are all padding and logits past +-30 (both clamps).  Tolerances:
   logit rtol 1e-5 / atol 1e-5 — the warp reduction sums in another
   order than the plain version; pctr atol 1e-6 plus that logit
   tolerance carried through the sigmoid's slope p(1-p), since a
   rounding difference in the logit moves pctr by p(1-p) times it;
3. the main path: write a full-width ``fm_nohot`` artifact (the
   geometry of scripts/bench_models.py) from seed-made numpy tables,
   ``PredictEngine.load`` it on the card, ``score_text`` 2,048
   seed-made libffm lines, and compare with the plain version on the
   same parsed planes and with a float64 numpy reference;
4. the main path under load: a ``MicroBatcher`` with 1,024 requests
   from 16 client threads, 40 features each;
5. kernel timings with CUDA events (median of 60 launches per bucket,
   each on another of 64 key batches so the gathered rows are not all
   in L2), beside the plain version, the bound and, for LR, one
   PyTorch call computing the same function (``embedding_bag`` + the
   sigmoid).  ``ms`` is device time: the timed calls queue behind a
   ``torch.cuda._sleep`` that holds the stream until the host has
   enqueued them all, so the events around a call bracket only its
   device work.  ``host_path_ms`` is the same call timed alone on an
   idle stream, where the card waits at the start event for the host
   to reach the launch: it adds the Python path to the launch.  An
   empty kernel timed the same way gives the floor under both.

Output: the card line, per-phase lines, a ``{"kernels": [...]}`` JSON
line, and last ``{"ok": true, "device": {...}}``.  K1's launch count in
the kernels line is the main path's (phases 3 and 4): every count is
set to 0 just before the engine loads and read after the bench.
"""

from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
K = 40  # fm_nohot max_nnz
D = 10  # fm_nohot v_dim (reference ftrl.h:16)
T_LOG2 = 24  # fm_nohot table_size_log2
BUCKETS = (1, 8, 64, 512)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM data sheet, outside the tensor cores
SECTOR = 32  # bytes: the least a random DRAM read moves
PCTR_ATOL = 1e-6
LOGIT_RTOL = 1e-5
LOGIT_ATOL = 1e-5
TIMED_RUNS = 60
KEY_POOL = 64
TIMED_CHUNK = 15  # calls queued behind one sleep
SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's SM clock
REPLACES = (
    "xflow_tpu/parallel/step.py:820 (B1 gather) + "
    "xflow_tpu/models/blocks.py:41 (B1 masked_x/linear_term) + "
    "xflow_tpu/models/blocks.py:171 (B8 fwd fm_pair_pieces) + "
    "xflow_tpu/parallel/step.py:769 (B4 compact _expand_wire) + "
    "xflow_tpu/utils/metrics.py:34 (sigmoid_ref); no pl.pallas_call in "
    "the reference"
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_host_path_ms(fn, args_list) -> float:
    """Median milliseconds of ``fn(*args)`` over ``args_list``, CUDA
    events around each call on an idle stream: the card waits at the
    start event until the host reaches the launch, so this is the
    device work plus the Python path to it."""
    import torch

    for args in args_list[:5]:
        fn(*args)  # warm-up
    torch.cuda.synchronize()
    pairs = []
    for args in args_list:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def time_device_ms(fn, args_list) -> float:
    """Median device milliseconds of ``fn(*args)`` over ``args_list``.
    Each chunk of calls is enqueued behind a ``torch.cuda._sleep`` that
    holds the stream until the host has enqueued the whole chunk, so
    the events around a call see only its device work.  A chunk whose
    enqueue outlasted the sleep is run again behind a longer one."""
    import torch

    for args in args_list[:5]:
        fn(*args)  # warm-up
    torch.cuda.synchronize()
    times = []
    cycles = SLEEP_CYCLES
    for c in range(0, len(args_list), TIMED_CHUNK):
        chunk = args_list[c:c + TIMED_CHUNK]
        for _ in range(4):
            before = torch.cuda.Event(enable_timing=True)
            after = torch.cuda.Event(enable_timing=True)
            before.record()
            torch.cuda._sleep(cycles)
            after.record()
            t0 = time.perf_counter()
            pairs = []
            for args in chunk:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                pairs.append((start, end))
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            if enqueue_ms < before.elapsed_time(after):
                times.extend(s.elapsed_time(e) for s, e in pairs)
                break
            cycles *= 2
        else:
            raise AssertionError(
                f"the stream drained while {fn.__name__} was enqueued "
                f"({enqueue_ms:.3f} ms of enqueue behind a shorter sleep)"
            )
    return statistics.median(times)


def bounds(keys, x, dim: int) -> dict:
    """K1's least time on this card for THIS batch: the larger of its
    bytes over the HBM rate and its float32 operations over the peak
    rate.  Keys, x and pctr count once each, and each distinct live
    table row once.  ``bound_ms`` counts the row bytes the kernel uses
    (4 B of w, 4D B of v); ``bound_sector_ms`` counts the 32-byte DRAM
    sectors a random row read moves at least (csrc/score.cu header)."""
    import torch

    b, k = keys.shape
    live_keys = keys[keys >= 0]
    live = int(live_keys.numel())
    rows = int(torch.unique(live_keys).numel())
    stream = b * k * (4 + (4 if x is not None else 0)) + 4 * b
    used = stream + rows * (4 + 4 * dim)
    sectors = stream + rows * (SECTOR + math.ceil(4 * dim / SECTOR) * SECTOR)
    # per live slot: x*w and its sum, and (FM) v*x, its sum, its square
    # summed; per example: s*s - s2 summed over D, the sigmoid
    ops = live * (2 + 4 * dim) + b * (3 * dim + 4)
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    used_ms = used / HBM_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(used_ms, ops_ms),
        "bound_by": "bytes" if used_ms >= ops_ms else "operations",
        "bound_sector_ms": max(sectors / HBM_BYTES_PER_S * 1e3, ops_ms),
        "bound_bytes": used, "bound_sector_bytes": sectors, "bound_ops": ops,
    }


def make_tables(dev, t_log2: int):
    """Phase-2 tables on the card, from a seeded generator.  Rows
    [0, 64) carry w = +20 and rows [64, 128) w = -20, so rows steered
    onto them land past the +-30 clamps."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    t = 1 << t_log2
    w = torch.randn((t, 1), generator=g, device=dev) * 3.0
    v = torch.randn((t, D), generator=g, device=dev) * 0.3
    w[:64] = 20.0
    w[64:128] = -20.0
    return w, v, g


def make_keys(b: int, t: int, g, dev, full: bool):
    """Sentinel-coded keys [b, K] (and x for the full wire): random row
    lengths with tail padding and random holes, every 7th row all
    padding (when b > 1), and rows steered past the clamps."""
    import torch

    keys = torch.randint(128, t, (b, K), generator=g, device=dev, dtype=torch.int32)
    pos = torch.arange(K, device=dev)[None, :]
    length = torch.randint(1, K + 1, (b, 1), generator=g, device=dev)
    live = (pos < length) & (torch.rand((b, K), generator=g, device=dev) > 0.1)
    live[:, 0] = True
    rows = torch.arange(b, device=dev)
    if b > 1:
        live[rows % 7 == 3] = False
    hot = torch.randint(0, 64, (b, 3), generator=g, device=dev, dtype=torch.int32)
    keys[:, :3] = torch.where((rows % 6 == 1)[:, None], hot, keys[:, :3])
    keys[:, :3] = torch.where((rows % 6 == 2)[:, None], hot + 64, keys[:, :3])
    live[(rows % 6 == 1) | (rows % 6 == 2), :3] = True
    keys = torch.where(live, keys, torch.full_like(keys, -1)).contiguous()
    x = None
    if full:
        x = torch.rand((b, K), generator=g, device=dev) * 1.75 + 0.25
        x = torch.where(live, x, torch.zeros_like(x)).contiguous()
    return keys, x


def phase_kernel_vs_plain(dev, t_log2: int) -> dict:
    """Phase 2: K1 against score_plain in every bucket, mode and wire."""
    import torch

    from xflow_tpu_torch.ops.score import score, score_plain

    w, v, g = make_tables(dev, t_log2)
    max_err = 0.0
    clamped_hi = clamped_lo = padded_rows = 0
    for b in BUCKETS:
        for mode in ("lr", "fm"):
            for full in (False, True):
                keys, x = make_keys(b, w.shape[0], g, dev, full)
                vv = v if mode == "fm" else None
                got_p, got_l = score(keys, x, w, vv, return_logit=True)
                want_p, want_l = score_plain(keys, x, w, vv, return_logit=True)
                torch.cuda.synchronize()
                err = float((got_p - want_p).abs().max())
                ltol = LOGIT_ATOL + LOGIT_RTOL * want_l.abs()
                lexcess = float(((got_l - want_l).abs() - ltol).max())
                ptol = PCTR_ATOL + want_p * (1 - want_p) * ltol
                pexcess = float(((got_p - want_p).abs() - ptol).max())
                if pexcess > 0 or lexcess > 0:
                    raise AssertionError(
                        f"K1 disagrees with score_plain: B={b} {mode} "
                        f"{'full' if full else 'compact'} pctr err {err} "
                        f"(excess {pexcess}), logit excess {lexcess}"
                    )
                if not bool(torch.isfinite(got_p).all()):
                    raise AssertionError(f"K1 non-finite pctr at B={b} {mode}")
                max_err = max(max_err, err)
                clamped_hi += int((want_l > 30).sum())
                clamped_lo += int((want_l < -30).sum())
                padded_rows += int((keys < 0).all(dim=1).sum())
    if not (clamped_hi and clamped_lo and padded_rows):
        raise AssertionError(
            f"phase 2 did not cover the clamps and padding rows: "
            f"{clamped_hi} > 30, {clamped_lo} < -30, {padded_rows} all-padding"
        )
    del w, v
    return {
        "max_abs_err": max_err, "rows_above_30": clamped_hi,
        "rows_below_minus_30": clamped_lo, "all_padding_rows": padded_rows,
    }


def fm_nohot_config(t_log2: int):
    from xflow_tpu_torch.config import Config

    # scripts/bench_models.py fm_nohot (accelerator geometry)
    return Config(
        model="fm", max_nnz=K, v_dim=D, optimizer="ftrl",
        table_size_log2=t_log2, batch_size=65536, num_devices=1,
        max_fields=39,
    )


def libffm_lines(n: int, rng) -> list[str]:
    """Seed-made libffm lines: 1..45 features (some past max_nnz, so
    truncation runs too) over 39 fields."""
    lines = []
    for _ in range(n):
        m = int(rng.integers(1, 46))
        fids = rng.integers(0, 10**7, size=m)
        feats = " ".join(f"{j % 39}:{fid}:1" for j, fid in enumerate(fids))
        lines.append(f"{int(rng.integers(0, 2))}\t{feats}")
    return lines


def phase_main_path(dev, t_log2: int, workdir: str, n_lines: int = 2048,
                    requests: int = 1024, concurrency: int = 16) -> dict:
    """Phases 3 and 4: artifact → PredictEngine → score_text, then the
    MicroBatcher bench.  Returns the K1 launches counted across both."""
    import torch

    from xflow_tpu_torch.io.batch import pack_batch
    from xflow_tpu_torch.io.libffm import parse_block
    from xflow_tpu_torch.ops.score import score, score_plain
    from xflow_tpu_torch.parallel.step import compact_wire_np
    from xflow_tpu_torch.serve.__main__ import run_bench
    from xflow_tpu_torch.serve.artifact import write_artifact
    from xflow_tpu_torch.serve.engine import PredictEngine

    cfg = fm_nohot_config(t_log2)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    w = rng.standard_normal((cfg.table_size, 1), dtype=np.float32)
    w *= 0.3
    v = rng.standard_normal((cfg.table_size, D), dtype=np.float32)
    v *= 0.05
    art = write_artifact(f"{workdir}/fm_nohot", cfg, {"w": w, "v": v}, step=1)
    log(f"phase 3: wrote the fm_nohot artifact (T=2^{t_log2}, D={D}) in "
        f"{time.perf_counter() - t0:.3f} s")

    score.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    engine = PredictEngine.load(art, device=dev)
    load_s = time.perf_counter() - t0
    lines = libffm_lines(n_lines, rng)
    t0 = time.perf_counter()
    pctr = engine.score_text(lines)
    score_s = time.perf_counter() - t0
    calls = len(engine.buckets) + math.ceil(n_lines / engine.buckets[-1])
    if score.launches != calls:
        raise AssertionError(
            f"engine made {calls} device calls but K1 launched {score.launches} times"
        )
    if pctr.shape != (n_lines,) or not np.all(np.isfinite(pctr)):
        raise AssertionError(f"bad pctr: shape {pctr.shape}")
    if not np.all((pctr > 0) & (pctr <= 1)):
        raise AssertionError("pctr outside (0, 1]")

    # the same parsed planes through the plain version, on the card
    block = parse_block("\n".join(lines).encode() + b"\n", cfg.table_size,
                        cfg.hash_mode, cfg.seed)
    batch = pack_batch(block, 0, n_lines, n_lines, cfg.max_nnz)
    ckeys = torch.from_numpy(compact_wire_np(batch)["ckeys"]).to(dev)
    tables = engine.state["tables"]
    want = score_plain(ckeys, None, tables["w"]["param"], tables["v"]["param"])
    err = float(np.abs(pctr - want.cpu().numpy()).max())
    if err > PCTR_ATOL:
        raise AssertionError(f"engine vs plain on the card: max err {err}")
    # and a float64 numpy reference on the first 64 lines
    ref_err = 0.0
    for i in range(64):
        live = batch.mask[i] > 0
        keys_i = batch.keys[i][live]
        lin = float(w[keys_i, 0].astype(np.float64).sum())
        vr = v[keys_i].astype(np.float64)
        logit = lin + float((vr.sum(0) ** 2 - (vr * vr).sum(0)).sum())
        p = 1e-6 if logit < -30 else 1.0 if logit > 30 else 1 / (1 + math.exp(-logit))
        ref_err = max(ref_err, abs(p - float(pctr[i])))
    if ref_err > 1e-5:
        raise AssertionError(f"engine vs float64 reference: max err {ref_err}")
    log(json.dumps({
        "phase": 3, "load_s": load_s, "score_text_s": score_s,
        "lines": n_lines, "device_calls": calls, "k1_launches": score.launches,
        "max_abs_err_vs_plain": err, "max_abs_err_vs_float64": ref_err,
        "pctr_mean": float(pctr.mean()),
    }))

    before = score.launches
    summary = run_bench(engine, requests, concurrency, K, SEED)
    if engine.compile_count != len(engine.buckets):
        raise AssertionError(
            f"compile_count {engine.compile_count} != {len(engine.buckets)} buckets"
        )
    if score.launches - before != summary["batches"]:
        raise AssertionError(
            f"{summary['batches']} batches but {score.launches - before} launches"
        )
    log(json.dumps(dict(summary, phase=4)))
    launches = score.launches  # the main path ends here
    del engine, tables
    return {"launches": launches}


def empty_kernel_ms() -> float:
    """Device milliseconds of one empty kernel between two events, timed
    as the kernels are: the floor under any one-launch time here."""
    import torch

    def empty():
        torch.cuda._sleep(0)

    return time_device_ms(empty, [()] * TIMED_RUNS)


def phase_timings(dev, t_log2: int) -> list[dict]:
    """Phase 5: K1, plain and library times per bucket and mode."""
    import torch
    import torch.nn.functional as F

    from xflow_tpu_torch.ops.score import score, score_plain
    from xflow_tpu_torch.utils.metrics import sigmoid_ref

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    t = 1 << t_log2
    w = torch.randn((t, 1), generator=g, device=dev) * 0.3
    v = torch.randn((t, D), generator=g, device=dev) * 0.05
    rows = []
    for mode in ("lr", "fm"):
        vv = v if mode == "fm" else None
        for b in BUCKETS:
            pool = [
                torch.randint(0, t, (b, K), generator=g, device=dev, dtype=torch.int32)
                for _ in range(KEY_POOL)
            ]
            args = [(pool[i % KEY_POOL], None, w, vv) for i in range(TIMED_RUNS)]
            row = {
                "mode": mode, "B": b, "K": K, "D": D if vv is not None else 0,
                "ms": time_device_ms(score, args),
                "host_path_ms": time_host_path_ms(score, args),
                "plain_ms": time_device_ms(score_plain, args),
                "plain_host_path_ms": time_host_path_ms(score_plain, args),
                **bounds(pool[0], None, D if vv is not None else 0),
                "library_ms": None,
            }
            if mode == "lr":
                ones = torch.ones((b, K), device=dev)

                def library(keys, _x, w_, _v):
                    return sigmoid_ref(F.embedding_bag(
                        keys, w_, per_sample_weights=ones, mode="sum"
                    )[:, 0])

                got = library(*args[0])
                want = score_plain(*args[0])
                if float((got - want).abs().max()) > PCTR_ATOL:
                    raise AssertionError("embedding_bag yardstick disagrees")
                row["library_ms"] = time_device_ms(library, args)
                row["library_host_path_ms"] = time_host_path_ms(library, args)
            rows.append(row)
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this "
              "script runs only on a CUDA card", file=sys.stderr)
        return 1
    try:
        import xflow_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}) — run "
              "from the root of a checkout", file=sys.stderr)
        return 1
    from xflow_tpu_torch.device import resolve_device
    from xflow_tpu_torch.ops.build import build, build_log

    dev = resolve_device("cuda")
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(dev)}")
    t0 = time.perf_counter()
    seconds = build("score")
    log(json.dumps({"phase": 1, "build_s": {"score": seconds},
                    "build_wall_s": time.perf_counter() - t0}))
    for line in build_log("score").splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas score: {line.strip()}")

    check = phase_kernel_vs_plain(dev, T_LOG2)
    log(json.dumps(dict(check, phase=2)))
    workdir = tempfile.mkdtemp(prefix="xflow-chip-smoke-")
    try:
        main_path = phase_main_path(dev, T_LOG2, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    timings = phase_timings(dev, T_LOG2)
    for row in timings:
        log(json.dumps(dict(row, phase=5)))
    log(json.dumps({"phase": 5, "empty_kernel_ms": empty_kernel_ms()}))
    head = next(r for r in timings if r["mode"] == "fm" and r["B"] == BUCKETS[-1])
    kernels = [{
        "name": "score",
        "route": "cuda",
        "source": "xflow_tpu_torch/csrc/score.cu",
        "replaces": REPLACES,
        "launches": main_path["launches"],
        "max_abs_err": check["max_abs_err"],
        "ms": head["ms"],
        "host_path_ms": head["host_path_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "bound_sector_ms": head["bound_sector_ms"],
        "library_ms": head["library_ms"],
        "shape": {"mode": "fm", "B": head["B"], "K": K, "D": D},
        "per_bucket": timings,
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
