#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``xflow_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for sm_90a) and the CUDA
toolkit's ``nvcc``; exits non-zero, printing no result, without them.
Phases, in order; any failure raises and the exit code is 1:

1. identify the card (``nvidia-smi`` name and power limit) and build
   every kernel of the package from ``xflow_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together;
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

6. hold K2 (ops/train.py, csrc/train.cu) against its plain version on
   the card at T=2^24, K=40, B in {1,024, 65,536}, LR and FM (D=10),
   compact wire (u8 labels/weights, x = 1) and full wire (values, f32
   labels/weights), keys uniform over T and keys with heavy repetition
   (log-uniform ranks, so the hottest rows take thousands of atomics
   per batch), with padding, all-padding rows, zero-weight rows and
   logits past +-30.  Tolerances (k2_tolerances): per row, twice the
   float32 rounding bound of each side — gamma_n = n * 2^-23 times the
   sum of the absolute values of the row's n summed terms (summation
   order: atomics land in any order), plus each occurrence's residual
   error carried from the logit's own summation bound through the
   sigmoid's slope (and the 1e-6 step of the -30 clamp when the logit
   lies within that bound of it); the same for the log-loss sum; the
   weight sum (count) is exact;
7. hold K3 (ops/optim.py, csrc/optim.cu) against its plain version on
   the card at T=2^24, D in {1, 10}, FTRL and SGD, with rows never
   touched (g = 0, n = 0) and |z'| near lambda1.  Tolerances
   (k3_tolerances): elementwise float32 rounding bounds — n' 2 ulp
   (FMA contraction of n + g*g), z' 4 ulp of |z| + |g| + |sigma w|
   terms, w' that z' bound over the FTRL denominator plus 4 ulp (the
   soft threshold is continuous in z', so a last-ulp difference at
   |z'| = lambda1 moves w' by at most that much); SGD 2 ulp of
   |w| + |lr g|.  Untouched rows must keep w exactly, and g == 0
   afterwards everywhere;
8. the training main path on the repo's own CTR traffic
   (scripts/gen_synth.py, copied as xflow_tpu_torch/io/synth.py: 39
   fields, ids zipf(1.2) over 100,000 per field, a planted logistic
   signal; 2 train shards of 65,536 lines and a 16,384-line test
   shard); ``Trainer`` on the card at ``fm_nohot`` and ``lr_nohot``
   (scripts/bench_models.py geometry, T=2^24, batch 65,536) for 2
   epochs, ``evaluate`` (writing pred lines), ``export_artifact``,
   ``PredictEngine.load`` on the card scoring the test lines as
   ``evaluate`` did (atol 1e-6 plus the 5e-7 rounding of the ``%.6f``
   pred lines); then the same run on ``device="cpu"`` from the same
   initial state (TRAIN_BOUNDS), and the eval AUC must lie between the
   planted signal's bars (AUC_Z).  Launch counts are zeroed just
   before and read just after: K2 = steps, K3 = steps x tables.  After
   the run, K2 is held against its plain version on the path's own
   batches and timed on them (and on the same batches with every
   repeated key made distinct), and K3 on the trained tables;
9. K2 and K3 timings at synthetic shapes (keys uniform and Zipf-like;
   device time behind ``_sleep``, host path, plain, bounds, library
   call where one exists) and the ``train`` line, whose device busy
   share comes from phase 8's and phase 14's kernel times on the paths'
   own inputs;
10. hold K4 (``consolidate_keys``) and K5 (``touched_update``, both in
   csrc/sparse.cu) and K2's index mode against their plain versions on
   the sparse path's own first batch (B = 65,536, FM and LR) and on
   cases made from it: its first 512 rows, 512 rows of padding, one key
   in every row, uniform keys.  K4 exactly: the same count and key set
   as the plain version (the kernel's slots are a permutation of the
   plain version's sorted ones), every occurrence's slot holding its
   own key, padding -1.  K2's per-key sums within the sum of their
   occurrences' phase-6 bounds.  K5 (FTRL on every table; SGD on the
   widest) within phase 7's
   bounds, with planted rows that keep w (g = 0, n = 0) and rows whose
   |z'| lands on lambda1; every row outside the unique keys
   bit-identical, the summed gradients cleared, the slot map restored;
11. the sparse update mode (``update_mode="sparse"``) on phase 8's
   shards from phase 8's initial state, 2 epochs, FM and LR: launches
   K4 = K2 = steps, K5 = steps x tables, K3 = 0, no [T, D] gradient
   buffer; the card against the CPU (TRAIN_BOUNDS) and against phase
   8's dense card run (dense and sparse are the same training);
12. sequential mode with the sparse inner at microbatch 128 (B_eff =
   512 rows, the docs/CONVERGENCE.md protocol), 2 epochs, FM and LR,
   the card against the CPU: per-step log-loss and eval within
   TRAIN_BOUNDS; the tables of the two runs compared and reported (the
   worst element with its FTRL state and its row's occurrences), and
   held to TRAIN_BOUNDS by ``lockstep_tables``: the same batches
   replayed on the card and the CPU slice by slice, where an element
   whose first gradient is 0 on one side only (FTRL's n' == 0 keeps
   w's init: a discontinuity that a last-ulp difference can cross) is
   verified as rounding against phase 6's bound and synchronised;
   launches per slice, and its eval AUC against the planted bars.
   ``--seq-witness`` and ``--seq-lockstep`` (see ``main``) are the
   diagnostics that found that split.  Its first dispatch is
   queued behind a ``torch.cuda._sleep`` and run under
   ``torch.cuda.set_sync_debug_mode("error")``: it must return while
   the sleep still holds the stream (a host sync inside it would wait
   for the sleep), and a sync the debug mode sees raises;
13. one dispatch each (the first train shard) of dense microbatch 4,
   dense ``cold_consolidate`` (both run the plain dense step: K2 once,
   K3 per table) and sequential with the dense inner at microbatch 4,
   FM and LR, the card against the CPU, exact launches;
14. K4, K2's index mode and K5 timed on the sparse path's first batch,
   its first 512 rows and the sequential path's first slice (device ms
   behind ``_sleep``, plain ms, bounds, and ``torch.unique(...,
   return_inverse=True)`` as K4's library call).

Output: the card line, per-phase lines, a ``{"kernels": [...]}`` JSON
line, and last ``{"ok": true, "device": {...}}``.  Each kernel's
``launches`` is its main paths': K1's serving path (phases 3 and 4)
plus the training paths' eval and engine batches (phases 8, 11, 12),
K2-K5's training paths (phases 8 and 11-13, by path in
``launches_by_path``); every count is set to 0 just before each path
and read just after it.
"""

from __future__ import annotations

import dataclasses
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


def time_device_ms(fn, args_list, prelude=None, chunk_size=TIMED_CHUNK) -> float:
    """Median device milliseconds of ``fn(*args)`` over ``args_list``.
    Each chunk of calls is enqueued behind a ``torch.cuda._sleep`` that
    holds the stream until the host has enqueued the whole chunk, so
    the events around a call see only its device work.  A chunk whose
    enqueue outlasted the sleep is run again behind a longer one.
    ``prelude()``, when given, is enqueued ahead of each call, outside
    its events (an L2 flush, say).  The card holds about a thousand
    pending launches; past that the host blocks until the sleep ends,
    so a function of many launches takes a smaller ``chunk_size``."""
    import torch

    for args in args_list[:5]:
        fn(*args)  # warm-up
    torch.cuda.synchronize()
    times = []
    cycles = SLEEP_CYCLES
    for c in range(0, len(args_list), chunk_size):
        chunk = args_list[c:c + chunk_size]
        for _ in range(4):
            before = torch.cuda.Event(enable_timing=True)
            after = torch.cuda.Event(enable_timing=True)
            before.record()
            torch.cuda._sleep(cycles)
            after.record()
            t0 = time.perf_counter()
            pairs = []
            for args in chunk:
                if prelude is not None:
                    prelude()
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
                f"({enqueue_ms:.3f} ms of enqueue behind a shorter sleep; "
                f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved, "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)"
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


# ---------------------------------------------------------------------------
# Training kernels and the training main path (phases 6-9)

EPS32 = 2.0 ** -23  # float32 machine epsilon
TRAIN_BATCHES = (1024, 65536)
TRAIN_LINES = 65536  # per train shard; 2 shards = 2 steps per epoch
TEST_LINES = 16384
TRAIN_EPOCHS = 2
# The training traffic is the repo's own generator (scripts/gen_synth.py,
# copied as xflow_tpu_torch/io/synth.py): 39 Criteo-style fields, ids
# zipf(1.2) over 100,000 per field, a planted logistic signal.  Seed 7 is
# its default, whose Bayes floor scripts/convergence_baseline.py records.
SYNTH_SEED = 7
# The planted signal's bar: the eval AUC must clear chance by AUC_Z
# standard deviations of the rank-sum AUC of a scorer with no signal
# (Mann-Whitney: sqrt((P+N+1)/(12 P N)) on the test shard's labels), and
# stay below the planted model's own AUC on the same lines (the Bayes
# scorer), which no trained model can pass.
AUC_Z = 3.0
# Port on the card against the port on the CPU over the same steps from
# the same initial state.  Each step's gradients differ by float32
# summation order (atomics), which FTRL carries into n, z and w and the
# next step's forward; over TRAIN_EPOCHS x 2 steps that stays within
# 1e-4 relative plus 1e-5 of the array's largest magnitude.  The
# log-loss is a mean over 65,536 examples: 1e-5 relative.  AUC: one
# swapped near-tie moves it by 1/(P*N) (about 1.6e-8 here); 1e-3 allows
# tens of thousands of swaps among pctrs that differ in the last ulp.
TRAIN_BOUNDS = {"table_rtol": 1e-4, "table_atol_frac": 1e-5,
                "logloss_rtol": 1e-5, "auc_atol": 1e-3}
PRED_ATOL = 1e-6 + 5e-7  # serving bar plus the %.6f rounding of pred lines
K2_REPLACES = (
    "xflow_tpu/parallel/step.py:815 (B1 training gather) + "
    "xflow_tpu/models/fm.py:67 (B8 bwd grad_logit) + "
    "xflow_tpu/parallel/step.py:49 (B2 residual, grads_from_rows) + "
    "xflow_tpu/parallel/step.py:923 (B2 _cold_keys_eff/_scatter_grads drop-mode "
    "scatter-add) + xflow_tpu/parallel/step.py:769 (B4 compact _expand_wire, "
    "u8 labels/weights) + xflow_tpu/utils/metrics.py:49 (logloss_sum); no "
    "pl.pallas_call in the reference"
)
K3_REPLACES = (
    "xflow_tpu/optim/ftrl.py:50 (B3 FTRL.update_rows) + "
    "xflow_tpu/optim/sgd.py:24 (B3 SGD.update_rows) + "
    "xflow_tpu/parallel/step.py:1123 (B3 dense full-table pass) + "
    "xflow_tpu/parallel/step.py:1075 (the per-step zeroed gradient buffer); "
    "no pl.pallas_call in the reference"
)


KERNEL_WRAPPERS = ("score", "train_step", "optim_update", "consolidate_keys",
                   "touched_update")


def wrappers() -> dict:
    """The kernels' wrappers by name, K1-K5."""
    from xflow_tpu_torch.ops.optim import optim_update
    from xflow_tpu_torch.ops.score import score
    from xflow_tpu_torch.ops.sparse import consolidate_keys, touched_update
    from xflow_tpu_torch.ops.train import train_step

    return {"score": score, "train_step": train_step, "optim_update": optim_update,
            "consolidate_keys": consolidate_keys, "touched_update": touched_update}


def zero_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def build_all() -> dict:
    """Build every kernel source at once, one nvcc each; returns the
    seconds per source and the wall time.  A failed build raises."""
    import threading

    from xflow_tpu_torch.ops.build import CSRC_DIR, build

    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    seconds: dict = {}
    errors: dict = {}

    def one(name):
        try:
            seconds[name] = build(name)
        except Exception as e:  # re-raised below, after every build ends
            errors[name] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"kernel builds failed: {errors}")
    return {"build_s": seconds, "build_wall_s": time.perf_counter() - t0}


def zipf_keys(shape, t: int, g, dev):
    """Keys with heavy repetition: log-uniform ranks over [128, t), so
    rank r is drawn with probability about 1/r (Zipf, exponent 1) and
    the hottest rows recur thousands of times in a 65,536-row batch;
    ranks are spread over the table by a multiplicative hash."""
    import torch

    u = torch.rand(shape, generator=g, device=dev, dtype=torch.float64)
    rank = torch.exp(u * math.log(t - 128)).long() - 1
    return (128 + (rank * 2654435761) % (t - 128)).to(torch.int32)


def k2_inputs(b: int, w, g, dev, full: bool, zipf: bool):
    """K2 inputs on the card: make_keys' planes (padding, holes, all-
    padding rows, rows steered past the clamps), optionally Zipf keys,
    random labels, and weights with some zero rows (fractional on the
    full wire)."""
    import torch

    keys, x = make_keys(b, w.shape[0], g, dev, full)
    if zipf:
        z = zipf_keys(keys.shape, w.shape[0], g, dev)
        steered = keys < 128
        keys = torch.where((keys >= 0) & ~steered, z, keys).contiguous()
    labels = (torch.rand(b, generator=g, device=dev) > 0.5).to(torch.float32)
    weights = (torch.rand(b, generator=g, device=dev) > 0.05).to(torch.float32)
    if full:
        weights = weights * torch.where(
            torch.rand(b, generator=g, device=dev) > 0.5, 1.0, 0.5
        )
    else:
        labels, weights = labels.to(torch.uint8), weights.to(torch.uint8)
    num_real = max(float(weights.float().sum()), 1.0)
    return keys, x, labels, weights, num_real


def k2_tolerances(keys, x, labels, weights, num_real, w, v):
    """Per-row tolerances for K2's g_w and g_v against its plain version,
    and one for the log-loss sum (module docstring, phase 6).  Computed
    in float64 from the inputs."""
    import torch

    k = keys.shape[1]
    live = keys >= 0
    kl = keys.clamp(min=0).long()
    xk = (live.double() if x is None else x.double()) * live
    wx = w[kl, 0].double() * xk
    logit = wx.sum(1)
    mag = wx.abs().sum(1)
    dim = 0
    if v is not None:
        dim = v.shape[1]
        vx = v[kl].double() * xk[..., None]  # [B, K, D]
        s = vx.sum(1)
        s_abs = vx.abs().sum(1)
        s2 = (vx * vx).sum(1)
        logit = logit + (s * s - s2).sum(1)
        mag = mag + (2 * s.abs() * s_abs + s2).sum(1)
    gamma = EPS32 * (k + dim + 4)
    dlogit = 2 * gamma * mag
    p = 1.0 / (1.0 + torch.exp(-logit))
    p = torch.where(logit < -30, torch.full_like(p, 1e-6), p)
    p = torch.where(logit > 30, torch.ones_like(p), p)
    dp = p * (1 - p) * dlogit + 4 * EPS32 * p
    dp = dp + torch.where((logit + 30).abs() <= dlogit, 1e-6, 0.0)
    y, wt = labels.double(), weights.double()
    r = (p - y) * wt / num_real
    dr = dp * wt / num_real + 4 * EPS32 * r.abs()
    flat = kl[live]
    t = w.shape[0]
    n_row = torch.bincount(flat, minlength=t).double()

    def scatter(vals, width):
        out = torch.zeros((t, width), dtype=torch.float64, device=keys.device)
        return out.index_add_(0, flat, vals.reshape(-1, width)[live.reshape(-1)])

    occ_abs = (xk * r[:, None]).abs()[..., None]
    occ_err = (xk.abs() * dr[:, None])[..., None]
    tol_w = 2 * (scatter(occ_err, 1) + EPS32 * (n_row[:, None] + 2) * scatter(occ_abs, 1))
    tol_v = None
    if v is not None:
        term = (s[:, None, :] - vx) * xk[..., None] * r[:, None, None]
        err = xk.abs()[..., None] * (
            (s[:, None, :] - vx).abs() * dr[:, None, None]
            + r.abs()[:, None, None] * (2 * gamma * s_abs[:, None, :] + EPS32 * vx.abs())
        )
        tol_v = 2 * (scatter(err, dim) + EPS32 * (n_row[:, None] + 4) * scatter(term.abs(), dim))
    pc = p.clamp(1e-6, 1 - 1e-6)
    ll = -(y * torch.log(pc) + (1 - y) * torch.log(1 - pc)) * wt
    dll = dp / torch.minimum(pc, 1 - pc) * wt
    tol_ll = 2 * (float(dll.sum()) + EPS32 * (keys.shape[0] + 4) * float(ll.abs().sum()))
    return tol_w, tol_v, tol_ll


def check_k2(case: str, keys, x, labels, weights, num_real, w, v, worst: dict) -> None:
    """K2 against train_plain on one batch, within k2_tolerances; the
    count exact.  Raises on a disagreement, else updates ``worst``."""
    import torch

    from xflow_tpu_torch.ops.train import train_plain, train_step

    outs = []
    for fn in (train_step, train_plain):
        g_w = torch.zeros_like(w)
        g_v = torch.zeros_like(v) if v is not None else None
        acc = torch.zeros(2, device=w.device, dtype=torch.float64)
        fn(keys, x, labels, weights, num_real, w, v, g_w, g_v, acc)
        outs.append((g_w, g_v, acc))
    torch.cuda.synchronize()
    tol_w, tol_v, tol_ll = k2_tolerances(keys, x, labels, weights, num_real, w, v)
    (gw, gv, acc), (pw, pv, pacc) = outs
    pairs = [(gw, pw, tol_w)] + ([(gv, pv, tol_v)] if v is not None else [])
    for got, want, tol in pairs:
        diff = (got.double() - want.double()).abs()
        excess = float((diff - tol).max())
        if excess > 0 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K2 disagrees with train_plain: {case} "
                                 f"gradient excess {excess}")
        worst["max_abs_err_g"] = max(worst["max_abs_err_g"], float(diff.max()))
        ratio = diff / torch.where(tol > 0, tol, 1.0)
        worst["max_err_over_tol"] = max(worst["max_err_over_tol"], float(ratio.max()))
    ll_err = abs(float(acc[0]) - float(pacc[0]))
    if ll_err > tol_ll:
        raise AssertionError(f"K2 log-loss sum {float(acc[0])} vs plain "
                             f"{float(pacc[0])} ({case}, tolerance {tol_ll})")
    if float(acc[1]) != float(pacc[1]):
        raise AssertionError(f"K2 count {float(acc[1])} != plain "
                             f"{float(pacc[1])} ({case})")
    worst["max_abs_err_logloss_sum"] = max(worst["max_abs_err_logloss_sum"], ll_err)


def phase_k2_vs_plain(dev, t_log2: int) -> dict:
    """Phase 6: K2 against train_plain in every batch, mode, wire and key
    distribution."""
    import torch

    from xflow_tpu_torch.ops.score import score_plain

    w, v, g = make_tables(dev, t_log2)
    worst = {"max_abs_err_g": 0.0, "max_err_over_tol": 0.0,
             "max_abs_err_logloss_sum": 0.0}
    clamped_hi = clamped_lo = padded_rows = max_repeat = 0
    for b in TRAIN_BATCHES:
        for mode in ("lr", "fm"):
            vv = v if mode == "fm" else None
            for full in (False, True):
                for zipf in (False, True):
                    keys, x, labels, weights, num_real = k2_inputs(
                        b, w, g, dev, full, zipf
                    )
                    case = (f"B={b} {mode} {'full' if full else 'compact'} "
                            f"{'zipf' if zipf else 'uniform'}")
                    check_k2(case, keys, x, labels, weights, num_real, w, vv, worst)
                    _, logit = score_plain(keys, x, w, vv, return_logit=True)
                    clamped_hi += int((logit > 30).sum())
                    clamped_lo += int((logit < -30).sum())
                    padded_rows += int((keys < 0).all(dim=1).sum())
                    live = keys[keys >= 0].long()
                    max_repeat = max(max_repeat, int(torch.bincount(live).max()))
    if not (clamped_hi and clamped_lo and padded_rows and max_repeat >= 1000):
        raise AssertionError(
            f"phase 6 did not cover the clamps, padding and repeats: "
            f"{clamped_hi} > 30, {clamped_lo} < -30, {padded_rows} all-padding, "
            f"hottest key {max_repeat} times"
        )
    del w, v
    return dict(worst, rows_above_30=clamped_hi, rows_below_minus_30=clamped_lo,
                all_padding_rows=padded_rows, hottest_key_occurrences=max_repeat)


def k3_tolerances(table: dict, new_n, opt) -> dict:
    """Elementwise tolerances for K3 against its plain version (module
    docstring, phase 7), from the inputs and the plain n'."""
    import torch

    from xflow_tpu_torch.optim import FTRL

    w, gr = table["param"], table["g"]
    if not isinstance(opt, FTRL):
        return {"param": 2 * EPS32 * (w.abs() + (opt.lr * gr).abs())}
    n, z = table["n"], table["z"]
    sq = torch.sqrt(new_n) + torch.sqrt(n)
    tol_n = 2 * EPS32 * (n + gr * gr)
    tol_z = 4 * EPS32 * (z.abs() + gr.abs() + sq / opt.alpha * w.abs())
    denom = (opt.beta + torch.sqrt(new_n)) / opt.alpha + opt.lambda2
    return {"n": tol_n, "z": tol_z, "param": (tol_z + 2 * EPS32 * opt.lambda1) / denom}


def phase_k3_vs_plain(dev, t_log2: int) -> dict:
    """Phase 7: K3 against optim_plain at D in {1, 10}, FTRL and SGD."""
    import torch

    from xflow_tpu_torch.ops.optim import optim_plain, optim_update
    from xflow_tpu_torch.optim import FTRL, SGD

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    t = 1 << t_log2
    worst = {"max_abs_err": 0.0, "max_err_over_tol": 0.0}
    near_l1 = untouched = 0
    for d in (1, D):
        for opt in (FTRL(), SGD()):
            quarter = t // 4
            gr = torch.zeros((t, d), device=dev)
            gr[:quarter] = torch.randn((quarter, d), generator=g, device=dev) * 0.01
            table = {"param": torch.randn((t, d), generator=g, device=dev) * 0.01, "g": gr}
            if isinstance(opt, FTRL):
                n = torch.rand((t, d), generator=g, device=dev) * 1e-3
                n[t // 2:] = 0.0  # rows [t/2, t): never touched (g = 0, n = 0)
                z = torch.randn((t, d), generator=g, device=dev) * 1e-3
                # rows [t/8, t/4): w = 0 and z = +-lambda1 - g, so |z'|
                # lands within rounding of lambda1
                near = slice(t // 8, quarter)
                sgn = torch.where(torch.rand((quarter - t // 8, d), generator=g,
                                             device=dev) > 0.5, 1.0, -1.0)
                z[near] = sgn * opt.lambda1 - gr[near]
                table["param"][near] = 0.0
                table.update(n=n, z=z)
            plain = {k: a.clone() for k, a in table.items()}
            before = {k: a.clone() for k, a in table.items()}
            optim_update(table, opt)
            optim_plain(plain, opt)
            torch.cuda.synchronize()
            tols = k3_tolerances(before, plain.get("n"), opt)
            case = f"D={d} {opt.name}"
            for name, tol in tols.items():
                diff = (table[name] - plain[name]).abs()
                excess = float((diff - tol).max())
                if excess > 0:
                    raise AssertionError(f"K3 disagrees with optim_plain: {case} {name} "
                                         f"excess {excess}")
                worst["max_abs_err"] = max(worst["max_abs_err"], float(diff.max()))
                ratio = diff / torch.where(tol > 0, tol, 1.0)
                worst["max_err_over_tol"] = max(worst["max_err_over_tol"], float(ratio.max()))
            if not bool((table["g"] == 0).all()):
                raise AssertionError(f"K3 left a non-zero gradient ({case})")
            if isinstance(opt, FTRL):
                idle = before["n"][t // 2:] == 0
                if not bool((table["param"][t // 2:] == before["param"][t // 2:]).all()):
                    raise AssertionError(f"K3 moved w on never-touched rows ({case})")
                untouched += int(idle.sum())
                zn = plain["z"].abs()
                near_l1 += int(((zn - opt.lambda1).abs() <= tols["z"]).sum())
            del table, plain, before
    if not near_l1:
        raise AssertionError("phase 7 did not cover |z'| near lambda1")
    return dict(worst, never_touched_elements=untouched, near_lambda1_elements=near_l1)


def write_train_shards(root: str) -> dict:
    """The repo's CTR traffic (xflow_tpu_torch/io/synth.py, a copy of
    scripts/gen_synth.py): 2 train shards of TRAIN_LINES lines and a
    TEST_LINES test shard, one planted model (SYNTH_SEED); returns the
    train and test prefixes."""
    import os

    from xflow_tpu_torch.io.synth import generate_dataset

    prefix = os.path.join(root, "synth")
    generate_dataset(prefix, 2 * TRAIN_LINES, TEST_LINES, train_shards=2,
                     seed=SYNTH_SEED)
    return {"train": prefix + ".train", "test": prefix + ".test"}


def auc_bars(test_shard: str) -> dict:
    """The planted signal's AUC bars on the test shard (AUC_Z): the floor
    chance + AUC_Z null standard deviations, the ceiling the Bayes
    scorer's AUC (the planted model's own pctr on these lines)."""
    from xflow_tpu_torch.io.synth import planted_pctr, read_shard
    from xflow_tpu_torch.utils.metrics import auc_rank_sum

    labels, ids = read_shard(test_shard)
    pos = int(labels.sum())
    neg = len(labels) - pos
    null_sd = math.sqrt((pos + neg + 1) / (12.0 * pos * neg))
    return {"floor": 0.5 + AUC_Z * null_sd, "null_sd": null_sd,
            "bayes_auc": auc_rank_sum(labels, planted_pctr(ids, SYNTH_SEED)),
            "positives": pos, "negatives": neg}


def train_config(model: str, t_log2: int, data: dict, metrics_out: str):
    """fm_nohot, or lr_nohot (the same geometry without v), training
    on ``data``'s shards."""
    return dataclasses.replace(
        fm_nohot_config(t_log2), model=model, epochs=TRAIN_EPOCHS,
        train_path=data["train"], test_path=data["test"],
        metrics_out=metrics_out,
    )


def compare_states(gpu_state, cpu_state, occ=None, gate: bool = True) -> dict:
    """Tables of the card's run against the CPU run's, held to
    TRAIN_BOUNDS' table terms.  Reports the worst ratio to them, the
    elements whose |z| lies within rounding of lambda1, and the worst
    element: its table array, row and column, its values on both sides,
    its FTRL state on the CPU (|z| over lambda1, n) and, given ``occ``
    (occurrences per row over the run's batches), how often its row
    occurred.  With ``gate``, a breach raises with that element."""
    import torch

    from xflow_tpu_torch.optim import FTRL

    worst = {"max_err_over_bound": 0.0, "near_lambda1": 0, "worst_element": None}
    l1 = FTRL().lambda1
    failed = None
    for name, table in cpu_state["tables"].items():
        for key, want in table.items():
            if key == "g":
                continue
            got = gpu_state["tables"][name][key].cpu()
            bound = (TRAIN_BOUNDS["table_rtol"] * want.abs()
                     + TRAIN_BOUNDS["table_atol_frac"] * float(want.abs().max()))
            ratios = (got - want).abs() / torch.where(bound > 0, bound, 1.0)
            i = int(torch.argmax(ratios))
            row, col = divmod(i, want.shape[1])
            ratio = float(ratios.view(-1)[i])
            if ratio > worst["max_err_over_bound"] or worst["worst_element"] is None:
                worst["max_err_over_bound"] = ratio
                worst["worst_element"] = {
                    "array": f"{name}.{key}", "row": row, "col": col,
                    "card": float(got[row, col]), "cpu": float(want[row, col]),
                    "bound": float(bound[row, col]),
                    "cpu_z_over_lambda1": float(table["z"][row, col]) / l1
                    if "z" in table else None,
                    "cpu_n": float(table["n"][row, col]) if "n" in table else None,
                    "row_occurrences": int(occ[row]) if occ is not None else None,
                }
            if ratio > 1.0 and failed is None:
                failed = dict(worst["worst_element"], ratio=ratio)
            if key == "z":
                zb = TRAIN_BOUNDS["table_rtol"] * want.abs()
                worst["near_lambda1"] += int(((want.abs() - l1).abs() <= zb).sum())
    if gate and failed is not None:
        raise AssertionError(f"table {failed['array']}: card vs CPU beyond TRAIN_BOUNDS "
                             f"{json.dumps(failed)}")
    return worst


def row_occurrences(shipped: list, t: int):
    """Occurrences of each of the ``t`` rows over the batches a run
    shipped (on the host)."""
    import torch

    occ = None
    for arrays in shipped:
        k = arrays["ckeys"]
        n = torch.bincount(k[k >= 0].long(), minlength=t)
        occ = n if occ is None else occ + n
    return occ.cpu()


def read_pred_lines(path: str) -> np.ndarray:
    with open(path) as f:
        return np.array([float(line.split("\t")[1]) for line in f], dtype=np.float64)


def phase_train_main_path(dev, t_log2: int, workdir: str) -> dict:
    """Phase 8: Trainer on the card at lr_nohot and fm_nohot, evaluate,
    export, the engine on the artifact, and the same run on the CPU."""
    import os

    import torch

    from xflow_tpu_torch.convert import state_from_numpy, state_to_numpy
    from xflow_tpu_torch.serve.artifact import export_artifact
    from xflow_tpu_torch.serve.engine import PredictEngine
    from xflow_tpu_torch.trainer import Trainer

    t0 = time.perf_counter()
    data = write_train_shards(workdir)
    bars = auc_bars(f"{data['test']}-00000")
    log(f"phase 8: wrote 2 x {TRAIN_LINES} train + {TEST_LINES} test lines in "
        f"{time.perf_counter() - t0:.3f} s; AUC bars {json.dumps(bars)}")
    with open(f"{data['test']}-00000") as f:
        test_lines = f.read().splitlines()
    rows = []
    launches = dict.fromkeys(KERNEL_WRAPPERS, 0)
    k2_worst = {"max_abs_err_g": 0.0, "max_err_over_tol": 0.0,
                "max_abs_err_logloss_sum": 0.0}
    inits, finals = {}, {}
    for model in ("fm", "lr"):
        cfg = train_config(model, t_log2, data, os.path.join(workdir, f"{model}.jsonl"))
        zero_launches()
        # the training main path starts here
        trainer = Trainer(cfg, device=dev, log=log)
        init = inits[model] = state_to_numpy(trainer.state, aux=True)
        shipped = keep_shipped_batches(trainer)
        t0 = time.perf_counter()
        history = trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        pred_path = os.path.join(workdir, f"{model}.pred")
        result = trainer.evaluate(pred_out=pred_path)
        art = export_artifact(trainer, os.path.join(workdir, f"{model}_artifact"))
        engine = PredictEngine.load(art, device=dev)
        pctr = engine.score_text(test_lines)
        torch.cuda.synchronize()
        got = read_launches()
        # ... and ends here
        trainer.close()
        finals[model] = state_to_numpy(trainer.state, aux=True)
        steps = sum(h["steps"] for h in history)
        tables = len(trainer.state["tables"])
        want_score = 1 + len(engine.buckets) + math.ceil(TEST_LINES / engine.buckets[-1])
        if (got["train_step"] != steps or got["optim_update"] != steps * tables
                or got["consolidate_keys"] or got["touched_update"]):
            raise AssertionError(f"{model}: {steps} steps x {tables} tables but launches {got}")
        if got["score"] != want_score:
            raise AssertionError(f"{model}: K1 launched {got['score']} times, "
                                 f"expected {want_score} (1 eval batch + engine)")
        for k in launches:
            launches[k] += got[k]
        pred = read_pred_lines(pred_path)
        pred_err = float(np.abs(pred - pctr).max())
        if pctr.shape != (TEST_LINES,) or pred_err > PRED_ATOL:
            raise AssertionError(f"{model}: engine scores differ from evaluate's "
                                 f"pred lines by {pred_err}")
        if not bars["floor"] < result["auc"] < bars["bayes_auc"]:
            raise AssertionError(f"{model}: eval AUC {result['auc']} outside the "
                                 f"planted signal's bars {bars}")
        with open(cfg.metrics_out) as f:
            kinds = {json.loads(line)["kind"] for line in f}
        if not {"run_start", "shard", "train_epoch", "wire", "eval"} <= kinds:
            raise AssertionError(f"{model}: metrics rows missing, got {sorted(kinds)}")

        # the same steps on the CPU, from the same initial state
        cpu = Trainer(dataclasses.replace(cfg, metrics_out=""), device="cpu",
                      log=lambda _: None)
        cpu.state = state_from_numpy(cfg, init, "cpu")
        cpu_history = cpu.train()
        cpu_result = cpu.evaluate()
        cpu.close()
        for a, b in zip(trainer.step_logloss, cpu.step_logloss):
            if abs(a - b) > TRAIN_BOUNDS["logloss_rtol"] * max(abs(b), 1.0):
                raise AssertionError(f"{model}: step log-loss {a} on the card vs {b} on "
                                     "the CPU")
        if len(trainer.step_logloss) != len(cpu.step_logloss):
            raise AssertionError(f"{model}: step counts differ")
        if abs(result["auc"] - cpu_result["auc"]) > TRAIN_BOUNDS["auc_atol"] or abs(
                result["logloss"] - cpu_result["logloss"]) > TRAIN_BOUNDS["logloss_rtol"] * abs(
                cpu_result["logloss"]):
            raise AssertionError(f"{model}: eval on the card {result} vs CPU {cpu_result}")
        state_cmp = compare_states(trainer.state, cpu.state)
        kernels = main_path_kernels(model, trainer, shipped[:len(shipped) // TRAIN_EPOCHS],
                                    k2_worst)
        rows.append({
            "model": model, "steps": steps, "tables": tables, "launches": got,
            "train_seconds": train_s,
            "examples_per_sec": [h["examples_per_sec"] for h in history],
            "step_time_p50": [h["step_time_p50"] for h in history],
            "step_time_p99": [h["step_time_p99"] for h in history],
            "phases": [h["phases"] for h in history],
            "overlapped": [h["overlapped"] for h in history],
            "parse_mb_per_sec": [h.get("parse_mb_per_sec") for h in history],
            "train_logloss": [h["train_logloss"] for h in history],
            "cpu_train_logloss": [h["train_logloss"] for h in cpu_history],
            "eval": {k: result[k] for k in ("auc", "logloss", "examples")},
            "cpu_eval": {k: cpu_result[k] for k in ("auc", "logloss")},
            "auc_bars": bars,
            "bayes_gap_closed": (result["auc"] - 0.5) / (bars["bayes_auc"] - 0.5),
            **kernels,
            "engine_vs_eval_max_abs": pred_err,
            **state_cmp,
        })
        del trainer, cpu, engine, init, shipped
        torch.cuda.empty_cache()
    return {"rows": rows, "launches": launches, "k2_check": k2_worst,
            "data": data, "bars": bars, "inits": inits, "finals": finals}


def keep_shipped_batches(trainer) -> list:
    """Keep a reference to every batch the trainer ships to the card
    (its ``put_batch`` results, in step order); adds no work."""
    shipped = []
    put = trainer.step.put_batch

    def put_and_keep(batch, predict=False):
        arrays = put(batch, predict)
        if not predict:
            shipped.append(arrays)
        return arrays

    trainer.step.put_batch = put_and_keep
    return shipped


def main_path_kernels(model: str, trainer, batches: list, worst: dict) -> dict:
    """K2 and K3 on the training main path's own inputs, after its run:
    on each batch of one epoch (the epochs repeat them), K2 against
    train_plain (check_k2), the batch's key statistics, and K2's device
    time (behind an L2 flush, as in the run, where K3's full-table pass
    precedes each K2), host path, plain time and bounds; the same batch
    with every repeated key replaced by a distinct one (distinct while
    B*K <= T), which isolates what the repeats cost; and K3 on the trained tables (g is 0 after
    a step, so a K3 pass leaves them as they are)."""
    import torch

    from xflow_tpu_torch.ops.optim import optim_plain, optim_update
    from xflow_tpu_torch.ops.train import train_plain, train_step

    tables = trainer.state["tables"]
    w = tables["w"]["param"]
    v = tables["v"]["param"] if "v" in tables else None
    dim = v.shape[1] if v is not None else 0
    dev = w.device
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)  # 128 MiB > L2
    k2_rows, batch_stats = [], []
    for i, arrays in enumerate(batches):
        keys, x = arrays["ckeys"], arrays.get("x")
        lw = ("labels_u8", "weights_u8") if "labels_u8" in arrays else ("labels", "weights")
        labels, weights = arrays[lw[0]], arrays[lw[1]]
        num_real = arrays["num_real"]
        check_k2(f"{model} main-path batch {i}", keys, x, labels, weights, num_real,
                 w, v, worst)
        live = keys >= 0
        batch_stats.append({"live_slots": int(live.sum()),
                            "distinct_keys": int(torch.unique(keys[live]).numel()),
                            **repeat_stats(keys)})
        slot = torch.arange(keys.numel(), device=dev, dtype=torch.int64).view_as(keys)
        distinct = torch.where(live, (slot * 2654435761) % w.shape[0],
                               torch.full_like(slot, -1)).to(torch.int32)
        for keys_name, kk in (("main_path", keys), ("main_path_no_repeats", distinct)):
            g_w = torch.zeros_like(w)
            g_v = torch.zeros_like(v) if v is not None else None
            acc = torch.zeros(2, device=dev, dtype=torch.float64)
            args = [(kk, x, labels, weights, num_real, w, v, g_w, g_v, acc)] * TIMED_RUNS
            k2_rows.append({
                "mode": model, "B": keys.shape[0], "K": keys.shape[1], "D": dim,
                "keys": keys_name, "batch": i,
                "ms": time_device_ms(train_step, args, prelude=flush.zero_),
                "host_path_ms": time_host_path_ms(train_step, args),
                "plain_ms": time_device_ms(train_plain, args, prelude=flush.zero_),
                **k2_bounds(kk, x, labels, dim),
                "library_ms": None,
                "library_why_null": "no single PyTorch call computes the "
                "gather, logit, residual, scatter-add and log-loss",
            })
            log(json.dumps(dict(k2_rows[-1], phase=8)))
            del g_w, g_v
    k3_rows = []
    opt = trainer.step.optimizer
    for name, table in tables.items():
        args = [(table, opt)] * TIMED_RUNS
        d = table["param"].shape[1]
        k3_rows.append({
            "optimizer": opt.name, "table": name, "T": table["param"].shape[0], "D": d,
            "ms": time_device_ms(optim_update, args),
            "host_path_ms": time_host_path_ms(optim_update, args),
            "plain_ms": time_device_ms(optim_plain, args),
            **k3_bounds(table["param"].numel(), opt.name == "ftrl"),
            "library_ms": None,
            "library_why_null": "no single PyTorch call applies the FTRL recurrence",
        })
        log(json.dumps(dict(k3_rows[-1], phase=8, model=model)))
    del flush
    return {"batch_stats": batch_stats, "k2_main_path": k2_rows, "k3_main_path": k3_rows}


def row_distinct(keys, t: int, g):
    """``keys`` with every repeat of a live key within its own row
    replaced by a fresh uniform key: the repeats across rows stay, those
    inside one example (one warp of K2) go; padding stays."""
    import torch

    order = keys.sort(dim=1)
    dup = torch.zeros_like(keys, dtype=torch.bool)
    dup[:, 1:] = (order.values[:, 1:] == order.values[:, :-1]) & (order.values[:, 1:] >= 0)
    fresh = torch.randint(0, t, keys.shape, generator=g, device=keys.device,
                          dtype=keys.dtype)
    out = keys.clone()
    out.scatter_(1, order.indices, torch.where(dup, fresh, order.values))
    return out


def repeat_stats(keys) -> dict:
    """How a key plane repeats: its hottest live key's count, and the
    live slots that repeat a key already in their own row."""
    import torch

    live = keys >= 0
    counts = torch.unique(keys[live], return_counts=True)[1]
    srt = keys.sort(dim=1).values
    within = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    return {"hottest_key_occurrences": int(counts.max()),
            "repeats_within_rows": int(within.sum())}


def k2_bounds(keys, x, labels, dim: int) -> dict:
    """K2's least time on this card for THIS batch (csrc/train.cu
    header): keys, x, labels and weights once each; per distinct live
    row, w and v read and g_w and g_v read and written once each
    (``bound_ms``), or whole 32-byte sectors for each of those three
    row accesses (``bound_sector_ms``)."""
    import torch

    b, k = keys.shape
    live = int((keys >= 0).sum())
    rows = int(torch.unique(keys[keys >= 0]).numel())
    stream = b * k * (4 + (4 if x is not None else 0)) + 2 * b * labels.element_size()
    used = stream + rows * 3 * (4 + 4 * dim)
    sectors = stream + rows * 3 * (SECTOR + math.ceil(4 * dim / SECTOR) * SECTOR)
    # per live slot: forward 2 + 4D, backward 2 + 5D (the atomic adds
    # counted as adds); per example: 3D for the pair term, ~30 for the
    # sigmoid, residual and log-loss
    ops = live * (4 + 9 * dim) + b * (3 * dim + 30)
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    used_ms = used / HBM_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(used_ms, ops_ms),
        "bound_by": "bytes" if used_ms >= ops_ms else "operations",
        "bound_sector_ms": max(sectors / HBM_BYTES_PER_S * 1e3, ops_ms),
        "bound_bytes": used, "bound_sector_bytes": sectors, "bound_ops": ops,
        "distinct_rows": rows, "live_slots": live,
    }


def k3_bounds(count: int, ftrl: bool) -> dict:
    """K3's least time: every element's arrays read once and written
    once (FTRL w, n, z, g in and w, n, z, g out; SGD w, g in and out),
    and about 20 (FTRL) or 2 (SGD) float32 operations per element."""
    used = count * 4 * (8 if ftrl else 4)
    ops = count * (20 if ftrl else 2)
    used_ms = used / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(used_ms, ops_ms),
            "bound_by": "bytes" if used_ms >= ops_ms else "operations",
            "bound_bytes": used, "bound_ops": ops}


def phase_train_timings(dev, t_log2: int) -> dict:
    """Phase 9: K2 and K3 device times beside their plain versions,
    their bounds and, where one exists, one PyTorch call computing the
    same function."""
    import torch

    from xflow_tpu_torch.ops.optim import optim_plain, optim_update
    from xflow_tpu_torch.ops.train import train_plain, train_step
    from xflow_tpu_torch.optim import FTRL, SGD

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    t = 1 << t_log2
    w = torch.randn((t, 1), generator=g, device=dev) * 0.3
    v = torch.randn((t, D), generator=g, device=dev) * 0.05
    k2_rows = []
    for mode in ("lr", "fm"):
        vv = v if mode == "fm" else None
        g_w = torch.zeros_like(w)
        g_v = torch.zeros_like(v) if vv is not None else None
        acc = torch.zeros(2, device=dev, dtype=torch.float64)
        for b in TRAIN_BATCHES:
            for keys_name in ("uniform", "zipf", "zipf_row_distinct"):
                zipf = keys_name != "uniform"
                if zipf and b != TRAIN_BATCHES[-1]:
                    continue
                pool = []
                for _ in range(8):  # 8 batches: the key planes exceed L2
                    keys = (zipf_keys((b, K), t, g, dev) if zipf else
                            torch.randint(0, t, (b, K), generator=g, device=dev,
                                          dtype=torch.int32))
                    if keys_name == "zipf_row_distinct":
                        keys = row_distinct(keys, t, g)
                    labels = (torch.rand(b, generator=g, device=dev) > 0.5).to(torch.uint8)
                    pool.append((keys, None, labels, torch.ones_like(labels), float(b),
                                 w, vv, g_w, g_v, acc))
                args = [pool[i % len(pool)] for i in range(TIMED_RUNS)]
                k2_rows.append({
                    "mode": mode, "B": b, "K": K, "D": D if vv is not None else 0,
                    "keys": keys_name,
                    **repeat_stats(pool[0][0]),
                    "ms": time_device_ms(train_step, args),
                    "host_path_ms": time_host_path_ms(train_step, args),
                    "plain_ms": time_device_ms(train_plain, args),
                    **k2_bounds(pool[0][0], None, pool[0][2], D if vv is not None else 0),
                    "library_ms": None,
                    "library_why_null": "no single PyTorch call computes the "
                    "gather, logit, residual, scatter-add and log-loss",
                })
                log(json.dumps(dict(k2_rows[-1], phase=9)))
        del g_w, g_v, acc
    del w, v
    torch.cuda.empty_cache()
    k3_rows = []
    for d in (1, D):
        for opt in (FTRL(), SGD()):
            table = {"param": torch.randn((t, d), generator=g, device=dev) * 0.01,
                     "g": torch.zeros((t, d), device=dev)}
            table.update(opt.init_aux(table["param"]))
            args = [(table, opt)] * TIMED_RUNS
            row = {
                "optimizer": opt.name, "T": t, "D": d,
                "ms": time_device_ms(optim_update, args),
                "host_path_ms": time_host_path_ms(optim_update, args),
                "plain_ms": time_device_ms(optim_plain, args),
                **k3_bounds(t * d, isinstance(opt, FTRL)),
                "library_ms": None,
                "library_why_null": "no single PyTorch call applies the FTRL "
                "recurrence",
            }
            if isinstance(opt, SGD):
                def library(table_, opt_):
                    return table_["param"].add_(table_["g"], alpha=-opt_.lr)

                row["library_ms"] = time_device_ms(library, args)
                row["library_host_path_ms"] = time_host_path_ms(library, args)
                row["library_why_null"] = None
            k3_rows.append(row)
            log(json.dumps(dict(row, phase=9)))
            del table
    return {"k2": k2_rows, "k3": k3_rows}


# ---------------------------------------------------------------------------
# The update modes (phases 10-14): K4 and K5, K2's index mode, and the
# sparse, sequential, microbatch and cold_consolidate training paths

SEQ_MICROBATCH = 128  # B_eff = 512 rows, the docs/CONVERGENCE.md protocol
SLICE_ROWS = 512
K4_REPLACES = (
    "xflow_tpu/ops/sparse.py:62 (B5 consolidate_plan: argsort, segment ids, "
    "ukeys) + xflow_tpu/ops/sparse.py:110 (B5 consolidate_apply, with K2's index "
    "mode) + xflow_tpu/parallel/step.py:923 (_cold_keys_eff) + "
    "xflow_tpu/parallel/step.py:1191 (its caller, _sparse_update); no "
    "pl.pallas_call in the reference"
)
K5_REPLACES = (
    "xflow_tpu/ops/sparse.py:121,126 (B6 gather_rows / scatter_rows) + "
    "xflow_tpu/parallel/step.py:1143 (B6 _apply_touched_rows) + "
    "xflow_tpu/optim/ftrl.py:50 / xflow_tpu/optim/sgd.py:24 (B3 update_rows); "
    "no pl.pallas_call in the reference"
)


def mode_config(model: str, t_log2: int, data: dict, metrics_out: str, **mode):
    """``train_config`` in another update mode."""
    return dataclasses.replace(train_config(model, t_log2, data, metrics_out), **mode)


def expected_launches(mode: dict, steps: int, tables: int, eval_batches: int) -> dict:
    """Each kernel's launches over ``steps`` dispatches of ``mode``
    (xflow_tpu_torch/parallel/step.py's module docstring): K2 once per
    update (per slice in sequential mode, per batch otherwise: dense
    microbatch and cold_consolidate run the plain dense step); K4 with
    each K2 of the touched-rows form, K5 per table after it; K3 per
    table per update of the dense form; K1 per eval batch."""
    update = mode.get("update_mode", "dense")
    s = mode.get("microbatch", 1) if update == "sequential" else 1
    sparse = update == "sparse" or (update == "sequential"
                                    and mode.get("sequential_inner") == "sparse")
    plans = steps * s if sparse else 0
    passes = 0 if sparse else steps * s
    return {"score": eval_batches, "train_step": steps * s, "optim_update": passes * tables,
            "consolidate_keys": plans, "touched_update": plans * tables}


GUARD_SLEEP_CYCLES = 5 * SLEEP_CYCLES  # ~100 ms, 5x a sequential dispatch's host path


def guard_first_dispatch(trainer) -> dict:
    """Check that the trainer's first dispatch never waits for the card.
    It is queued behind a ``torch.cuda._sleep`` and runs under
    ``torch.cuda.set_sync_debug_mode("error")``.  When it returns, the
    sleep must still hold the stream: any host synchronisation inside
    it (which the debug mode, a prototype, may not see) would have
    waited for the sleep to end.  Records the dispatch's host time and
    the sleep's device time."""
    import torch

    inner = trainer.step.dispatch_train
    seen = {"guarded_dispatches": 0}

    def guarded(state, arrays):
        if seen["guarded_dispatches"]:
            return inner(state, arrays)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(GUARD_SLEEP_CYCLES)
        end.record()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            out = inner(state, arrays)
        finally:
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.set_sync_debug_mode(0)
        sleeping = not end.query()
        torch.cuda.synchronize()
        sleep_ms = start.elapsed_time(end)
        if not sleeping:
            raise AssertionError(
                f"the first dispatch waited for the card: it returned after the "
                f"{sleep_ms:.3f} ms sleep ahead of it had ended ({host_ms:.3f} ms on "
                "the host)")
        seen.update(guarded_dispatches=1, dispatch_host_ms=host_ms,
                    sleep_ahead_ms=sleep_ms, returned_while_sleep_held_stream=True)
        return out

    trainer.step.dispatch_train = guarded
    return seen


def run_mode(dev, model: str, t_log2: int, data: dict, init: dict, mode: dict,
             label: str, workdir: str, evaluate: bool = True, keep: bool = False,
             sync_check: bool = False, bars: dict | None = None,
             lockstep: bool = False) -> dict:
    """One update mode's training main path through ``Trainer``: on the
    card from ``init`` (launch counts zeroed just before, read just after,
    and held to ``expected_launches``), then the same steps on the CPU
    from the same state, held to TRAIN_BOUNDS.  With ``lockstep`` (the
    sequential path, whose many passes meet FTRL's n' == 0
    discontinuity) the tables are held to TRAIN_BOUNDS by
    ``lockstep_tables`` over the shipped batches instead, and the two
    runs' tables are reported.  Returns the row, the card's trainer and,
    with ``keep``, the batches it shipped."""
    import os

    import torch

    from xflow_tpu_torch.convert import state_from_numpy
    from xflow_tpu_torch.trainer import Trainer

    cfg = mode_config(model, t_log2, data, os.path.join(workdir, f"{model}-{label}.jsonl"),
                      **mode)
    zero_launches()
    # the main path starts here
    trainer = Trainer(cfg, device=dev, log=log)
    trainer.state = state_from_numpy(cfg, init, dev)
    shipped = keep_shipped_batches(trainer) if keep else None
    guard = guard_first_dispatch(trainer) if sync_check else None
    t0 = time.perf_counter()
    history = trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    result = trainer.evaluate() if evaluate else None
    torch.cuda.synchronize()
    got = read_launches()
    # ... and ends here
    trainer.close()
    steps = sum(h["steps"] for h in history)
    tables = len(trainer.state["tables"])
    want = expected_launches(mode, steps, tables,
                             math.ceil(TEST_LINES / cfg.batch_size) if evaluate else 0)
    if got != want:
        raise AssertionError(f"{model} {label}: launches {got}, expected {want}")
    if any("g" in t for t in trainer.state["tables"].values()) == trainer.step.sparse:
        raise AssertionError(f"{model} {label}: a [T, D] gradient buffer in a sparse "
                             "state, or none in a dense one")
    if guard is not None and guard["guarded_dispatches"] != 1:
        raise AssertionError(f"{model} {label}: the sync guard saw no dispatch")
    if evaluate and bars is not None and not bars["floor"] < result["auc"] < bars["bayes_auc"]:
        raise AssertionError(f"{model} {label}: eval AUC {result['auc']} outside the "
                             f"planted signal's bars {bars}")

    cpu = Trainer(dataclasses.replace(cfg, metrics_out=""), device="cpu",
                  log=lambda _: None)
    cpu.state = state_from_numpy(cfg, init, "cpu")
    t0 = time.perf_counter()
    cpu_history = cpu.train()
    cpu_s = time.perf_counter() - t0
    cpu_result = cpu.evaluate() if evaluate else None
    cpu.close()
    if len(trainer.step_logloss) != len(cpu.step_logloss):
        raise AssertionError(f"{model} {label}: step counts differ")
    for a, b in zip(trainer.step_logloss, cpu.step_logloss):
        if abs(a - b) > TRAIN_BOUNDS["logloss_rtol"] * max(abs(b), 1.0):
            raise AssertionError(f"{model} {label}: step log-loss {a} on the card vs "
                                 f"{b} on the CPU")
    if evaluate and (abs(result["auc"] - cpu_result["auc"]) > TRAIN_BOUNDS["auc_atol"] or abs(
            result["logloss"] - cpu_result["logloss"]) > TRAIN_BOUNDS["logloss_rtol"] * abs(
            cpu_result["logloss"])):
        raise AssertionError(f"{model} {label}: eval on the card {result} vs CPU {cpu_result}")
    occ = row_occurrences(shipped, cfg.table_size) if keep else None
    state_cmp = compare_states(trainer.state, cpu.state, occ, gate=not lockstep)
    if lockstep:
        t0 = time.perf_counter()
        state_cmp["lockstep"] = lockstep_tables(trainer.step, cfg, init, shipped)
        state_cmp["lockstep"]["seconds"] = time.perf_counter() - t0
    row = {
        "model": model, "mode": label, "config": mode, "steps": steps, "tables": tables,
        "launches": got, "train_seconds": train_s, "cpu_train_seconds": cpu_s,
        "examples_per_sec": [h["examples_per_sec"] for h in history],
        "step_time_p50": [h["step_time_p50"] for h in history],
        "phases": [{k: p.get(k, 0.0) for k in ("input_stall", "h2d", "dispatch",
                                                "device_block")}
                   for p in (h["phases"] for h in history)],
        "train_logloss": [h["train_logloss"] for h in history],
        "cpu_train_logloss": [h["train_logloss"] for h in cpu_history],
        **state_cmp,
    }
    if guard is not None:
        row.update(guard, sync_debug_mode="error")
    if evaluate:
        row["eval"] = {k: result[k] for k in ("auc", "logloss", "examples")}
        row["cpu_eval"] = {k: cpu_result[k] for k in ("auc", "logloss")}
    del cpu
    return {"row": row, "trainer": trainer, "shipped": shipped}


def new_plan(keys, dev):
    import torch

    m = keys.numel()
    return (torch.empty(m, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.empty_like(keys))


def check_k4(case: str, keys, t: int, slot_map, worst: dict):
    """K4 against its plain version: the same count and key set (the
    kernel's unique keys in claim order, the plain version's sorted, so
    the kernel's slots are a permutation of the plain version's), every
    live occurrence's slot holding its own key, padding -1.  Books what
    it measured in ``worst``: each property, and the largest |ukeys[slot]
    - key| over the live occurrences (0 when every slot holds its own
    key).  Returns both plans and the count (read on the host, outside
    any timed path)."""
    import torch

    from xflow_tpu_torch.ops.sparse import consolidate_keys, consolidate_keys_plain

    kern, plain = new_plan(keys, keys.device), new_plan(keys, keys.device)
    consolidate_keys(keys, t, *kern, slot_map)
    consolidate_keys_plain(keys, t, *plain)
    torch.cuda.synchronize()
    n, pn = int(kern[1]), int(plain[1])
    live = keys >= 0
    want = int(torch.unique(keys[live]).numel())
    sl = kern[2][live].long()
    in_range = not n or (int(sl.min()) >= 0 and int(sl.max()) < n)
    err = (float((kern[0][sl.clamp(0, max(n - 1, 0))] - keys[live]).abs().max())
           if n else 0.0)
    got = {"count_equal": n == pn == want,
           "key_set_equal": torch.equal(torch.sort(kern[0][:n]).values, plain[0][:n]),
           "slots_hold_own_key": in_range and err == 0.0,
           "padding_slots_minus_one": not bool((kern[2][~live] != -1).any())}
    worst["cases"] += 1
    worst["max_abs_err_slot_key"] = max(worst["max_abs_err_slot_key"], err)
    for k, ok in got.items():
        worst[k] = worst[k] and ok
    if not all(got.values()):
        raise AssertionError(f"K4 {case}: {got} (count {n}, plain {pn}, distinct live "
                             f"keys {want}, max |ukeys[slot] - key| {err})")
    return kern, plain, n


def check_k2_index(case, keys, labels, weights, num_real, w, v, kern, plain, n, worst):
    """K2 in index mode (slots from K4) against its plain version (slots
    from the plain plan): each unique key's summed gradients within the
    sum of its occurrences' k2_tolerances (the dense check's per-row
    bound: the same terms, summed into one row); log-loss sum within
    its bound, count exact.  Returns the kernel's gsum."""
    import torch

    from xflow_tpu_torch.ops.train import train_plain, train_step

    m = keys.numel()
    outs = []
    for fn, plan in ((train_step, kern), (train_plain, plain)):
        g_w = torch.zeros((m, 1), device=keys.device)
        g_v = torch.zeros((m, v.shape[1]), device=keys.device) if v is not None else None
        acc = torch.zeros(2, device=keys.device, dtype=torch.float64)
        fn(keys, None, labels, weights, num_real, w, v, g_w, g_v, acc, slots=plan[2])
        outs.append((g_w, g_v, acc))
    torch.cuda.synchronize()
    tol_w, tol_v, tol_ll = k2_tolerances(keys, None, labels, weights, num_real, w, v)
    ukeys = kern[0][:n].long()
    pos = torch.searchsorted(plain[0][:n], kern[0][:n])  # plain slot of each key
    pairs = [(outs[0][0], outs[1][0], tol_w)]
    if v is not None:
        pairs.append((outs[0][1], outs[1][1], tol_v))
    for got, want, tol in pairs:
        diff = (got[:n].double() - want[pos].double()).abs()
        bound = tol[ukeys]
        excess = float((diff - bound).max()) if n else 0.0
        if excess > 0 or not bool(torch.isfinite(got[:n]).all()):
            raise AssertionError(f"K2 index mode disagrees with train_plain: {case} "
                                 f"excess {excess}")
        if n:
            worst["max_abs_err_g"] = max(worst["max_abs_err_g"], float(diff.max()))
            ratio = diff / torch.where(bound > 0, bound, 1.0)
            worst["max_err_over_tol"] = max(worst["max_err_over_tol"], float(ratio.max()))
        if bool(got[n:].any()):
            raise AssertionError(f"K2 index mode wrote past the {n} slots: {case}")
    acc, pacc = outs[0][2], outs[1][2]
    if abs(float(acc[0]) - float(pacc[0])) > tol_ll or float(acc[1]) != float(pacc[1]):
        raise AssertionError(f"K2 index mode log-loss/count {acc.tolist()} vs plain "
                             f"{pacc.tolist()} ({case})")
    return outs[0][0], outs[0][1]


def check_k5(case: str, tables: dict, opt, ukeys, count, n: int, gsum, slot_map,
             worst: dict) -> None:
    """K5 against its plain version on ``tables`` (copies the caller
    made: param plus aux) with ``gsum``.  For
    FTRL it plants rows with g = 0 and n = 0 (never touched: w kept
    exactly) and rows with w = 0 and z = +-lambda1 - g (|z'| at lambda1);
    the touched rows are held to phase 7's elementwise bounds
    (k3_tolerances); every other row must be
    bit-identical, gsum[:count] cleared, and the slot map (when given)
    back at -1."""
    import torch

    from xflow_tpu_torch.ops.sparse import touched_plain, touched_update
    from xflow_tpu_torch.optim import FTRL

    gsum = gsum.clone()
    rows = ukeys[:n].long()
    if isinstance(opt, FTRL):
        gsum[0:n:8] = 0.0
        tables["n"][rows[0::8]] = 0.0
        near = rows[4::8]
        sgn = torch.where(torch.arange(near.numel(), device=rows.device) % 2 == 0, 1.0, -1.0)
        tables["param"][near] = 0.0
        tables["z"][near] = sgn[:, None] * opt.lambda1 - gsum[4:n:8]
    g_in = gsum[:n].clone()
    before = {k: a.clone() for k, a in tables.items()}
    plain = {k: a.clone() for k, a in tables.items()}
    g_plain = gsum.clone()
    touched_update(tables, opt, ukeys, count, gsum, slot_map)
    touched_plain(plain, opt, ukeys, count, g_plain)
    torch.cuda.synchronize()
    mask = torch.zeros(before[next(iter(before))].shape[0], dtype=torch.bool,
                       device=rows.device)
    mask[rows] = True
    for k in tables:
        if not torch.equal(tables[k][~mask], before[k][~mask]):
            raise AssertionError(f"K5 {case}: a row outside ukeys changed ({k})")
    if n:
        rows_before = {k: a[rows] for k, a in before.items()}
        rows_before["g"] = g_in
        tols = k3_tolerances(rows_before, plain["n"][rows] if "n" in plain else None, opt)
        for k, tol in tols.items():
            diff = (tables[k][rows] - plain[k][rows]).abs()
            excess = float((diff - tol).max())
            if excess > 0:
                raise AssertionError(f"K5 {case} {opt.name} {k}: excess {excess}")
            worst["max_abs_err"] = max(worst["max_abs_err"], float(diff.max()))
            ratio = diff / torch.where(tol > 0, tol, 1.0)
            worst["max_err_over_tol"] = max(worst["max_err_over_tol"], float(ratio.max()))
        if isinstance(opt, FTRL):
            kept = rows[0::8]
            if not torch.equal(tables["param"][kept], before["param"][kept]):
                raise AssertionError(f"K5 {case}: w moved on a row with g = 0, n = 0")
            worst["never_touched_rows"] += int(kept.numel())
            zn = plain["z"][rows].abs()
            worst["near_lambda1"] += int(((zn - opt.lambda1).abs() <= tols["z"]).sum())
    if bool(gsum[:n].any()):
        raise AssertionError(f"K5 {case}: gsum not cleared")
    if slot_map is not None and bool((slot_map != -1).any()):
        raise AssertionError(f"K5 {case}: the slot map was not restored")


def phase_sparse_kernel_checks(model: str, trainer, arrays: dict, worst: dict) -> list:
    """Phase 10: K4, K2's index mode and K5 against their plain versions
    on the sparse main path's own first batch (B = 65,536, on its trained
    tables, after its run) and on cases made from it: its first 512 rows
    (a slice), 512 rows of padding, the batch with one key in every row,
    and the batch with its live keys made uniform over T.  K5 runs FTRL
    (the path's optimizer) on every table, and SGD on the widest, in the
    main-path case."""
    import torch

    from xflow_tpu_torch.optim import FTRL, SGD

    tables = trainer.state["tables"]
    w = tables["w"]["param"]
    v = tables["v"]["param"] if "v" in tables else None
    t, dev = w.shape[0], w.device
    keys, labels, weights = arrays["ckeys"], arrays["labels_u8"], arrays["weights_u8"]
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    live = keys >= 0
    one_key = keys.clone()
    one_key[:, 0] = 4242
    uniform = torch.where(live, torch.randint(0, t, keys.shape, generator=g, device=dev,
                                              dtype=torch.int32), -1).contiguous()
    first = slice(0, SLICE_ROWS)
    cases = [
        ("main_path", keys, labels, weights),
        ("slice_512", keys[first], labels[first], weights[first]),
        ("all_padding_512", torch.full_like(keys[first], -1), labels[first], weights[first]),
        ("one_key_every_row", one_key, labels, weights),
        ("uniform", uniform, labels, weights),
    ]
    slot_map = torch.full((t,), -1, dtype=torch.int32, device=dev)
    opt = trainer.step.optimizer
    names = list(tables)
    stats = []
    for case, kk, lab, wt in cases:
        label = f"{model} {case}"
        num_real = max(float(wt.float().sum()), 1.0)
        kern, plain, n = check_k4(label, kk, t, slot_map, worst["k4"])
        gw, gv = check_k2_index(label, kk, lab, wt, num_real, w, v, kern, plain, n,
                                worst["k2_index"])
        forms = [(name, opt) for name in names]
        if case == "main_path":
            forms += [(names[-1], SGD())]
        for i, (name, form) in enumerate(forms):
            if isinstance(form, FTRL):
                copy = {k: tables[name][k].clone() for k in ("param", "n", "z")}
            else:
                copy = {"param": tables[name]["param"].clone()}
            check_k5(f"{label} {name}", copy, form, kern[0], kern[1], n,
                     gw if name == "w" else gv,
                     slot_map if i == len(forms) - 1 else None, worst["k5"])
            del copy
        kl = kk[kk >= 0]
        stats.append({"model": model, "case": case, "rows": kk.shape[0],
                      "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
                      "live_slots": int(kl.numel()), "unique_keys": n,
                      "hottest_key_occurrences":
                          int(torch.unique(kl, return_counts=True)[1].max()) if n else 0})
        del kern, plain, gw, gv
    return stats


def k4_bounds(m: int, n: int) -> dict:
    """K4's least time: the keys read and the slots written once (8 B
    per occurrence), the unique keys and the count written once; at
    32-byte sectors, also each distinct key's map entry claimed and read
    back (a sector each way).  About 6 operations per occurrence."""
    used = 8 * m + 4 * n + 4
    sectors = used + 2 * SECTOR * n
    ops = 6 * m
    used_ms = used / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(used_ms, ops_ms),
            "bound_by": "bytes" if used_ms >= ops_ms else "operations",
            "bound_sector_ms": max(sectors / HBM_BYTES_PER_S * 1e3, ops_ms),
            "bound_bytes": used, "bound_sector_bytes": sectors, "bound_ops": ops}


def k5_bounds(ukeys, n: int, d: int, form: str) -> dict:
    """K5's least time for these rows: FTRL reads w, n, z and the gsum
    row and writes w, n, z (28 D B per row), SGD reads and writes one
    array and reads gsum (12 D B), plus the 4-byte key; at
    32-byte sectors each row access moves every sector its 4D bytes at
    offset 4 D r touch.  About 20 (FTRL) or 2 operations per element."""
    arrays = 3 if form == "ftrl" else 1
    used = 4 * n + 4 * d * n * (2 * arrays + 1)
    offs = ukeys[:n].long() * (4 * d)
    span = int((((offs + 4 * d - 1) // SECTOR) - offs // SECTOR + 1).sum()) * SECTOR
    sectors = 4 * n + 4 * d * n + 2 * arrays * span
    ops = n * d * (20 if form == "ftrl" else 2)
    used_ms = used / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(used_ms, ops_ms),
            "bound_by": "bytes" if used_ms >= ops_ms else "operations",
            "bound_sector_ms": max(sectors / HBM_BYTES_PER_S * 1e3, ops_ms),
            "bound_bytes": used, "bound_sector_bytes": sectors, "bound_ops": ops}


def sparse_kernel_timings(model: str, trainer, keys, labels, weights, num_real,
                          label: str) -> list:
    """K4, K2 in index mode and K5 (FTRL, every table) on one key plane
    of a sparse main path, after its run, on copies of its trained
    tables: device ms behind ``_sleep`` (60 launches), the plain
    versions' ms, the bounds, and for K4 ``torch.unique(...,
    return_inverse=True)`` as the library call (timed on the host path:
    it synchronises to size its output).  K4's calls each start from a
    cleared slot map (the clear is outside the timed events); K2's and
    K5's each behind an L2 flush, as in the run."""
    import torch

    from xflow_tpu_torch.ops.sparse import (
        consolidate_keys,
        consolidate_keys_plain,
        touched_plain,
        touched_update,
    )
    from xflow_tpu_torch.ops.train import train_plain, train_step

    # the checks' float64 temporaries stay cached in the allocator; give
    # them back, so no timed call waits on a cudaMalloc that frees the
    # cache first (a synchronising retry)
    torch.cuda.empty_cache()
    tables = trainer.state["tables"]
    w = tables["w"]["param"]
    v = tables["v"]["param"] if "v" in tables else None
    t, dev = w.shape[0], w.device
    m = keys.numel()
    slot_map = torch.full((t,), -1, dtype=torch.int32, device=dev)
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)  # 128 MiB > L2
    plan, pplan = new_plan(keys, dev), new_plan(keys, dev)
    runs = [(keys, t, *plan, slot_map)] * TIMED_RUNS
    k4 = {"ms": time_device_ms(consolidate_keys, runs, prelude=lambda: slot_map.fill_(-1)),
          "host_path_ms": None,
          "plain_ms": time_device_ms(consolidate_keys_plain, [(keys, t, *pplan)] * TIMED_RUNS)}
    flat = keys.reshape(-1)

    def unique_inverse(k):
        return torch.unique(k, sorted=True, return_inverse=True)

    k4["library_ms"] = time_host_path_ms(unique_inverse, [(flat,)] * TIMED_RUNS)
    slot_map.fill_(-1)
    consolidate_keys(keys, t, *plan, slot_map)
    torch.cuda.synchronize()
    n = int(plan[1])
    rows = [dict(k4, kernel="consolidate_keys", model=model, path=label, M=m, U=n,
                 **k4_bounds(m, n),
                 library_call="torch.unique(keys, sorted=True, return_inverse=True)")]
    gw = torch.zeros((m, 1), device=dev)
    gv = torch.zeros((m, v.shape[1]), device=dev) if v is not None else None
    acc = torch.zeros(2, device=dev, dtype=torch.float64)

    def k2_index(slots):
        train_step(keys, None, labels, weights, num_real, w, v, gw, gv, acc, slots=slots)

    def k2_index_plain(slots):
        train_plain(keys, None, labels, weights, num_real, w, v, gw, gv, acc, slots=slots)

    dim = v.shape[1] if v is not None else 0
    b2 = k2_bounds(keys, None, labels, dim)
    stream = 4 * m  # the slot plane
    rows.append({
        "kernel": "train_step (index mode)", "model": model, "path": label, "M": m, "U": n,
        "ms": time_device_ms(k2_index, [(plan[2],)] * TIMED_RUNS, prelude=flush.zero_),
        "plain_ms": time_device_ms(k2_index_plain, [(plan[2],)] * TIMED_RUNS,
                                   prelude=flush.zero_),
        **dict(b2, bound_bytes=b2["bound_bytes"] + stream,
               bound_sector_bytes=b2["bound_sector_bytes"] + stream,
               bound_ms=max((b2["bound_bytes"] + stream) / HBM_BYTES_PER_S * 1e3,
                            b2["bound_ops"] / FP32_FLOPS_PER_S * 1e3),
               bound_sector_ms=max((b2["bound_sector_bytes"] + stream) / HBM_BYTES_PER_S
                                   * 1e3, b2["bound_ops"] / FP32_FLOPS_PER_S * 1e3)),
        "library_ms": None,
        "library_why_null": "no single PyTorch call computes the gather, logit, residual, "
        "per-key scatter-add and log-loss",
    })
    opt = trainer.step.optimizer
    for name, gsum in (("w", gw), ("v", gv)):
        if gsum is None:
            continue
        copy = {k: tables[name][k].clone() for k in ("param", "n", "z")}
        args = [(copy, opt, plan[0], plan[1], gsum, None)] * TIMED_RUNS
        rows.append({
            "kernel": "touched_update", "model": model, "path": label, "table": name,
            "optimizer": opt.name, "U": n, "D": gsum.shape[1],
            "ms": time_device_ms(touched_update, args, prelude=flush.zero_),
            # about 65 launches a call: 4 calls per sleep stay well
            # inside the card's queue of pending launches
            "plain_ms": time_device_ms(touched_plain, [a[:5] for a in args],
                                       prelude=flush.zero_, chunk_size=4),
            **k5_bounds(plan[0], n, gsum.shape[1], opt.name),
            "library_ms": None,
            "library_why_null": "no single PyTorch call applies FTRL to gathered rows",
        })
        del copy
    for row in rows:
        log(json.dumps(dict(row, phase=14)))
    del flush, slot_map, gw, gv
    return rows


def single_shard(data: dict, workdir: str) -> dict:
    """``data`` cut to its first train shard (one dispatch per epoch)."""
    import os

    root = os.path.join(workdir, "one")
    os.makedirs(root, exist_ok=True)
    prefix = os.path.join(root, os.path.basename(data["train"]))
    os.symlink(f"{data['train']}-00000", f"{prefix}-00000")
    return {"train": prefix, "test": data["test"]}


def phase_update_modes(dev, t_log2: int, workdir: str, dense: dict) -> dict:
    """Phases 10-14 for FM and LR: the sparse main path (phase 11: card
    against CPU and against phase 8's dense card run from the same
    initial state), K4/K2-index/K5 against their plain versions on its
    batches (phase 10), sequential with the sparse inner at microbatch
    128 (phase 12: card against CPU, one dispatch under the sync guard),
    one dispatch each of dense microbatch 4 and cold_consolidate (the
    plain dense step) and the sequential dense inner (phase 13), and the
    kernels' times on the
    sparse and sequential paths' own inputs (phase 14)."""
    import torch

    from xflow_tpu_torch.convert import state_from_numpy

    data, bars = dense["data"], dense["bars"]
    one = single_shard(data, workdir)
    worst = {"k4": {"cases": 0, "max_abs_err_slot_key": 0.0, "count_equal": True,
                    "key_set_equal": True, "slots_hold_own_key": True,
                    "padding_slots_minus_one": True},
             "k2_index": {"max_abs_err_g": 0.0, "max_err_over_tol": 0.0},
             "k5": {"max_abs_err": 0.0, "max_err_over_tol": 0.0,
                    "never_touched_rows": 0, "near_lambda1": 0}}
    out = {"rows": [], "checks": [], "timings": [], "worst": worst,
           "launches": dict.fromkeys(KERNEL_WRAPPERS, 0), "launches_by_path": {}}

    def book(run):
        row = run["row"]
        for k, n in row["launches"].items():
            out["launches"][k] += n
        out["launches_by_path"][f"{row['model']} {row['mode']}"] = row["launches"]
        out["rows"].append(row)
        log(json.dumps(row))

    for model in ("fm", "lr"):
        init = dense["inits"][model]
        run = run_mode(dev, model, t_log2, data, init, {"update_mode": "sparse"}, "sparse",
                       workdir, keep=True, bars=bars)
        cfg = mode_config(model, t_log2, data, "")
        run["row"]["vs_dense_card"] = compare_states(
            run["trainer"].state, state_from_numpy(cfg, dense["finals"][model], "cpu"))
        run["row"]["phase"] = 11
        arrays = run["shipped"][0]
        out["checks"] += phase_sparse_kernel_checks(model, run["trainer"], arrays, worst)
        first = slice(0, SLICE_ROWS)
        timings = sparse_kernel_timings(
            model, run["trainer"], arrays["ckeys"], arrays["labels_u8"],
            arrays["weights_u8"], arrays["num_real"], "sparse main path")
        timings += sparse_kernel_timings(
            model, run["trainer"], arrays["ckeys"][first], arrays["labels_u8"][first],
            arrays["weights_u8"][first],
            max(float(arrays["weights_u8"][first].float().sum()), 1.0),
            "sparse main path, first 512 rows")
        run["row"]["device_busy_s_from_kernel_times"] = busy = run["row"]["steps"] * sum(
            r["ms"] for r in timings if r["path"] == "sparse main path") / 1e3
        run["row"]["device_idle_share_from_kernel_times"] = 1.0 - busy / run["row"]["train_seconds"]
        out["timings"] += timings
        book(run)
        del run, arrays
        torch.cuda.empty_cache()

        seq = {"update_mode": "sequential", "microbatch": SEQ_MICROBATCH,
               "sequential_inner": "sparse"}
        run = run_mode(dev, model, t_log2, data, init, seq, "sequential_sparse_mb128",
                       workdir, keep=True, sync_check=True, bars=bars, lockstep=True)
        run["row"]["phase"] = 12
        arrays = run["shipped"][0]
        rows = arrays["ckeys"].shape[0] // SEQ_MICROBATCH
        timings = sparse_kernel_timings(
            model, run["trainer"], arrays["ckeys"][:rows], arrays["labels_u8"][:rows],
            arrays["weights_u8"][:rows], arrays["slice_num_real"][0],
            "sequential main path, slice 0")
        slices = run["row"]["steps"] * SEQ_MICROBATCH
        run["row"]["device_busy_s_from_kernel_times"] = busy = slices * sum(
            r["ms"] for r in timings) / 1e3
        run["row"]["device_idle_share_from_kernel_times"] = 1.0 - busy / run["row"]["train_seconds"]
        run["row"]["auc_bars"] = bars
        run["row"]["bayes_gap_closed"] = (run["row"]["eval"]["auc"] - 0.5) / (
            bars["bayes_auc"] - 0.5)
        out["timings"] += timings
        book(run)
        del run, arrays
        torch.cuda.empty_cache()

        for label, mode in (
            ("dense_mb4", {"microbatch": 4}),
            ("cold_consolidate", {"cold_consolidate": True}),
            ("sequential_dense_mb4", {"update_mode": "sequential", "microbatch": 4}),
        ):
            run = run_mode(dev, model, t_log2, one, init, dict(mode, epochs=1), label,
                           workdir, evaluate=False)
            run["row"]["phase"] = 13
            book(run)
            del run
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The sequential path's float32 drift (``--seq-witness RUNS``)

def replay_float64(cfg, init: dict, shipped: list) -> dict:
    """The sequential sparse inner replayed on the CPU in float64 over
    the batches a run shipped, from ``init``: per slice the plain plan,
    ``train_plain`` into float64 ``gsum`` and ``touched_plain``, as
    ``TrainStep`` runs them in float32.  Returns the float64 tables."""
    import torch

    from xflow_tpu_torch.convert import state_from_numpy
    from xflow_tpu_torch.ops.sparse import consolidate_keys_plain, touched_plain
    from xflow_tpu_torch.ops.train import train_plain
    from xflow_tpu_torch.optim import make_optimizer

    opt = make_optimizer(cfg)
    state = state_from_numpy(cfg, init, "cpu")
    tables = {n: {k: a.double() for k, a in t.items() if k != "g"}
              for n, t in state["tables"].items()}
    del state
    s = cfg.microbatch
    for arrays in shipped:
        planes = {k: a.cpu() for k, a in arrays.items() if isinstance(a, torch.Tensor)}
        rows = planes["ckeys"].shape[0] // s
        for j, num_real in enumerate(arrays["slice_num_real"]):
            view = {k: a[j * rows:(j + 1) * rows] for k, a in planes.items()}
            keys = view["ckeys"]
            m = keys.numel()
            ukeys = torch.empty(m, dtype=torch.int32)
            count = torch.zeros(1, dtype=torch.int32)
            slots = torch.empty_like(keys)
            consolidate_keys_plain(keys, cfg.table_size, ukeys, count, slots)
            gsum = {n: torch.zeros((m, t["param"].shape[1]), dtype=torch.float64)
                    for n, t in tables.items()}
            acc = torch.zeros(2, dtype=torch.float64)
            v = tables["v"]["param"] if "v" in tables else None
            train_plain(keys, None, view["labels_u8"], view["weights_u8"], num_real,
                        tables["w"]["param"], v, gsum["w"], gsum.get("v"), acc,
                        slots=slots)
            for n in tables:
                touched_plain(tables[n], opt, ukeys, count, gsum[n])
    return tables


def drift_report(card: dict, cpu: dict, exact: dict, occ) -> dict:
    """Per table array: the largest ratio of |card - cpu|, |card -
    exact| and |cpu - exact| to TRAIN_BOUNDS' table terms (taken at the
    CPU's, or the exact run's, values), and the card-vs-CPU worst
    element: its values in the three runs, its FTRL state on the CPU
    (|z| over lambda1, n), and how often its row occurs in the run's
    batches."""
    import torch

    from xflow_tpu_torch.optim import FTRL

    l1 = FTRL().lambda1

    def base(a):
        return (TRAIN_BOUNDS["table_rtol"] * a.abs()
                + TRAIN_BOUNDS["table_atol_frac"] * float(a.abs().max()))

    out = {}
    for name, table in cpu.items():
        for key, p in table.items():
            c, e = card[name][key].double(), exact[name][key].to(p.device)
            p = p.double()
            r_cp = (c - p).abs() / base(p).clamp(min=1e-30)
            i = int(torch.argmax(r_cp))
            row, col = divmod(i, p.shape[1])
            r_ce = (c - e).abs() / base(e).clamp(min=1e-30)
            r_pe = (p - e).abs() / base(e).clamp(min=1e-30)
            out[f"{name}.{key}"] = {
                "card_vs_cpu": float(r_cp.max()), "card_vs_exact": float(r_ce.max()),
                "cpu_vs_exact": float(r_pe.max()),
                "elements_over_1": {"card_vs_cpu": int((r_cp > 1).sum()),
                                    "card_vs_exact": int((r_ce > 1).sum()),
                                    "cpu_vs_exact": int((r_pe > 1).sum())},
                "worst": {"row": row, "col": col, "card": float(c[row, col]),
                          "cpu": float(p[row, col]), "exact": float(e[row, col]),
                          "ratio": float(r_cp[row, col]),
                          "card_vs_exact_ratio": float(r_ce[row, col]),
                          "cpu_vs_exact_ratio": float(r_pe[row, col]),
                          "atol_term": TRAIN_BOUNDS["table_atol_frac"] * float(p.abs().max()),
                          "cpu_z_over_lambda1": float(cpu[name]["z"][row, col]) / l1
                          if "z" in cpu[name] else None,
                          "cpu_n": float(cpu[name]["n"][row, col]) if "n" in cpu[name] else None,
                          "row_occurrences": int(occ[row])},
            }
    return out


def seq_witness(dev, t_log2: int, workdir: str, runs: int) -> dict:
    """The sequential sparse path (phase 12's configuration) for FM and
    LR: once through ``Trainer`` on the card, keeping the batches it
    shipped, then ``runs`` - 1 more times on the card from the same
    initial state over the same batches (``TrainStep.train``), once on
    the CPU in float32 (``TrainStep`` over the same batches) and once
    in float64 (``replay_float64``, the witness).  Each card run is held
    against the CPU run and against the float64 run (``drift_report``),
    and so is the CPU run: how far the float32 runs drift from exact
    arithmetic, and how far apart that puts the card and the CPU."""
    import torch

    from xflow_tpu_torch.convert import state_from_numpy, state_to_numpy
    from xflow_tpu_torch.parallel.step import TrainStep
    from xflow_tpu_torch.trainer import Trainer

    data = write_train_shards(workdir)
    seq = {"update_mode": "sequential", "microbatch": SEQ_MICROBATCH,
           "sequential_inner": "sparse"}
    out = {}
    for model in ("fm", "lr"):
        cfg = mode_config(model, t_log2, data, "", **seq)
        trainer = Trainer(cfg, device=dev, log=lambda _: None)
        init = state_to_numpy(trainer.state, aux=True)
        shipped = keep_shipped_batches(trainer)
        trainer.train()
        torch.cuda.synchronize()
        trainer.close()
        occ = row_occurrences(shipped, cfg.table_size)
        t0 = time.perf_counter()
        cpu_step = TrainStep(trainer.step.model, trainer.step.optimizer, cfg,
                             torch.device("cpu"))
        cpu_state = state_from_numpy(cfg, init, "cpu")
        for arrays in shipped:
            cpu_step.train(cpu_state, {k: a.cpu() if isinstance(a, torch.Tensor) else a
                                       for k, a in arrays.items()})
        cpu = {n: {k: a for k, a in tb.items() if k != "g"}
               for n, tb in cpu_state["tables"].items()}
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        exact = replay_float64(cfg, init, shipped)
        exact_s = time.perf_counter() - t0
        cpu_d = {n: {k: a.to(dev) for k, a in tb.items()} for n, tb in cpu.items()}
        exact_d = {n: {k: a.to(dev) for k, a in tb.items()} for n, tb in exact.items()}
        reports = [drift_report(trainer.state["tables"], cpu_d, exact_d, occ)]
        log(json.dumps({"witness": model, "run": 0, "report": reports[0]}))
        first = {n: {k: a.clone() for k, a in tb.items()}
                 for n, tb in trainer.state["tables"].items()}
        for r in range(1, runs):
            state = state_from_numpy(cfg, init, dev)
            for arrays in shipped:
                trainer.step.train(state, arrays)
            rep = drift_report(state["tables"], cpu_d, exact_d, occ)
            rep["card_vs_card_run0"] = {
                f"{n}.{k}": float(((state["tables"][n][k] - a).abs()
                                   / (TRAIN_BOUNDS["table_rtol"] * a.abs()
                                      + TRAIN_BOUNDS["table_atol_frac"]
                                      * float(a.abs().max())).clamp(min=1e-30)).max())
                for n, tb in first.items() for k, a in tb.items() if k != "g"}
            reports.append(rep)
            log(json.dumps({"witness": model, "run": r, "report": rep}))
            del state
        keys = list(reports[0])
        summary = {k: {m: max(rep[k][m] for rep in reports)
                       for m in ("card_vs_cpu", "card_vs_exact", "cpu_vs_exact")}
                   for k in keys}
        out[model] = {"runs": runs, "cpu_replay_s": cpu_s, "float64_replay_s": exact_s,
                      "max_over_runs": summary,
                      "card_vs_cpu_per_run": [max(rep[k]["card_vs_cpu"] for k in keys)
                                              for rep in reports]}
        log(json.dumps({"witness_summary": model, **out[model]}))
        del trainer, shipped, cpu_state, cpu, exact, cpu_d, exact_d, first
        torch.cuda.empty_cache()
    return out


def split_tolerance(name: str, view: dict, num_real: float, uk, before: dict):
    """Phase 6's per-row bound on K2's summed gradients (k2_tolerances),
    for the slice ``view`` over the tables as they were before it,
    gathered at the slice's sorted unique keys ``uk``: the [U, width]
    tolerances of table ``name``."""
    import torch

    keys = view["ckeys"]
    local = torch.where(keys >= 0, torch.searchsorted(uk, keys.long().clamp(min=0)),
                        torch.full_like(keys.long(), -1)).to(torch.int32)
    v = before["v"]["param"] if "v" in before else None
    tol_w, tol_v, _ = k2_tolerances(local, None, view["labels_u8"], view["weights_u8"],
                                    num_real, before["w"]["param"], v)
    return tol_w if name == "w" else tol_v


def lockstep_tables(card_step, cfg, init: dict, shipped: list, synchronize: bool = True,
                    records: int = 6) -> dict:
    """Replay the sequential batches ``shipped`` from ``init`` on the
    card (``card_step``, the main path's TrainStep) and on the CPU in
    lockstep, slice by slice, each side through ``TrainStep._update``
    (the per-slice update the main path runs), and compare the rows each
    slice touched.

    FTRL keeps w's init where n' == 0 (the reference's lazy init), so an
    element's update is discontinuous where its first gradient is 0:
    when one side's float32 gradient is exactly 0 and the other's is not
    (a tiny term absorbed by the larger v in one summation order and not
    in the other), one side keeps w's init and the other zeroes it, and
    that difference then reaches every row the element shares an example
    with.  Such a split is verified as rounding: n was 0 before on both
    sides, and the nonzero side's gradient (sqrt(n')) lies within phase
    6's bound on K2's sum (``split_tolerance``).  With ``synchronize``
    the CPU then takes the card's state at that element, and the final
    tables are held to TRAIN_BOUNDS (``compare_states``); a split that
    fails the verification raises.  Without it the run goes on unsynced
    and nothing is held (the diagnostic).  Records the first ``records``
    splits, and elements whose z moved apart by more than half of
    TRAIN_BOUNDS' terms in one slice."""
    import torch

    from xflow_tpu_torch.convert import state_from_numpy
    from xflow_tpu_torch.parallel.step import TrainStep

    dev = card_step.device
    steps = {"card": card_step,
             "cpu": TrainStep(card_step.model, card_step.optimizer, cfg, torch.device("cpu"))}
    states = {"card": state_from_numpy(cfg, init, dev),
              "cpu": state_from_numpy(cfg, init, "cpu")}
    out = {"slices": 0, "splits": 0, "split_records": [], "jump_slices": 0,
           "jump_records": []}
    for arrays in shipped:
        planes = {"card": arrays, "cpu": {k: a.cpu() if isinstance(a, torch.Tensor) else a
                                          for k, a in arrays.items()}}
        rows = arrays["ckeys"].shape[0] // cfg.microbatch
        for j, num_real in enumerate(arrays["slice_num_real"]):
            views = {side: {k: a[j * rows:(j + 1) * rows] for k, a in planes[side].items()
                            if isinstance(a, torch.Tensor)} for side in steps}
            keys = views["cpu"]["ckeys"]
            uk = torch.unique(keys[keys >= 0])  # sorted
            snap = {}
            for side, step in steps.items():
                tables = states[side]["tables"]
                idx = uk.to(step.device)

                def rows_of(tables=tables, idx=idx):
                    return {n: {k: t[k][idx].cpu() for k in ("param", "n", "z")}
                            for n, t in tables.items()}

                before = rows_of()
                step._update(tables, views[side], num_real,
                             torch.zeros(2, dtype=torch.float64, device=step.device))
                snap[side] = (before, rows_of())
            (cb, ca), (pb, pa) = snap["card"], snap["cpu"]
            for name in ca:
                split = (ca[name]["n"] == 0) != (pa[name]["n"] == 0)
                tol = None
                for i, col in split.nonzero().tolist():
                    if tol is None:
                        tol = split_tolerance(name, views["cpu"], num_real, uk, pb)
                    g = {"card": math.sqrt(float(ca[name]["n"][i, col])),
                         "cpu": math.sqrt(float(pa[name]["n"][i, col]))}
                    ok = (float(cb[name]["n"][i, col]) == 0.0 == float(pb[name]["n"][i, col])
                          and max(g.values()) <= float(tol[i, col]))
                    rec = {"slice": out["slices"], "array": name, "row": int(uk[i]),
                           "col": col, "abs_g": g, "k2_bound": float(tol[i, col]),
                           "rounding_split": ok,
                           "w_init_kept_by": "card" if g["card"] == 0.0 else "cpu",
                           "w_after": {"card": float(ca[name]["param"][i, col]),
                                       "cpu": float(pa[name]["param"][i, col])}}
                    out["splits"] += 1
                    if len(out["split_records"]) < records:
                        out["split_records"].append(rec)
                    if not synchronize:
                        continue
                    if not ok:
                        raise AssertionError(f"an n' == 0 split that is not rounding: "
                                             f"{json.dumps(rec)}")
                    for k in ("param", "n", "z"):
                        states["cpu"]["tables"][name][k][uk[i], col] = ca[name][k][i, col]
                zd = (ca[name]["z"] - pa[name]["z"]).abs()
                zb = pa[name]["z"].abs() * TRAIN_BOUNDS["table_rtol"] + 5e-8
                jumped = (zd - (cb[name]["z"] - pb[name]["z"]).abs() > 0.5 * zb).nonzero()
                if jumped.numel():
                    out["jump_slices"] += 1
                    for i, col in jumped.tolist()[:max(0, records - len(out["jump_records"]))]:
                        out["jump_records"].append(
                            {"slice": out["slices"], "array": name, "row": int(uk[i]),
                             "col": col, "z": {"card": float(ca[name]["z"][i, col]),
                                               "cpu": float(pa[name]["z"][i, col])}})
            out["slices"] += 1
    out["tables"] = compare_states(states["card"], states["cpu"], gate=synchronize)
    return out


def seq_lockstep(dev, t_log2: int, workdir: str, runs: int, budget_s: float = 780.0) -> dict:
    """``lockstep_tables`` over the batches one ``Trainer`` run of the
    sequential sparse FM path shipped, up to ``runs`` times (or
    ``budget_s`` seconds), each time twice: synchronised (as phase 12
    holds it) and not (how far apart an n' == 0 split leaves the
    tables).  Reports the splits and the final ratio to TRAIN_BOUNDS of
    each replay."""
    import torch

    from xflow_tpu_torch.convert import state_to_numpy
    from xflow_tpu_torch.trainer import Trainer

    data = write_train_shards(workdir)
    cfg = mode_config("fm", t_log2, data, "", update_mode="sequential",
                      microbatch=SEQ_MICROBATCH, sequential_inner="sparse")
    trainer = Trainer(cfg, device=dev, log=lambda _: None)
    init = state_to_numpy(trainer.state, aux=True)
    shipped = keep_shipped_batches(trainer)
    trainer.train()
    torch.cuda.synchronize()
    trainer.close()
    t0 = time.perf_counter()
    out = {True: [], False: []}
    for r in range(runs):
        if time.perf_counter() - t0 > budget_s:
            break
        for sync in (True, False):
            rep = lockstep_tables(trainer.step, cfg, init, shipped, synchronize=sync)
            out[sync].append(rep)
            log(json.dumps({"lockstep": r, "synchronize": sync, **rep}))
    summary = {"runs": len(out[True]), "seconds": time.perf_counter() - t0}
    for sync, name in ((True, "synchronised"), (False, "unsynchronised")):
        summary[name] = {"splits_per_run": [r["splits"] for r in out[sync]],
                         "max_err_over_bound_per_run":
                             [r["tables"]["max_err_over_bound"] for r in out[sync]]}
    log(json.dumps({"lockstep_summary": summary}))
    return summary

def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--seq-witness", type=int, default=0, metavar="RUNS",
        help="instead of the phases: the sequential sparse path RUNS times on "
        "the card against one float32 CPU run and one float64 witness")
    parser.add_argument(
        "--seq-lockstep", type=int, default=0, metavar="RUNS",
        help="instead of the phases: the sequential sparse FM path RUNS times "
        "on the card and the CPU in lockstep, comparing each slice's rows")
    args = parser.parse_args()
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
    from xflow_tpu_torch.ops.build import build_log

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(dev)}")
    log(json.dumps(dict(build_all(), phase=1)))
    if args.seq_witness or args.seq_lockstep:
        workdir = tempfile.mkdtemp(prefix="xflow-seq-witness-")
        try:
            if args.seq_witness:
                seq_witness(dev, T_LOG2, workdir, args.seq_witness)
            else:
                seq_lockstep(dev, T_LOG2, workdir, args.seq_lockstep)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"chip_smoke: diagnostic done in {time.perf_counter() - t_start:.1f} s")
        return 0
    for name in ("score", "train", "optim", "sparse"):
        for line in build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

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

    k2_check = phase_k2_vs_plain(dev, T_LOG2)
    log(json.dumps(dict(k2_check, phase=6)))
    torch.cuda.empty_cache()
    k3_check = phase_k3_vs_plain(dev, T_LOG2)
    log(json.dumps(dict(k3_check, phase=7)))
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="xflow-chip-smoke-train-")
    try:
        train_path = phase_train_main_path(dev, T_LOG2, workdir)
        for row in train_path["rows"]:
            log(json.dumps(dict(row, phase=8)))
        log(json.dumps(dict(train_path["k2_check"], phase=8,
                            check="K2 against train_plain on the main path's batches")))
        torch.cuda.empty_cache()
        modes = phase_update_modes(dev, T_LOG2, workdir, train_path)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del train_path["inits"], train_path["finals"]
    log(json.dumps({"phase": 10, "checks": modes["checks"], **modes["worst"]}))
    torch.cuda.empty_cache()
    train_timings = phase_train_timings(dev, T_LOG2)

    # the training line: examples/s per epoch, step times, phase seconds,
    # the batches' key statistics, and the device's busy share from K2's
    # and K3's device times on this path's own batches and tables (phase
    # 8) times the steps that ran them -- not a profiler trace
    train_rows = []
    for row in train_path["rows"]:
        k2_ms = [r["ms"] for r in row["k2_main_path"] if r["keys"] == "main_path"]
        k3_ms = [r["ms"] for r in row["k3_main_path"]]
        busy = (TRAIN_EPOCHS * sum(k2_ms) + row["steps"] * sum(k3_ms)) / 1e3
        train_rows.append({
            "model": row["model"], "card": card,
            "examples_per_sec": row["examples_per_sec"],
            "step_time_p50": row["step_time_p50"],
            "step_time_p99": row["step_time_p99"],
            "phases": [{k: p.get(k, 0.0) for k in
                        ("input_stall", "h2d", "dispatch", "device_block")}
                       for p in row["phases"]],
            "overlapped": row["overlapped"],
            "train_seconds": row["train_seconds"],
            "batches": row["batch_stats"],
            "k2_ms_per_batch": k2_ms, "k3_ms_per_table": k3_ms,
            "device_busy_s_from_kernel_times": busy,
            "device_idle_share_from_kernel_times": 1.0 - busy / row["train_seconds"],
            "eval_auc": row["eval"]["auc"], "eval_logloss": row["eval"]["logloss"],
            "auc_floor": row["auc_bars"]["floor"], "bayes_auc": row["auc_bars"]["bayes_auc"],
            "bayes_gap_closed": row["bayes_gap_closed"],
        })
    for row in modes["rows"]:
        if "device_busy_s_from_kernel_times" not in row:
            continue
        train_rows.append({
            "model": row["model"], "mode": row["mode"], "card": card,
            "examples_per_sec": row["examples_per_sec"],
            "step_time_p50": row["step_time_p50"], "phases": row["phases"],
            "train_seconds": row["train_seconds"],
            "device_busy_s_from_kernel_times": row["device_busy_s_from_kernel_times"],
            "device_idle_share_from_kernel_times":
                row["device_idle_share_from_kernel_times"],
            "eval_auc": row["eval"]["auc"], "eval_logloss": row["eval"]["logloss"],
            "auc_floor": train_path["bars"]["floor"],
            "bayes_auc": train_path["bars"]["bayes_auc"],
            "bayes_gap_closed": (row["eval"]["auc"] - 0.5)
            / (train_path["bars"]["bayes_auc"] - 0.5),
        })
    log(json.dumps({"train": train_rows}))

    head = next(r for r in timings if r["mode"] == "fm" and r["B"] == BUCKETS[-1])
    fm_row = next(r for r in train_path["rows"] if r["model"] == "fm")
    k2_head = next(r for r in fm_row["k2_main_path"] if r["keys"] == "main_path")
    k3_head = next(r for r in fm_row["k3_main_path"] if r["table"] == "v")
    k2_main = [r for row in train_path["rows"] for r in row["k2_main_path"]]
    k3_main = [dict(r, model=row["model"]) for row in train_path["rows"]
               for r in row["k3_main_path"]]
    k2_err = {k: max(k2_check[k], train_path["k2_check"][k],
                     modes["worst"]["k2_index"][k])
              for k in ("max_abs_err_g", "max_err_over_tol")}
    # launches on every training path: phase 8's dense path and phases
    # 11-13's update modes, each counted from 0 just before its run
    train_launches = {k: train_path["launches"][k] + modes["launches"][k]
                      for k in KERNEL_WRAPPERS}
    by_path = dict(modes["launches_by_path"], dense=train_path["launches"])
    k4_head = next(r for r in modes["timings"] if r["kernel"] == "consolidate_keys"
                   and r["model"] == "fm" and r["path"] == "sparse main path")
    k5_head = next(r for r in modes["timings"] if r["kernel"] == "touched_update"
                   and r["model"] == "fm" and r["path"] == "sparse main path"
                   and r["table"] == "v")
    k2_index = [r for r in modes["timings"] if r["kernel"].startswith("train_step")]
    kernels = [{
        "name": "score",
        "route": "cuda",
        "source": "xflow_tpu_torch/csrc/score.cu",
        "replaces": REPLACES,
        "launches": main_path["launches"] + train_launches["score"],
        "launches_by_path": {"serve": main_path["launches"],
                             "train": train_launches["score"]},
        "max_abs_err": check["max_abs_err"],
        "ms": head["ms"],
        "host_path_ms": head["host_path_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "bound_sector_ms": head["bound_sector_ms"],
        "library_ms": head["library_ms"],
        "library_why_null": "no single PyTorch call scores FM (LR's "
        "embedding_bag yardstick is in per_bucket)",
        "shape": {"mode": "fm", "B": head["B"], "K": K, "D": D},
        "per_bucket": timings,
    }, {
        "name": "train_step",
        "route": "cuda",
        "source": "xflow_tpu_torch/csrc/train.cu",
        "replaces": K2_REPLACES,
        "launches": train_launches["train_step"],
        "launches_by_path": {k: n["train_step"] for k, n in by_path.items()},
        "max_abs_err": k2_err["max_abs_err_g"],
        "max_err_over_tol": k2_err["max_err_over_tol"],
        "ms": k2_head["ms"],
        "host_path_ms": k2_head["host_path_ms"],
        "plain_ms": k2_head["plain_ms"],
        "bound_ms": k2_head["bound_ms"],
        "bound_by": k2_head["bound_by"],
        "bound_sector_ms": k2_head["bound_sector_ms"],
        "library_ms": None,
        "library_why_null": k2_head["library_why_null"],
        "shape": {"mode": "fm", "B": k2_head["B"], "K": K, "D": D,
                  "keys": "the training main path's first batch", "wire": "compact"},
        "per_shape": k2_main + train_timings["k2"] + k2_index,
    }, {
        "name": "optim_update",
        "route": "cuda",
        "source": "xflow_tpu_torch/csrc/optim.cu",
        "replaces": K3_REPLACES,
        "launches": train_launches["optim_update"],
        "launches_by_path": {k: n["optim_update"] for k, n in by_path.items()},
        "max_abs_err": k3_check["max_abs_err"],
        "max_err_over_tol": k3_check["max_err_over_tol"],
        "ms": k3_head["ms"],
        "host_path_ms": k3_head["host_path_ms"],
        "plain_ms": k3_head["plain_ms"],
        "bound_ms": k3_head["bound_ms"],
        "bound_by": k3_head["bound_by"],
        "library_ms": None,
        "library_why_null": k3_head["library_why_null"],
        "shape": {"optimizer": "ftrl", "T": 1 << T_LOG2, "D": D,
                  "tables": "the training main path's trained v"},
        "per_shape": k3_main + train_timings["k3"],
    }, {
        "name": "consolidate_keys",
        "route": "cuda",
        "source": "xflow_tpu_torch/csrc/sparse.cu",
        "replaces": K4_REPLACES,
        "launches": train_launches["consolidate_keys"],
        "launches_by_path": {k: n["consolidate_keys"] for k, n in by_path.items()},
        "max_abs_err": modes["worst"]["k4"]["max_abs_err_slot_key"],
        "max_abs_err_of": "|ukeys[slot] - key| over every live occurrence of phase "
        "10's cases",
        "exact": "the same count and key set as the plain version's, each "
        "occurrence's slot holding its own key, padding -1; the slots are a "
        "permutation of the plain version's sorted slots (phase 10)",
        **{k: modes["worst"]["k4"][k] for k in ("cases", "count_equal", "key_set_equal",
                                                "slots_hold_own_key",
                                                "padding_slots_minus_one")},
        "ms": k4_head["ms"],
        "plain_ms": k4_head["plain_ms"],
        "bound_ms": k4_head["bound_ms"],
        "bound_by": k4_head["bound_by"],
        "bound_sector_ms": k4_head["bound_sector_ms"],
        "library_ms": k4_head["library_ms"],
        "library_call": k4_head["library_call"] + " (host path: it synchronises)",
        "shape": {"mode": "fm", "M": k4_head["M"], "U": k4_head["U"],
                  "keys": "the sparse main path's first batch"},
        "per_shape": [r for r in modes["timings"] if r["kernel"] == "consolidate_keys"],
    }, {
        "name": "touched_update",
        "route": "cuda",
        "source": "xflow_tpu_torch/csrc/sparse.cu",
        "replaces": K5_REPLACES,
        "launches": train_launches["touched_update"],
        "launches_by_path": {k: n["touched_update"] for k, n in by_path.items()},
        "max_abs_err": modes["worst"]["k5"]["max_abs_err"],
        "max_err_over_tol": modes["worst"]["k5"]["max_err_over_tol"],
        "ms": k5_head["ms"],
        "plain_ms": k5_head["plain_ms"],
        "bound_ms": k5_head["bound_ms"],
        "bound_by": k5_head["bound_by"],
        "bound_sector_ms": k5_head["bound_sector_ms"],
        "library_ms": None,
        "library_why_null": k5_head["library_why_null"],
        "shape": {"optimizer": "ftrl", "table": "v", "U": k5_head["U"], "D": D,
                  "keys": "the sparse main path's first batch"},
        "per_shape": [r for r in modes["timings"] if r["kernel"] == "touched_update"],
    }]
    log(json.dumps({"kernels": kernels}))
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
