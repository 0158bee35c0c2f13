#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``xflow_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for sm_90a) and the CUDA
toolkit's ``nvcc``; exits non-zero, printing no result, without them.
Phases, in order; any failure raises and the exit code is 1:

1. identify the card (``nvidia-smi`` name and power limit) and build
   every kernel of the package from ``xflow_tpu_torch/csrc``, one
   ``nvcc`` per source, and the native parser
   (``xflow_tpu_torch/native``, ``g++``), all started together;
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
   (scripts/bench_models.py geometry, T=2^24, batch 65,536), with the
   default input path (``native_parser=True``: the run header must say
   ``parser: native``; ``wire_dedup="auto"``: the dictionary wire,
   decoded on the card by K6), for 2 epochs, ``evaluate`` (writing pred lines), ``export_artifact``,
   ``PredictEngine.load`` on the card scoring the test lines as
   ``evaluate`` did (atol 1e-6 plus the 5e-7 rounding of the ``%.6f``
   pred lines); then the same run on ``device="cpu"`` from the same
   initial state (TRAIN_BOUNDS), and the eval AUC must lie between the
   planted signal's bars (AUC_Z).  Launch counts are zeroed just
   before and read just after: K2 = steps, K3 = steps x tables, K6 =
   steps + eval batches.  After
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
   return_inverse=True)`` as K4's library call);
15. hold K6 (ops/wire.py ``dict_decode``, csrc/wire.cu) against its
   plain version on the card, exactly (integer decode), and against the
   compact wire's planes of the same batch: the training main path's
   two FM batches (B = 65,536, K = 40), 65,536 rows of padding, an empty
   dictionary (65,536 rows of distinct keys), no tail (1,021 rows), u32
   keys (T = 2^25); K6 timed on the main path's batches beside the
   plain version, the byte bound and the host's compaction;
16. the other input paths on the card from phase 8's initial state,
   each shipping exactly phase 8's planes and held to its tables (and
   step log-losses and eval) within TRAIN_BOUNDS: native text over the
   compact wire (FM and LR), Python text over the compact wire (FM),
   and packed-v2 shards converted by ``python -m
   xflow_tpu_torch.io.packed`` (FM).  Phase 12 runs its sequential path
   over the compact wire too (the planes exactly, the log-losses and
   eval within TRAIN_BOUNDS, the tables reported).  Each path's
   examples/s, ``input_stall``, ``put_batch`` ms per dispatch, wire
   bytes per example and idle share go into the ``train`` line;
17. the hot table (B7 in K1 and K2, K5's fold, K3 over the head rows,
   K6's hot tiers) at the flagship geometries of
   scripts/bench_models.py:66-76 (``fm``: 12 cold + 32 hot slots, H =
   2^14, D = 10; ``lr``: 16 + 32, H = 2^12; T = 2^24): K1 with the hot
   plane against its plain version (phase 2's tolerances) with u16 keys
   at H = 2^12 and 2^14, int32 at H = 2^16 and the bf16 flag, every
   serving bucket, LR and FM; on the hot paths' own batches (phase 19,
   after each run) K2's three hot forms (dense: hot gradients in g's
   first H rows; hybrid: index mode with a head buffer; window: cold
   keys < H read from a head snapshot) in table-row space within phase
   6's per-row bound over the hot and cold planes together, K5 with
   the fold (the head buffers exact, folded rows untouched, the rest
   within phase 7's bounds) and K6's hot tiers exactly (the path's
   batch with its u16 or u12 large tier, the same rows re-steered into
   4 hot slots so nearly every row overflows, an empty hot plane);
18. serving a full-width ``fm`` hot artifact with its remap (phases 3
   and 4 again: ``PredictEngine.load``, ``score_text`` against the
   plain version and float64, ``MicroBatcher`` with 1,024 requests from
   16 clients, ``compile_count``);
19. training the flagship ``fm`` and ``lr`` on the default input path
   (native parser, dictionary wire with hot tiers) from phase 8's
   initial state: dense, sequential + sparse inner (the hybrid) at
   microbatch 128 and sequential + hot inner at microbatch 128
   (``hot_windowend`` auto, sparse at T = 2^24), 2 epochs each, and one
   dispatch of ``hot_windowend="dense"``; each with exact launches, the
   card against the CPU within TRAIN_BOUNDS (the sequential forms
   through ``lockstep_tables``, the hot inner window by window), eval
   AUC inside the planted bars, and the hot mass (the trainer's remap
   line) and the share of features steering truncates;
20. the hot modes' kernel times on the paths' own batches or first
   slices (K2 per form, K3 over the head rows, K5 with the fold, K6
   with the hot tiers; K1 at the serving bucket in phase 17), each with
   its bound and plain time; their ``kernels`` entries and ``train``
   rows;
21. FM past one 32-factor tile (C1): K1 and K2 at D = 33, 64 and 156
   against their plain versions (T = 2^20; K1 every bucket, both wires,
   phase 2's tolerances plus phase 6's logit bound; K2 on a 65,536-row
   compact batch and a 1,024-row full-wire Zipf batch, phase 6's
   bounds), K1 and K2 timed at D = 64 with their byte bounds, a v_dim =
   64 FM artifact (T = 2^22) served as in phases 3-4, and one dispatch
   of v_dim = 64 training on the card against the CPU;
22. K6's field streams (B4s) exactly against the plain version and the
   batch's own planes on the flagship ``mvm`` path's batch 0, the
   4-slot hot overflow, an empty hot plane and ids outside [0,
   max_fields) (past it and negative), and timed;
23. K1's MVM form (B9) against its plain version on the flagship
   ``mvm`` planes (12 + 32 slots, u16 at H = 2^14, u8 fields), with the
   bf16 flag, and ``mvm_nohot``'s 40 slots, every bucket, within a
   derived bound (mvm_tolerances), and timed at B = 512;
24. K2's MVM form against its plain version on the paths' own batches:
   on the dense path's 65,536-row batch dense (hot gradients in g's
   first H rows), the hybrid (index mode + head buffer), the hot
   inner's window-start form and index mode over the cold plane; the
   hybrid and window forms again on their paths' slice 0; the bf16
   flag, and a batch where the guard fires (own-field factors exactly
   0), within mvm_tolerances' per-row bound; each form timed with its
   bound;
25. serving a full-width hot ``mvm`` artifact (phases 3-4 again, the
   float64 reference MVM's product over fields);
26. training the flagship ``mvm`` (scripts/bench_models.py:79-82: 12
   cold + 32 hot slots, H = 2^14, T = 2^24, batch 65,536, D = 10,
   max_fields = 39) on the default input path in dense, hybrid and hot
   inner mode (microbatch 128, ``hot_windowend`` auto = sparse), 2
   epochs each from one seeded state: exact launches, the card against
   the CPU within TRAIN_BOUNDS (the sequential forms through
   ``lockstep_tables``, which also tells MVM's guard splits from
   faults), the sync guard on the sequential paths' first dispatch, the
   eval AUC inside the planted bars;
27. ``mvm_nohot`` (40 cold slots) dense on the default input path
   (native text, the dictionary wire with the field streams), the card
   against the CPU.

Output: the card line, per-phase lines, a ``{"kernels": [...]}`` JSON
line, and last ``{"ok": true, "device": {...}}``.  Each kernel's
``launches`` is its main paths': K1's serving path (phases 3 and 4)
plus the training paths' eval and engine batches (phases 8, 11, 12,
16), K2-K6's training paths (phases 8, 11-13 and 16, by path in
``launches_by_path``); the hot modes' entries count the hot paths
(phases 18-19), the D-tiled FM forms their phase-21 paths, and the
MVM forms the MVM paths (phases 25-27); every count is set to 0 just
before each path and read just after it.
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


def hot_stream(keys, hot, hot_size: int):
    """A batch's live keys over both planes (the hot plane's, when there
    is one, ahead of the cold plane's) and the hot plane's bytes at its
    wire width (2 B a slot for u16, 4 B for int32)."""
    import torch

    from xflow_tpu_torch.ops.score import hot_plane_keys

    live = keys[keys >= 0].long()
    if hot is None:
        return live, 0
    hk = hot_plane_keys(hot, hot_size)
    return torch.cat([hk[hk >= 0].long(), live]), hot.numel() * hot.element_size()


def bounds(keys, x, dim: int, hot=None, hot_size: int = 0) -> dict:
    """K1's least time on this card for THIS batch: the larger of its
    bytes over the HBM rate and its float32 operations over the peak
    rate.  Keys (the hot plane at its wire width), x and pctr count once
    each, and each distinct live table row once.  ``bound_ms`` counts
    the row bytes the kernel uses (4 B of w, 4D B of v);
    ``bound_sector_ms`` counts the 32-byte DRAM sectors a random row
    read moves at least (csrc/score.cu header)."""
    import torch

    b, k = keys.shape
    live_keys, hot_bytes = hot_stream(keys, hot, hot_size)
    live = int(live_keys.numel())
    rows = int(torch.unique(live_keys).numel())
    stream = b * k * (4 + (4 if x is not None else 0)) + 4 * b + hot_bytes
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
                    requests: int = 1024, concurrency: int = 16, hot: bool = False,
                    model: str = "fm", v_dim: int = D, phase: tuple = (3, 4)) -> dict:
    """Phases 3 and 4: artifact → PredictEngine → score_text, then the
    MicroBatcher bench.  Returns the K1 launches counted across both.
    With ``hot`` (phase 18) the artifact is the flagship ``fm`` (hot
    table H = 2^14, 32 hot slots, 12 cold) with a frequency remap built
    from the scored lines' keys, and the engine remaps and steers each
    request before K1 reads its hot and cold planes.  ``model="mvm"``
    (phase 25) serves the flagship ``mvm`` the same way (its field
    planes beside the keys), and ``v_dim`` (phase 21: 64) an FM wider
    than one of the kernels' 32-factor tiles."""
    import torch

    from xflow_tpu_torch.io import freq
    from xflow_tpu_torch.io.batch import pack_batch, remap_batch
    from xflow_tpu_torch.io.libffm import parse_block
    from xflow_tpu_torch.ops.score import score, score_plain
    from xflow_tpu_torch.parallel.step import compact_wire_np, to_device_planes
    from xflow_tpu_torch.serve.__main__ import run_bench
    from xflow_tpu_torch.serve.artifact import write_artifact
    from xflow_tpu_torch.serve.engine import PredictEngine

    cfg = dataclasses.replace(fm_nohot_config(t_log2), model=model, v_dim=v_dim)
    if hot:
        cfg = dataclasses.replace(cfg, **HOT_GEOMETRY[model])
    mvm = model == "mvm"
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    w = rng.standard_normal((cfg.table_size, 1), dtype=np.float32)
    w *= 0.3
    v = rng.standard_normal((cfg.table_size, v_dim), dtype=np.float32)
    v *= 0.05
    lines = libffm_lines(n_lines, rng)
    block = parse_block("\n".join(lines).encode() + b"\n", cfg.table_size,
                        cfg.hash_mode, cfg.seed)
    remap = None
    if hot:
        counts = np.bincount(block.keys, minlength=cfg.table_size)
        remap = freq.build_remap(counts, cfg.hot_size)
    name = f"{model}_{'hot' if hot else 'nohot'}_d{v_dim}"
    tables = {"v": v} if mvm else {"w": w, "v": v}
    art = write_artifact(f"{workdir}/{name}", cfg, tables, step=1, remap=remap)
    log(f"phase {phase[0]}: wrote the {name} artifact (T=2^{t_log2}, D={v_dim}) in "
        f"{time.perf_counter() - t0:.3f} s")

    score.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    engine = PredictEngine.load(art, device=dev)
    load_s = time.perf_counter() - t0
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
    batch = remap_batch(pack_batch(block, 0, n_lines, n_lines, cfg.max_nnz), remap,
                        cfg.hot_size, cfg.hot_nnz)
    planes = to_device_planes(compact_wire_np(batch, hot_u16=True, ship_slots=mvm), dev)
    tables = engine.state["tables"]
    want = score_plain(planes["ckeys"], None, tables["w"]["param"] if not mvm else None,
                       tables["v"]["param"], hot=planes.get("hot"), hot_size=cfg.hot_size,
                       fields=planes.get("fields"), hot_fields=planes.get("hot_fields"),
                       max_fields=cfg.max_fields)
    err = float(np.abs(pctr - want.cpu().numpy()).max())
    if err > PCTR_ATOL:
        raise AssertionError(f"engine vs plain on the card: max err {err}")
    # and a float64 numpy reference on the first 64 lines
    ref_err = 0.0
    for i in range(64):
        live = batch.mask[i] > 0
        hlive = batch.hot_mask[i] > 0
        # the model's rows: the hot section's and the cold one's keys
        keys_i = np.concatenate([batch.hot_keys[i][hlive], batch.keys[i][live]])
        vr = v[keys_i].astype(np.float64)
        if mvm:  # the centred product over the fields of 1 + their sums
            fields_i = np.concatenate([batch.hot_slots[i][hlive], batch.slots[i][live]])
            prod = np.ones(v_dim)
            for f in np.unique(fields_i[(fields_i >= 0) & (fields_i < cfg.max_fields)]):
                prod *= 1.0 + vr[fields_i == f].sum(0)
            logit = float((prod - 1.0).sum())
        else:
            lin = float(w[keys_i, 0].astype(np.float64).sum())
            logit = lin + float((vr.sum(0) ** 2 - (vr * vr).sum(0)).sum())
        p = 1e-6 if logit < -30 else 1.0 if logit > 30 else 1 / (1 + math.exp(-logit))
        ref_err = max(ref_err, abs(p - float(pctr[i])))
    if ref_err > 1e-5:
        raise AssertionError(f"engine vs float64 reference: max err {ref_err}")
    log(json.dumps({
        "phase": phase[0], "load_s": load_s, "score_text_s": score_s,
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
    log(json.dumps(dict(summary, phase=phase[1])))
    launches = score.launches  # the main path ends here
    out = {"launches": launches, "bench": summary, "compile_count": engine.compile_count,
           "max_abs_err_vs_plain": err, "max_abs_err_vs_float64": ref_err}
    if hot:
        out["hot_occurrences_scored"] = int(batch.hot_mask.sum())
        if not out["hot_occurrences_scored"]:
            raise AssertionError("the hot artifact scored no hot occurrence")
    del engine, tables
    return out


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
                   "touched_update", "dict_decode")


def wrappers() -> dict:
    """The kernels' wrappers by name, K1-K6."""
    from xflow_tpu_torch.ops.optim import optim_update
    from xflow_tpu_torch.ops.score import score
    from xflow_tpu_torch.ops.sparse import consolidate_keys, touched_update
    from xflow_tpu_torch.ops.train import train_step
    from xflow_tpu_torch.ops.wire import dict_decode

    return {"score": score, "train_step": train_step, "optim_update": optim_update,
            "consolidate_keys": consolidate_keys, "touched_update": touched_update,
            "dict_decode": dict_decode}


def zero_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


NATIVE = "native parser (g++)"


def build_all() -> dict:
    """Build every kernel source and the native parser at once, one nvcc
    (or g++) each; returns the seconds per source and the wall time.  A
    failed build raises."""
    import threading

    from xflow_tpu_torch.native.build import build_if_needed
    from xflow_tpu_torch.ops.build import CSRC_DIR, build

    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu")) + [NATIVE]
    seconds: dict = {}
    errors: dict = {}

    def one(name):
        try:
            if name == NATIVE:
                t0 = time.perf_counter()
                build_if_needed()
                seconds[name] = time.perf_counter() - t0
            else:
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


def run_header(metrics_out: str) -> dict:
    """The ``run_start`` row of a Trainer's metrics file."""
    with open(metrics_out) as f:
        return next(r for r in map(json.loads, f) if r["kind"] == "run_start")


def wire_rows(metrics_out: str) -> list:
    """The ``wire`` rows (one per epoch) of a Trainer's metrics file."""
    keys = ("epoch", "format", "wire_bytes_per_example", "compaction_ratio")
    with open(metrics_out) as f:
        return [{k: r[k] for k in keys} for r in map(json.loads, f) if r["kind"] == "wire"]


def host_planes(shipped: list) -> list:
    """The compact-wire planes of shipped batches (K6's outputs on the
    dictionary wire), copied to the host for exact comparisons."""
    return [{k: a[k].cpu() for k in ("ckeys", "labels_u8", "weights_u8")}
            for a in shipped]


def planes_equal(what: str, got: list, want: list) -> None:
    import torch

    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} batches shipped, expected {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        for name in w:
            if not torch.equal(g[name], w[name]):
                raise AssertionError(f"{what}: batch {i} plane {name} differs")


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
    inits, finals, planes = {}, {}, {}
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
                or got["consolidate_keys"] or got["touched_update"]
                or got["dict_decode"] != steps + math.ceil(TEST_LINES / cfg.batch_size)):
            raise AssertionError(f"{model}: {steps} steps x {tables} tables but launches {got}")
        # the default input path: the native parser and the dictionary wire
        header = run_header(cfg.metrics_out)
        if header["parser"] != "native" or trainer.step.wire_format != "dict":
            raise AssertionError(f"{model}: parser {header['parser']!r}, wire "
                                 f"{trainer.step.wire_format!r}; want native and dict")
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
        planes[model] = host_planes(shipped[:len(shipped) // TRAIN_EPOCHS])
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
            "step_logloss": list(trainer.step_logloss),
            "eval": {k: result[k] for k in ("auc", "logloss", "examples")},
            "cpu_eval": {k: cpu_result[k] for k in ("auc", "logloss")},
            "auc_bars": bars,
            "bayes_gap_closed": (result["auc"] - 0.5) / (bars["bayes_auc"] - 0.5),
            **kernels,
            "engine_vs_eval_max_abs": pred_err,
            "parser": header["parser"], "wire": wire_rows(cfg.metrics_out),
            **state_cmp,
        })
        del trainer, cpu, engine, init, shipped
        torch.cuda.empty_cache()
    return {"rows": rows, "launches": launches, "k2_check": k2_worst,
            "data": data, "bars": bars, "inits": inits, "finals": finals,
            "planes": planes}


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


def k2_bounds(keys, x, labels, dim: int, hot=None, hot_size: int = 0) -> dict:
    """K2's least time on this card for THIS batch (csrc/train.cu
    header): keys (the hot plane at its wire width), x, labels and
    weights once each; per distinct live row, w and v read and g_w and
    g_v read and written once each (``bound_ms``), or whole 32-byte
    sectors for each of those three row accesses (``bound_sector_ms``)."""
    import torch

    b, k = keys.shape
    live_keys, hot_bytes = hot_stream(keys, hot, hot_size)
    live = int(live_keys.numel())
    rows = int(torch.unique(live_keys).numel())
    stream = (b * k * (4 + (4 if x is not None else 0)) + 2 * b * labels.element_size()
              + hot_bytes)
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


def expected_launches(mode: dict, steps: int, tables: int, eval_batches: int,
                      windowend: str = "sparse") -> dict:
    """Each kernel's launches over ``steps`` dispatches of ``mode``
    (xflow_tpu_torch/parallel/step.py's module docstring): K2 once per
    update (per slice in sequential mode, per batch otherwise: dense
    microbatch and cold_consolidate run the plain dense step); K4 with
    each K2 of the touched-rows form, K5 per table after it; K3 per
    table per update of the dense form, and with a hot table per table
    per hybrid update (the head rows); K1 per eval batch; K6 per
    dispatch and eval batch on the dictionary wire.  The hot inner's
    window (``windowend`` resolved): K2 and K3 over the head per slice,
    then K4 once and K5 per table (sparse end) or K3 per table (dense
    end) per dispatch."""
    update = mode.get("update_mode", "dense")
    s = mode.get("microbatch", 1) if update == "sequential" else 1
    inner = mode.get("sequential_inner", "dense") if update == "sequential" else None
    hot = mode.get("hot_size_log2", 0) > 0
    sparse = update == "sparse" or inner == "sparse"
    # the dictionary wire (the default) decodes every shipped batch: K6
    # per training dispatch and per eval batch
    decodes = 0 if mode.get("wire_dedup") == "off" else steps + eval_batches
    out = {"score": eval_batches, "train_step": steps * s, "dict_decode": decodes}
    if inner == "hot" and s > 1:
        sparse_end = windowend == "sparse"
        return dict(out, optim_update=steps * tables * (s + (0 if sparse_end else 1)),
                    consolidate_keys=steps if sparse_end else 0,
                    touched_update=steps * tables if sparse_end else 0)
    plans = steps * s if sparse else 0
    # the dense form steps every table per update; the hybrid steps the
    # head rows per update; the plain touched-rows form none
    passes = (plans if hot else 0) if sparse else steps * s
    return dict(out, optim_update=passes * tables, consolidate_keys=plans,
                touched_update=plans * tables)


GUARD_SLEEP_CYCLES = 5 * SLEEP_CYCLES  # ~100 ms, 5x a sequential dispatch's host path
GUARD_SEGMENT_SLICES = 32  # at most 8 queued launches a slice: ~260 a segment


def guard_first_dispatch(trainer) -> dict:
    """Check that the trainer's first dispatch never waits for the card.
    It runs under ``torch.cuda.set_sync_debug_mode("error")``, in
    segments of ``GUARD_SEGMENT_SLICES`` sequential slices (one segment
    for an unsliced step), each queued behind a ``torch.cuda._sleep``.
    When a segment returns, its sleep must still hold the stream: any
    host synchronisation inside it (which the debug mode, a prototype,
    may not see) would have waited for the sleep to end.  Between
    segments the guard itself waits for the card, outside the check, so
    no segment queues more launches than the card holds pending (a
    hybrid fm dispatch queues about 1,030: 128 slices of K4's memset
    and two kernels, K2, and K5 and K3 per table).  Records the
    segments' host time and the sleeps' device times."""
    import torch

    step = trainer.step
    inner = {name: getattr(step, name) for name in ("dispatch_train", "_update", "window_slice")}
    seen = {"guarded_dispatches": 0, "guard_segments": 0, "dispatch_host_ms": 0.0,
            "sleep_ahead_ms": []}
    hold = {}

    def arm():
        hold["start"] = torch.cuda.Event(enable_timing=True)
        hold["end"] = torch.cuda.Event(enable_timing=True)
        hold["start"].record()
        torch.cuda._sleep(GUARD_SLEEP_CYCLES)
        hold["end"].record()
        torch.cuda.set_sync_debug_mode("error")
        hold["t0"] = time.perf_counter()

    def release():
        host_ms = (time.perf_counter() - hold["t0"]) * 1e3
        torch.cuda.set_sync_debug_mode(0)
        sleeping = not hold["end"].query()
        torch.cuda.synchronize()
        sleep_ms = hold["start"].elapsed_time(hold["end"])
        seen["guard_segments"] += 1
        seen["dispatch_host_ms"] += host_ms
        seen["sleep_ahead_ms"].append(sleep_ms)
        if not sleeping:
            raise AssertionError(
                f"the first dispatch waited for the card: segment {seen['guard_segments']} "
                f"returned after the {sleep_ms:.3f} ms sleep ahead of it had ended "
                f"({host_ms:.3f} ms on the host)")

    def per_slice(name):
        def run(*args, **kwargs):
            out = inner[name](*args, **kwargs)
            hold["slices"] += 1
            if hold["slices"] % GUARD_SEGMENT_SLICES == 0:
                release()
                arm()
            return out
        return run

    def guarded(state, arrays):
        hold["slices"] = 0
        for name in ("_update", "window_slice"):
            setattr(step, name, per_slice(name))
        arm()
        try:
            out = inner["dispatch_train"](state, arrays)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            for name in inner:
                setattr(step, name, inner[name])
        release()
        seen.update(guarded_dispatches=1, returned_while_sleep_held_stream=True)
        return out

    step.dispatch_train = guarded
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
    from xflow_tpu_torch.parallel.step import hot_windowend, uses_grad_buffer
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
                             math.ceil(TEST_LINES / cfg.batch_size) if evaluate else 0,
                             hot_windowend(cfg))
    if got != want:
        raise AssertionError(f"{model} {label}: launches {got}, expected {want}")
    header = run_header(cfg.metrics_out)
    if header["parser"] != "native" or trainer.step.wire_format != "dict":
        raise AssertionError(f"{model} {label}: parser {header['parser']!r}, wire "
                             f"{trainer.step.wire_format!r}; want native and dict")
    if any("g" in t for t in trainer.state["tables"].values()) != uses_grad_buffer(cfg):
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


def k5_bounds(ukeys, n: int, d: int, form: str, hot_size: int = 0) -> dict:
    """K5's least time for these rows: FTRL reads w, n, z and the gsum
    row and writes w, n, z (28 D B per row), SGD reads and writes one
    array and reads gsum (12 D B), plus the 4-byte key; with the fold
    (``hot_size``), a row < H only reads its gsum row and reads and
    writes its head row (12 D B).  At 32-byte sectors each row access
    moves every sector its 4D bytes at offset 4 D r touch.  About 20
    (FTRL) or 2 operations per stepped element, 1 per folded one."""
    arrays = 3 if form == "ftrl" else 1
    keys = ukeys[:n].long()
    folded = int((keys < hot_size).sum())
    stepped = n - folded
    used = 4 * n + 4 * d * (stepped * (2 * arrays + 1) + folded * 3)

    def span(rows):
        offs = rows * (4 * d)
        return int((((offs + 4 * d - 1) // SECTOR) - offs // SECTOR + 1).sum()) * SECTOR

    sectors = (4 * n + 4 * d * n + 2 * arrays * span(keys[keys >= hot_size])
               + 2 * span(keys[keys < hot_size]))
    ops = stepped * d * (20 if form == "ftrl" else 2) + folded * d
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
    if not os.path.exists(f"{prefix}-00000"):  # phases 13 and 19 share it
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
    import os

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
    out = {"rows": [], "checks": [], "timings": [], "worst": worst, "compact_rows": [],
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
        # the same path over the compact wire on the card: the same
        # planes, and (reported: FTRL's n' == 0 split, phase 12) tables
        seq_planes = host_planes(run["shipped"][:len(run["shipped"]) // TRAIN_EPOCHS])
        seq_ll, seq_eval = list(run["trainer"].step_logloss), run["row"]["eval"]
        seq_final = run["trainer"].state
        book(run)
        del run, arrays
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(mode_config(model, t_log2, data, os.path.join(
            workdir, f"{model}-seq-compact.jsonl"), **seq), wire_dedup="off")
        compact = card_run(dev, cfg, init)
        row = path_row("sequential, native text + compact", model, compact)
        row["vs_dict_wire_card"] = hold_to(f"{model} sequential compact", compact,
                                           seq_planes, seq_ll, seq_eval,
                                           {"tables": {n: {k: a.cpu() for k, a in t.items()}
                                                       for n, t in seq_final["tables"].items()}},
                                           gate=False)
        row["phase"] = 12
        out["compact_rows"].append(row)
        for k, n in compact["launches"].items():
            out["launches"][k] += n
        out["launches_by_path"][f"{model} sequential compact wire"] = compact["launches"]
        log(json.dumps(row))
        del compact, seq_final
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
# The default input path: K6 and the input paths (phases 15-16)

K6_REPLACES = (
    "xflow_tpu/parallel/step.py:621 (B4 dict: TrainStep._expand_dict_wire, its "
    "cold half, 621-743: row starts by cumsum of the u8 counts, each entry's "
    "tier flag and rank, dictionary indices resolved through the dictionary "
    "keys, u24/u32 tail keys, label and weight bitmaps); no pl.pallas_call in "
    "the reference"
)
K6_LIBRARY_WHY_NULL = ("no single PyTorch call decodes the dictionary wire (a "
                       "cumsum, bit ranks and two gathers)")


def k6_cases(data: dict, t_log2: int) -> list:
    """(case, Batch, CompactBatch) for phase 15: the training main
    path's two FM batches (a train shard holds one batch), as the loader
    and the dictionary wire build them; 65,536 rows of padding; 65,536
    rows of distinct keys (over the dictionary's 65,536 entries, each
    seen once: an empty dictionary); the first 1,021 rows of batch 0
    (all their keys fit the dictionary: no tail; B not a multiple of
    8); batch 0 parsed at T = 2^25 (u32 keys)."""
    from xflow_tpu_torch.io.batch import Batch
    from xflow_tpu_torch.io.compact import compact_batch
    from xflow_tpu_torch.io.loader import ShardLoader, make_parse_fn

    def first_batch(i, t):
        loader = ShardLoader(f"{data['train']}-{i:05d}", 65536, K, t,
                             parse_fn=make_parse_fn(t))
        return next(iter(loader.iter_batches()))[0]

    t = 1 << t_log2
    b0, b1 = first_batch(0, t), first_batch(1, t)
    b, z = b0.batch_size, np.zeros_like(b0.keys)
    ones = np.ones_like(b0.mask)
    distinct = ((np.arange(b * K, dtype=np.int64) * 2654435761) % t).reshape(b, K)
    head = slice(0, 1021)
    cases = [
        ("main path batch 0", b0, t), ("main path batch 1", b1, t),
        ("all padding", Batch(z, z, z.astype(np.float32), z.astype(np.float32),
                              np.zeros(b, np.float32), np.zeros(b, np.float32)), t),
        ("empty dictionary", Batch(distinct.astype(np.int32), z, ones, ones.copy(),
                                   b0.labels, b0.weights), t),
        ("no tail, B = 1,021", Batch(b0.keys[head], b0.slots[head], b0.vals[head],
                                     b0.mask[head], b0.labels[head], b0.weights[head]), t),
        ("u32 keys, T = 2^25", first_batch(0, 1 << 25), 1 << 25),
    ]
    out = []
    for name, batch, tt in cases:
        cb = compact_batch(batch, tt, 0)
        want = {"empty dictionary": cb.n_dict == 0, "no tail, B = 1,021":
                cb.n_dict_occ == cb.n_cold, "u32 keys, T = 2^25": cb.key_bytes == 4,
                "all padding": cb.n_cold == 0}.get(name, cb.key_bytes == 3)
        if not want:
            raise AssertionError(f"K6 case {name!r} is not what it names")
        out.append((name, batch, cb))
    return out


def phase_k6(dev, data: dict, t_log2: int) -> dict:
    """Phase 15: K6 against its plain version on the card, exactly, on
    ``k6_cases``, and against the compact wire's planes of the same
    batch; K6 timed on each case (device ms behind ``_sleep``, plain
    ms, the byte bound) beside the host's compaction and the two wires'
    bytes: the cases apart (padding only: no flag words to scan; no
    dictionary; no tail) show where its time goes."""
    import torch

    from xflow_tpu_torch.io.compact import compact_batch
    from xflow_tpu_torch.ops.wire import PLANES, dict_decode, dict_decode_plain, to_device
    from xflow_tpu_torch.parallel.step import compact_wire_np

    checks, timings = [], []
    for name, batch, cb in k6_cases(data, t_log2):
        wire = cb.wire(ship_slots=False)
        planes = to_device(wire, dev)
        got = dict_decode(planes, K)
        want = dict_decode_plain(planes, K)
        compact = compact_wire_np(batch)
        torch.cuda.synchronize()
        for g, w, c, label in zip(got, want, (compact["ckeys"], compact["labels_u8"],
                                              compact["weights_u8"]),
                                  ("ckeys", "labels_u8", "weights_u8")):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"K6 {name}: {label} differs from the plain version")
            if not torch.equal(g.cpu(), torch.from_numpy(np.ascontiguousarray(c))):
                raise AssertionError(f"K6 {name}: {label} differs from the compact wire")
        checks.append({"case": name, "B": batch.batch_size, "n_cold": cb.n_cold,
                       "n_dict": cb.n_dict, "n_tail": cb.n_cold - cb.n_dict_occ,
                       "key_bytes": cb.key_bytes, "exact": True})
        args = [(planes, K)] * TIMED_RUNS
        in_bytes = sum(int(wire[p].nbytes) for p in PLANES)
        out_bytes = batch.batch_size * (4 * K + 2)
        bound = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        t0 = time.perf_counter()
        for _ in range(3):  # as put_batch compacts after the first batch
            compact_batch(batch, cb.table_size, 0, check=False)
        host_ms = (time.perf_counter() - t0) / 3 * 1e3
        timings.append({
            "case": name, "B": batch.batch_size, "K": K,
            "ms": time_device_ms(dict_decode, args),
            "host_path_ms": time_host_path_ms(dict_decode, args),
            # about 80 launches a call: a smaller chunk stays under the
            # card's ~1,000 pending launches
            "plain_ms": time_device_ms(dict_decode_plain, args, chunk_size=5),
            "bound_ms": bound, "bound_by": "bytes", "bytes": in_bytes + out_bytes,
            "library_ms": None, "library_why_null": K6_LIBRARY_WHY_NULL,
            "host_compaction_ms": host_ms,
            "dict_wire_bytes": cb.wire_nbytes(ship_slots=False),
            "compact_wire_bytes": sum(int(a.nbytes) for a in compact.values()),
        })
        log(json.dumps(dict(timings[-1], phase=15)))
    return {"checks": checks, "timings": timings}


def card_run(dev, cfg, init: dict) -> dict:
    """``cfg`` trained (``cfg.epochs``) and evaluated on the card through
    ``Trainer`` from ``init``: launch counts zeroed just before and read
    just after, held to ``expected_launches``; the first epoch's shipped
    planes kept on the host."""
    import torch

    from xflow_tpu_torch.convert import state_from_numpy
    from xflow_tpu_torch.trainer import Trainer

    zero_launches()
    # the path starts here
    trainer = Trainer(cfg, device=dev, log=log)
    trainer.state = state_from_numpy(cfg, init, dev)
    shipped = keep_shipped_batches(trainer)
    t0 = time.perf_counter()
    history = trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    result = trainer.evaluate()
    torch.cuda.synchronize()
    got = read_launches()
    # ... and ends here
    trainer.close()
    steps = sum(h["steps"] for h in history)
    from xflow_tpu_torch.parallel.step import hot_windowend

    want = expected_launches(dataclasses.asdict(cfg), steps, len(trainer.state["tables"]),
                             math.ceil(TEST_LINES / cfg.batch_size), hot_windowend(cfg))
    if got != want:
        raise AssertionError(f"{cfg.model} {cfg.train_path}: launches {got}, expected {want}")
    return {"trainer": trainer, "history": history, "result": result, "launches": got,
            "train_seconds": train_s, "header": run_header(cfg.metrics_out),
            "wire": wire_rows(cfg.metrics_out),
            "planes": host_planes(shipped[:len(shipped) // cfg.epochs])}


def hold_to(what: str, run: dict, planes: list, step_logloss: list, evaluated: dict,
            final, gate: bool = True) -> dict:
    """A card run against another card run of the same batches: the
    shipped planes exactly, each step's log-loss, the eval and (gated or
    reported) the tables within TRAIN_BOUNDS."""
    planes_equal(what, run["planes"], planes)
    got = run["trainer"].step_logloss
    if len(got) != len(step_logloss) or any(
            abs(a - b) > TRAIN_BOUNDS["logloss_rtol"] * max(abs(b), 1.0)
            for a, b in zip(got, step_logloss)):
        raise AssertionError(f"{what}: step log-loss {got} vs {step_logloss}")
    res = run["result"]
    if abs(res["auc"] - evaluated["auc"]) > TRAIN_BOUNDS["auc_atol"] or abs(
            res["logloss"] - evaluated["logloss"]) > TRAIN_BOUNDS["logloss_rtol"] * abs(
            evaluated["logloss"]):
        raise AssertionError(f"{what}: eval {res} vs {evaluated}")
    return compare_states(run["trainer"].state, final, gate=gate)


def path_row(label: str, model: str, run: dict) -> dict:
    """One input path's timing row for the ``train`` line."""
    h = run["history"]
    return {
        "path": label, "model": model, "parser": run["header"]["parser"],
        "wire": run["trainer"].step.wire_format, "steps": sum(x["steps"] for x in h),
        "train_seconds": run["train_seconds"],
        "examples_per_sec": [x["examples_per_sec"] for x in h],
        "input_stall_s": [x["phases"].get("input_stall", 0.0) for x in h],
        "put_batch_ms_per_dispatch": [x["phases"].get("h2d", 0.0) / max(x["steps"], 1) * 1e3
                                      for x in h],
        "wire_bytes_per_example": [w["wire_bytes_per_example"] for w in run["wire"]],
        "compaction_ratio": [w["compaction_ratio"] for w in run["wire"]],
        "parse_mb_per_sec": [x.get("parse_mb_per_sec") for x in h],
        "eval_auc": run["result"]["auc"], "launches": run["launches"],
    }


def phase_input_paths(dev, t_log2: int, workdir: str, dense: dict) -> dict:
    """Phase 16: phase 8's runs (the native parser and the dictionary
    wire) against the other input paths on the card, from the same
    initial state: native text over the compact wire (FM and LR),
    Python text over the compact wire (FM), and packed-v2 shards from
    ``python -m xflow_tpu_torch.io.packed`` over the dictionary wire
    (FM).  Each ships exactly phase 8's planes and lands within
    TRAIN_BOUNDS of its tables, step log-losses and eval."""
    import os

    import torch

    from xflow_tpu_torch.convert import state_from_numpy

    data = dense["data"]
    packed = os.path.join(workdir, "packed", "synth.train")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "xflow_tpu_torch.io.packed", "--train", data["train"],
         "--out", packed, "--batch-size", "65536", "--max-nnz", str(K),
         "--table-size-log2", str(t_log2)],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise AssertionError(f"packed CLI failed: {proc.stdout}{proc.stderr}")
    convert_s = time.perf_counter() - t0
    log(json.dumps({"phase": 16, "packed_cli": proc.stdout.strip().splitlines(),
                    "seconds": convert_s}))
    main = {r["model"]: r for r in dense["rows"]}
    out = {"rows": [], "launches": dict.fromkeys(KERNEL_WRAPPERS, 0), "launches_by_path": {},
           "packed_convert_seconds": convert_s}
    for model, label, over, parser in (
        ("fm", "native text + compact", {"wire_dedup": "off"}, "native"),
        ("lr", "native text + compact", {"wire_dedup": "off"}, "native"),
        ("fm", "python text + compact", {"wire_dedup": "off", "native_parser": False},
         "python"),
        ("fm", "packed-v2 + dict", {"train_path": packed}, "native"),
    ):
        metrics = os.path.join(workdir, f"{model}-{label.replace(' ', '_')}.jsonl")
        cfg = dataclasses.replace(train_config(model, t_log2, data, metrics), **over)
        run = card_run(dev, cfg, dense["inits"][model])
        want_wire = "compact" if over.get("wire_dedup") == "off" else "dict"
        if run["header"]["parser"] != parser or run["trainer"].step.wire_format != want_wire:
            raise AssertionError(f"{model} {label}: parser {run['header']['parser']}, wire "
                                 f"{run['trainer'].step.wire_format}")
        ref = main[model]
        row = path_row(label, model, run)
        row["vs_phase8"] = hold_to(f"{model} {label}", run, dense["planes"][model],
                                   ref["step_logloss"], ref["eval"],
                                   state_from_numpy(cfg, dense["finals"][model], "cpu"))
        out["rows"].append(row)
        for k, n in run["launches"].items():
            out["launches"][k] += n
        out["launches_by_path"][f"{model} {label}"] = run["launches"]
        log(json.dumps(dict(row, phase=16)))
        del run
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The hot table at the flagship geometries (phases 17-20)

# scripts/bench_models.py:66-76: the repo's flagship lr and fm
HOT_GEOMETRY = {
    "fm": {"max_nnz": 12, "hot_size_log2": 14, "hot_nnz": 32, "v_dim": D},
    "lr": {"max_nnz": 16, "hot_size_log2": 12, "hot_nnz": 32},
    # scripts/bench_models.py:79-82 (mvm), max_fields 39 as fm_nohot_config
    "mvm": {"max_nnz": 12, "hot_size_log2": 14, "hot_nnz": 32, "v_dim": D},
}
HOT_MODES = (
    ("hot_dense", {}),
    ("hot_hybrid_mb128", {"update_mode": "sequential", "microbatch": SEQ_MICROBATCH,
                          "sequential_inner": "sparse"}),
    ("hot_inner_mb128", {"update_mode": "sequential", "microbatch": SEQ_MICROBATCH,
                         "sequential_inner": "hot"}),
)
HOT_WINDOW_DENSE = {"update_mode": "sequential", "microbatch": SEQ_MICROBATCH,
                    "sequential_inner": "hot", "hot_windowend": "dense"}
B7_REPLACES = (
    "xflow_tpu/ops/hot.py:71 (B7 hot_gather) + xflow_tpu/ops/hot.py:122 (B7 "
    "hot_scatter) + xflow_tpu/parallel/step.py:793-846 (the hot plane's decode and "
    "_gather_model_rows) + step.py:1008-1016 / 1194-1238 / 1327-1497 (its dense, "
    "hybrid and hot-inner scatters); no pl.pallas_call in the reference"
)
K5_FOLD_REPLACES = ("xflow_tpu/parallel/step.py:1194-1238 (_sparse_update's hybrid "
                    "fold of cold sums < H into the [H, D] head gradient); no "
                    "pl.pallas_call in the reference")
K3_HEAD_REPLACES = ("xflow_tpu/parallel/step.py:1230-1237 / 1446 (update_rows over "
                    "the head rows [0, H)); no pl.pallas_call in the reference")
K6_HOT_REPLACES = ("xflow_tpu/parallel/step.py:744-766 (B4 dict, hot tiers: u8 / u12 "
                   "/ u16 hot ids by tier bitmap rank); no pl.pallas_call in the "
                   "reference")
BF16_ULP = 2.0 ** -8  # a bfloat16 rounding's relative step


def hot_config(model: str, t_log2: int, data: dict, metrics_out: str, **mode):
    """The flagship ``fm`` or ``lr`` (HOT_GEOMETRY) training on
    ``data``'s shards."""
    return dataclasses.replace(train_config(model, t_log2, data, metrics_out),
                               **HOT_GEOMETRY[model], **mode)


def hot_keys(b: int, kh: int, h: int, g, dev, u16: bool):
    """A hot plane [b, kh]: ids < h drawn log-uniformly (the head's
    repeats), a random count per row, every 7th row empty; u16 (int16
    bits, 0xFFFF padding) or int32 (-1)."""
    import torch

    u = torch.rand((b, kh), generator=g, device=dev, dtype=torch.float64)
    ids = (torch.exp(u * math.log(h)) - 1).long().clamp(0, h - 1)
    count = torch.randint(0, kh + 1, (b, 1), generator=g, device=dev)
    count[torch.arange(b, device=dev) % 7 == 3] = 0
    live = torch.arange(kh, device=dev)[None, :] < count
    if u16:
        return torch.where(live, ids, 0xFFFF).to(torch.int32).to(torch.int16).contiguous()
    return torch.where(live, ids, -1).to(torch.int32).contiguous()


def phase_hot_k1(dev, t_log2: int) -> dict:
    """Phase 17a: K1 with the hot plane against score_plain: u16 at
    H = 2^12 (lr) and 2^14 (fm), int32 at H = 2^16, the bf16 flag (fm,
    H = 2^14), every serving bucket, LR and FM, with phase 2's
    tolerances.  Rows [0, 128) of make_tables carry w = +-20, so hot ids
    there push logits past the clamps."""
    import torch

    from xflow_tpu_torch.ops.score import score, score_plain

    w, v, g = make_tables(dev, t_log2)
    worst = {"max_abs_err": 0.0, "cases": 0}
    for case, h_log2, u16, bf16 in (("u16 H=2^12", 12, True, False),
                                    ("u16 H=2^14", 14, True, False),
                                    ("u16 H=2^14 bf16", 14, True, True),
                                    ("int32 H=2^16", 16, False, False)):
        for b in BUCKETS:
            for mode in ("lr", "fm"):
                kc = HOT_GEOMETRY[mode]["max_nnz"]
                keys = make_keys(b, w.shape[0], g, dev, False)[0][:, :kc].contiguous()
                hot = hot_keys(b, 32, 1 << h_log2, g, dev, u16)
                vv = v if mode == "fm" else None
                kw = dict(hot=hot, hot_size=1 << h_log2, hot_bf16=bf16)
                got_p, got_l = score(keys, None, w, vv, return_logit=True, **kw)
                want_p, want_l = score_plain(keys, None, w, vv, True, **kw)
                torch.cuda.synchronize()
                ltol = LOGIT_ATOL + LOGIT_RTOL * want_l.abs()
                ptol = PCTR_ATOL + want_p * (1 - want_p) * ltol
                if (float(((got_l - want_l).abs() - ltol).max()) > 0
                        or float(((got_p - want_p).abs() - ptol).max()) > 0
                        or not bool(torch.isfinite(got_p).all())):
                    raise AssertionError(f"K1 hot plane disagrees with score_plain: "
                                         f"{case} B={b} {mode}")
                worst["max_abs_err"] = max(worst["max_abs_err"],
                                           float((got_p - want_p).abs().max()))
                worst["cases"] += 1
    # K1 with the hot plane timed at the largest serving bucket, fm
    # (H = 2^14, u16, 32 hot + 12 cold slots), over a pool of batches
    b, h = BUCKETS[-1], 1 << HOT_GEOMETRY["fm"]["hot_size_log2"]
    pool = []
    for _ in range(KEY_POOL):
        keys = torch.randint(h, w.shape[0], (b, HOT_GEOMETRY["fm"]["max_nnz"]),
                             generator=g, device=dev, dtype=torch.int32)
        pool.append((keys, hot_keys(b, 32, h, g, dev, True)))
    args = [(k, hp) for k, hp in (pool[i % KEY_POOL] for i in range(TIMED_RUNS))]

    def kernel(keys, hot):
        return score(keys, None, w, v, hot=hot, hot_size=h)

    def plain(keys, hot):
        return score_plain(keys, None, w, v, hot=hot, hot_size=h)

    worst["timing"] = {"kernel": "score (hot plane)", "mode": "fm", "B": b, "Kc": 12,
                       "Kh": 32, "H": h, "plane": "u16",
                       "ms": time_device_ms(kernel, args),
                       "host_path_ms": time_host_path_ms(kernel, args),
                       "plain_ms": time_device_ms(plain, args),
                       **bounds(pool[0][0], None, D, hot=pool[0][1], hot_size=h),
                       "library_ms": None,
                       "library_why_null": "no single PyTorch call scores FM"}
    del w, v, pool
    return worst


def hot_timing_row(kernel: str, fn, plain, args, bound: dict, prelude=None, phase=20,
                   **extra) -> dict:
    """Device ms of ``fn`` and ``plain`` on ``args`` (behind _sleep, 60
    calls), with the bound and no library call."""
    row = {"kernel": kernel, **extra,
           "ms": time_device_ms(fn, args, prelude=prelude),
           "plain_ms": time_device_ms(plain, args, prelude=prelude, chunk_size=5),
           **bound, "library_ms": None}
    log(json.dumps(dict(row, phase=phase)))
    return row


def field_kw(arrays: dict) -> dict:
    """K1's and K2's MVM-form keywords for a view that carries field
    planes (and its ``max_fields``), else none."""
    if "fields" not in arrays:
        return {}
    return {"fields": arrays["fields"], "hot_fields": arrays.get("hot_fields"),
            "max_fields": arrays["max_fields"]}


def k2_hot_call(form: str, arrays: dict, tables: dict, h: int, snap=None,
                bf16: bool = False):
    """One K2 call over a hot batch or slice in ``form`` ("dense": every
    gradient in the table's g, the hot ones in its first H rows;
    "hybrid": the plain plan, the cold sums in gsum, the hot ones in a
    head buffer; "window": the window-start mode over g, cold keys < H
    read from ``snap``), with the bf16 flag when ``bf16``: (args,
    kwargs, rows), where ``rows()`` folds the call's sums back into
    table-row space [T, width] (gsum at the plan's unique keys, the head
    at rows [0, H)) and returns them with the log-loss accumulator."""
    import torch

    from xflow_tpu_torch.ops.sparse import consolidate_keys_plain

    keys = arrays["ckeys"]
    dev = keys.device
    w, v = (tables[n]["param"] if n in tables else None for n in ("w", "v"))
    t, m = (w if w is not None else v).shape[0], keys.numel()
    g = {n: torch.zeros_like(tables[n]["param"]) for n in ("w", "v") if n in tables}
    acc = torch.zeros(2, dtype=torch.float64, device=dev)
    hot = arrays.get("hot")
    heads = {n: torch.zeros((h, a.shape[1]), device=dev) for n, a in g.items()}
    kw = {"hot": hot, "hot_size": h, "hot_bf16": bf16, **field_kw(arrays)}
    dst = g
    if form == "hybrid":
        ukeys = torch.empty(m, dtype=torch.int32, device=dev)
        count = torch.zeros(1, dtype=torch.int32, device=dev)
        kw["slots"] = torch.empty_like(keys)
        consolidate_keys_plain(keys, t, ukeys, count, kw["slots"])
        dst = {n: torch.zeros((m, a.shape[1]), device=dev) for n, a in g.items()}
    elif form == "dense":
        heads = {n: a[:h] for n, a in g.items()}
    else:
        kw.update(snap_w=snap.get("w"), snap_v=snap.get("v"))
    if hot is None:  # the cold plane alone: no head destination
        heads = {}
    kw.update(hg_w=heads.get("w"), hg_v=heads.get("v"))
    args = (keys, None, arrays["labels_u8"], arrays["weights_u8"], arrays["num_real"], w, v,
            dst.get("w"), dst.get("v"), acc)

    def rows():
        if form == "hybrid":
            n = int(count)
            for name in g:
                g[name].index_add_(0, ukeys[:n].long(), dst[name][:n])
        if form != "dense":
            for name in heads:
                g[name][:h] += heads[name]
        return g, acc

    return args, kw, rows


def check_k2_hot(case: str, form: str, arrays: dict, tables: dict, h: int,
                 worst: dict, bf16: bool = False) -> None:
    """K2's hot forms against train_plain on one hot batch or slice,
    compared in table-row space within phase 6's per-row bound over the
    hot and cold planes together (k2_tolerances on the combined key
    plane; in window form over tables whose rows [0, H) are the
    snapshot's for the cold plane, by giving those keys rows T + key);
    the log-loss sum within its bound, the count exact.  With ``bf16``
    (the flag of ``hot_impl="mxu"`` + bfloat16) see ``check_bf16``."""
    import torch

    from xflow_tpu_torch.ops.score import hot_plane_keys
    from xflow_tpu_torch.ops.train import train_plain, train_step

    w = tables["w"]["param"]
    v = tables["v"]["param"] if "v" in tables else None
    t = w.shape[0]
    snap = None
    if form == "window":  # a snapshot other than the live head, so reads tell
        snap = {n: (tables[n]["param"][:h] * 0.5).contiguous() for n in tables}
    outs = []
    for fn in (train_step, train_plain):
        args, kw, rows = k2_hot_call(form, arrays, tables, h, snap, bf16)
        fn(*args, **kw)
        outs.append(rows())
    torch.cuda.synchronize()
    hk = hot_plane_keys(arrays["hot"], h)
    ck = arrays["ckeys"].long()
    tw, tv = w, v
    if snap is not None:
        ck = torch.where((ck >= 0) & (ck < h), ck + t, ck)
        tw = torch.cat([w, snap["w"]])
        tv = torch.cat([v, snap["v"]]) if v is not None else None
    keys = torch.cat([hk, ck], dim=1).to(torch.int32)
    tol_w, tol_v, tol_ll = k2_tolerances(keys, None, arrays["labels_u8"],
                                         arrays["weights_u8"], arrays["num_real"], tw, tv)
    if snap is not None:
        tol_w = tol_w[:t].index_add(0, torch.arange(h, device=w.device), tol_w[t:])
        tol_v = (tol_v[:t].index_add(0, torch.arange(h, device=w.device), tol_v[t:])
                 if tol_v is not None else None)
    (gk, acc), (gp, pacc) = outs
    if bf16:
        check_bf16(case, form, arrays, tables, h, gk, gp, acc, pacc,
                   {"w": tol_w, "v": tol_v}, worst)
    else:
        for name, tol in (("w", tol_w), ("v", tol_v)):
            if tol is None:
                continue
            diff = (gk[name].double() - gp[name].double()).abs()
            excess = float((diff - tol).max())
            if excess > 0 or not bool(torch.isfinite(gk[name]).all()):
                raise AssertionError(f"K2 {form} form disagrees with train_plain: {case} "
                                     f"{name} excess {excess}")
            worst["max_abs_err_g"] = max(worst["max_abs_err_g"], float(diff.max()))
            ratio = diff / torch.where(tol > 0, tol, 1.0)
            worst["max_err_over_tol"] = max(worst["max_err_over_tol"], float(ratio.max()))
    if abs(float(acc[0]) - float(pacc[0])) > tol_ll or float(acc[1]) != float(pacc[1]):
        raise AssertionError(f"K2 {form} form log-loss/count {acc.tolist()} vs plain "
                             f"{pacc.tolist()} ({case})")
    worst["cases"] += 1


BF16_ULP = 2.0 ** -7  # a bfloat16 step, relative to the value it rounds: 8 significant bits
BF16_POWER = 10  # the flag must show at least 10x as often as rounding flips


def check_bf16(case: str, form: str, arrays: dict, tables: dict, h: int, gk: dict,
               gp: dict, acc, pacc, tols: dict, worst: dict) -> None:
    """K2 with the bf16 flag against train_plain with it.  Each hot
    gradient rounds to bfloat16 on both sides, from float32 values that
    differ in their last bits, so an occurrence within that distance of
    a rounding tie can land one bfloat16 step apart (a flip).  So every
    element must lie within phase 6's bound (``tols``, scaled 1.01 for
    the rounded values) plus one step per hot occurrence (BF16_ULP
    times the sum of |occurrence| at that element); the elements beyond
    phase 6's bound alone (the flips) must be at most 1/BF16_POWER of
    those the gradient rounding moves beyond it (the flag's power:
    rounded against unrounded hot sums of the plain occurrences); and
    the log-loss sum's gap to an unflagged plain run (the rounded head
    in the forward) must be BF16_POWER x the kernel's gap to the
    flagged one."""
    import torch

    from xflow_tpu_torch.ops.hot import hot_scatter
    from xflow_tpu_torch.ops.train import occurrence_grads, train_plain

    w, v = (tables[n]["param"] if n in tables else None for n in ("w", "v"))
    occ, hk, _, _ = occurrence_grads(arrays["ckeys"], None, arrays["labels_u8"],
                                     arrays["weights_u8"], arrays["num_real"],
                                     w, v, hot=arrays["hot"], hot_size=h,
                                     hot_bf16=True, **field_kw(arrays))
    eff = torch.where(hk >= 0, hk, torch.full_like(hk, h)).reshape(-1)
    kh = hk.shape[1]
    stats = {"case": case, "form": form, "beyond_f32_bound": 0, "flag_power": 0,
             "max_err_over_envelope": 0.0}
    for name, tol in tols.items():
        if tol is None:
            continue
        o = occ[name][:, :kh].reshape(-1, occ[name].shape[-1])
        s_abs = hot_scatter(eff, o.abs(), h).double()
        moved = (hot_scatter(eff, o, h, dtype=torch.bfloat16, impl="mxu")
                 - hot_scatter(eff, o, h)).double().abs()
        diff = (gk[name].double() - gp[name].double()).abs()
        envelope = 1.01 * tol.clone()
        envelope[:h] += BF16_ULP * s_abs
        if float((diff - envelope).max()) > 0 or not bool(torch.isfinite(gk[name]).all()):
            raise AssertionError(f"K2 bf16 {case} {name}: beyond one bfloat16 step per hot "
                                 "occurrence")
        stats["beyond_f32_bound"] += int((diff > 1.01 * tol).sum())
        stats["flag_power"] += int((moved > 1.01 * tol[:h]).sum())
        ratio = diff / torch.where(envelope > 0, envelope, 1.0)
        stats["max_err_over_envelope"] = max(stats["max_err_over_envelope"],
                                             float(ratio.max()))
    args, kw, rows = k2_hot_call(form, arrays, tables, h, None, False)
    train_plain(*args, **kw)
    uacc = rows()[1]
    stats["logloss_gap_kernel"] = abs(float(acc[0]) - float(pacc[0]))
    stats["logloss_gap_unflagged"] = abs(float(uacc[0]) - float(pacc[0]))
    if stats["flag_power"] < BF16_POWER * stats["beyond_f32_bound"] or (
            stats["logloss_gap_unflagged"] <= BF16_POWER * stats["logloss_gap_kernel"]):
        raise AssertionError(f"K2 bf16 {case}: the flag does not show above the rounding "
                             f"flips {stats}")
    worst.setdefault("bf16", []).append(stats)


def time_k2_hot(model: str, label: str, form: str, view: dict, tables: dict, h: int,
                flush) -> dict:
    """K2 in one hot form timed alone on one batch (or slice) of its
    path, beside its plain version: the plan (hybrid) made once before,
    the buffers allocated once (``k2_hot_call``), each call behind an
    L2 flush.  The bound counts phase 6's bytes over the hot and cold
    planes together (every distinct row read and its gradient row read
    and written once, the hot plane at its wire width), plus the
    hybrid's slot plane."""
    from xflow_tpu_torch.ops.train import train_plain, train_step

    snap = ({n: (tables[n]["param"][:h] * 0.5).contiguous() for n in tables}
            if form == "window" else None)
    args, kw, _ = k2_hot_call(form, view, tables, h, snap)

    def kernel():
        train_step(*args, **kw)

    def plain():
        train_plain(*args, **kw)

    dim = tables["v"]["param"].shape[1] if "v" in tables else 0
    b2 = k2_bounds(view["ckeys"], None, view["labels_u8"], dim, hot=view["hot"], hot_size=h)
    used = b2["bound_bytes"] + (4 * view["ckeys"].numel() if form == "hybrid" else 0)
    bound = {"bound_ms": max(used / HBM_BYTES_PER_S * 1e3,
                             b2["bound_ops"] / FP32_FLOPS_PER_S * 1e3),
             "bound_by": b2["bound_by"], "bound_bytes": used,
             "distinct_rows": b2["distinct_rows"], "live_slots": b2["live_slots"]}
    return hot_timing_row(
        f"train_step (hot: {form})", kernel, plain, [()] * TIMED_RUNS, bound,
        prelude=flush.zero_, model=model, path=label, B=view["ckeys"].shape[0],
        Kc=view["ckeys"].shape[1], Kh=view["hot"].shape[1], H=h, D=dim,
        library_why_null="no single PyTorch call computes the gather, logit, residual, "
        "scatter-add and log-loss")


def check_k5_fold(case: str, tables: dict, opt, arrays: dict, h: int, worst: dict):
    """K5 with the fold against its plain version on copies of
    ``tables``, on K4's plan and K2's sums (index mode with a head
    buffer) over one hybrid slice: the head buffers equal exactly (each
    gets the same float32 adds), the folded rows keep every array, the
    stepped rows within phase 7's bounds, rows outside the plan
    bit-identical, gsum cleared, the slot map restored."""
    import torch

    from xflow_tpu_torch.ops.sparse import consolidate_keys, touched_plain, touched_update
    from xflow_tpu_torch.ops.train import train_step

    keys = arrays["ckeys"]
    dev = keys.device
    t = tables["w"]["param"].shape[0]
    m = keys.numel()
    slot_map = torch.full((t,), -1, dtype=torch.int32, device=dev)
    ukeys = torch.empty(m, dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    slots = torch.empty_like(keys)
    consolidate_keys(keys, t, ukeys, count, slots, slot_map)
    v = tables["v"]["param"] if "v" in tables else None
    gsum = {n: torch.zeros((m, tables[n]["param"].shape[1]), device=dev) for n in tables}
    heads = {n: torch.zeros((h, tables[n]["param"].shape[1]), device=dev) for n in tables}
    acc = torch.zeros(2, dtype=torch.float64, device=dev)
    train_step(keys, None, arrays["labels_u8"], arrays["weights_u8"], arrays["num_real"],
               tables["w"]["param"], v, gsum["w"], gsum.get("v"), acc, slots=slots,
               hot=arrays["hot"], hot_size=h, hg_w=heads["w"], hg_v=heads.get("v"))
    torch.cuda.synchronize()
    n = int(count)
    rows = ukeys[:n].long()
    folded = rows < h
    names = list(tables)
    for i, name in enumerate(names):
        copy = {k: tables[name][k].clone() for k in ("param", "n", "z")}
        plain = {k: a.clone() for k, a in copy.items()}
        before = {k: a.clone() for k, a in copy.items()}
        g_in, g_plain = gsum[name][:n].clone(), gsum[name].clone()
        head, head_plain = heads[name].clone(), heads[name].clone()
        touched_update(copy, opt, ukeys, count, gsum[name],
                       slot_map if i == len(names) - 1 else None, head=head, hot_size=h)
        touched_plain(plain, opt, ukeys, count, g_plain, head=head_plain, hot_size=h)
        torch.cuda.synchronize()
        if not torch.equal(head, head_plain):
            raise AssertionError(f"K5 fold {case} {name}: head buffers differ")
        mask = torch.zeros(t, dtype=torch.bool, device=dev)
        mask[rows[~folded]] = True
        for k in copy:
            if not torch.equal(copy[k][~mask], before[k][~mask]):
                raise AssertionError(f"K5 fold {case} {name}: a folded or unplanned row "
                                     f"changed ({k})")
        stepped = rows[~folded]
        rb = {k: a[stepped] for k, a in before.items()}
        rb["g"] = g_in[~folded]
        tols = k3_tolerances(rb, plain["n"][stepped], opt)
        for k, tol in tols.items():
            diff = (copy[k][stepped] - plain[k][stepped]).abs()
            if float((diff - tol).max()) > 0:
                raise AssertionError(f"K5 fold {case} {name} {k}: beyond phase 7's bound")
            worst["max_abs_err"] = max(worst["max_abs_err"], float(diff.max()))
            ratio = diff / torch.where(tol > 0, tol, 1.0)
            worst["max_err_over_tol"] = max(worst["max_err_over_tol"], float(ratio.max()))
        if bool(gsum[name][:n].any()):
            raise AssertionError(f"K5 fold {case} {name}: gsum not cleared")
        worst["folded_rows"] += int(folded.sum())
        worst["stepped_rows"] += int((~folded).sum())
    if bool((slot_map != -1).any()):
        raise AssertionError(f"K5 fold {case}: the slot map was not restored")
    return {"ukeys": ukeys, "count": count, "n": n, "gsum": gsum, "heads": heads}


def hot_k6_batches(cfg, trainer) -> list:
    """(case, Batch, hot_nnz) for the hot tiers: the path's first batch as
    its loader builds it (remapped and steered), the same rows re-steered
    with 4 hot slots (nearly every row overflows into the cold plane),
    and the batch with its hot plane emptied."""
    from xflow_tpu_torch.io.batch import Batch, remap_batch

    loader = trainer._loader(f"{cfg.train_path}-00000")
    batch = next(iter(loader.iter_batches()))[0]
    merged = Batch(batch.keys, batch.slots, batch.vals, batch.mask, batch.labels,
                   batch.weights, batch.hot_keys, batch.hot_slots, batch.hot_vals,
                   batch.hot_mask)
    ident = np.arange(cfg.table_size, dtype=np.int32)
    narrow = remap_batch(merged, ident, cfg.hot_size, 4)
    z = np.zeros_like(batch.hot_keys)
    empty = Batch(batch.keys, batch.slots, batch.vals, batch.mask, batch.labels,
                  batch.weights, z, z, z.astype(np.float32), z.astype(np.float32))
    return [(f"{cfg.model} main path batch 0", batch, cfg.hot_nnz),
            (f"{cfg.model} overflow (hot_nnz 4)", narrow, 4),
            (f"{cfg.model} empty hot plane", empty, cfg.hot_nnz)]


def check_k6_hot(cfg, trainer, dev) -> tuple[list, list]:
    """K6's hot tiers against the plain version, exactly, and against
    the batch's own hot and cold planes, on ``hot_k6_batches``; then K6
    timed on the main path's batch (device ms behind _sleep, plain ms,
    the byte bound over every plane read and written)."""
    import torch

    from xflow_tpu_torch.io.compact import compact_batch
    from xflow_tpu_torch.ops.wire import HOT_PLANES, PLANES, dict_decode, dict_decode_plain
    from xflow_tpu_torch.ops.wire import to_device

    checks, timings = [], []
    for name, batch, kh in hot_k6_batches(cfg, trainer):
        cb = compact_batch(batch, cfg.table_size, cfg.hot_size)
        wire = cb.wire(ship_slots=False)
        planes = to_device(wire, dev)
        kc = batch.max_nnz
        got = dict_decode(planes, kc, kh)
        want = dict_decode_plain(planes, kc, kh)
        torch.cuda.synchronize()
        truth = (np.where(batch.mask > 0, batch.keys, -1), batch.labels, batch.weights,
                 np.where(batch.hot_mask > 0, batch.hot_keys, -1))
        err_plain = err_batch = 0.0
        for gg, ww, tt, label in zip(got, want, truth, ("ckeys", "labels", "weights", "hot")):
            got_np = gg.cpu().numpy().astype(np.float64)
            err_plain = max(err_plain, float(np.abs(got_np - ww.cpu().numpy()).max(initial=0)))
            err_batch = max(err_batch, float(np.abs(got_np - tt).max(initial=0)))
            if gg.dtype != ww.dtype or not torch.equal(gg, ww):
                raise AssertionError(f"K6 hot tiers {name}: {label} differs from the plain "
                                     "version")
            if not np.array_equal(gg.cpu().numpy(), tt.astype(gg.cpu().numpy().dtype)):
                raise AssertionError(f"K6 hot tiers {name}: {label} differs from the batch")
        checks.append({"case": name, "B": batch.batch_size, "hot_nnz": kh, "n_hot": cb.n_hot,
                       "n_h8": cb.n_h8, "large_tier": "u16" if cb.hx16 else "u12",
                       "max_abs_err_plain": err_plain, "max_abs_err_batch": err_batch,
                       "exact": True})
        if name.endswith("main path batch 0"):
            in_bytes = sum(int(wire[p].nbytes) for p in PLANES + HOT_PLANES)
            out_bytes = batch.batch_size * (4 * (kc + kh) + 2)
            bound = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
            timings.append(hot_timing_row(
                "dict_decode (hot tiers)", dict_decode, dict_decode_plain,
                [(planes, kc, kh)] * TIMED_RUNS,
                {"bound_ms": bound, "bound_by": "bytes", "bytes": in_bytes + out_bytes},
                model=cfg.model, B=batch.batch_size, K=kc, Kh=kh,
                library_why_null=K6_LIBRARY_WHY_NULL))
    return checks, timings


def truncated_share(cfg, trainer, shipped: list) -> dict:
    """How much of the text the steering keeps: the features of the
    train shards (parsed), against the live hot and cold slots the path
    shipped over one epoch; the rest is truncation (reference
    semantics: io/batch.py::split_hot), reported and not gated."""
    from xflow_tpu_torch.ops.score import hot_plane_keys
    from xflow_tpu_torch.trainer import find_shards

    total = 0
    parse = trainer._parse_fn()
    for path in find_shards(cfg.train_path):
        with open(path, "rb") as f:
            total += len(parse(f.read()).keys)
    epoch = shipped[:len(shipped) // cfg.epochs]
    cold = sum(int((a["ckeys"] >= 0).sum()) for a in epoch)
    hot = sum(int((hot_plane_keys(a["hot"], cfg.hot_size) >= 0).sum()) for a in epoch)
    return {"text_features": total, "hot_slots": hot, "cold_slots": cold,
            "hot_share_of_kept": hot / max(hot + cold, 1),
            "truncated_share": 1.0 - (hot + cold) / max(total, 1)}


def hot_train_rows(hot: dict, modes: dict, train_path: dict, card: str) -> list:
    """The ``train`` line's rows for the hot paths (phase 19): device
    busy from the launches times each kernel form's device ms on the
    path's own batch or slice 0 (phase 20); K4 from phase 14's times on
    the no-hot geometry (not measured on the hot batches); phase 8's K3
    passes over the whole table."""
    train_rows = []
    hot_ms = {(r["kernel"], r.get("model")): r["ms"] for r in hot["timings"]}
    k3_ms_step = {row["model"]: sum(r["ms"] for r in row["k3_main_path"])
                  for row in train_path["rows"]}
    k4_ms = {r["path"]: r["ms"] for r in modes["timings"]
             if r["kernel"] == "consolidate_keys" and r["model"] == "fm"}
    for row in hot["rows"]:
        if "eval" not in row:
            continue
        model, n = row["model"], row["launches"]
        form = {"hot_dense": "dense", "hot_hybrid_mb128": "hybrid",
                "hot_inner_mb128": "window"}[row["mode"]]
        busy_ms = (n["train_step"] * hot_ms[(f"train_step (hot: {form})", model)]
                   + n["dict_decode"] * hot_ms[("dict_decode (hot tiers)", model)])
        k3_head = hot_ms[("optim_update (head rows)", model)]
        if form == "dense":
            busy_ms += row["steps"] * k3_ms_step[model]  # phase 8's K3 passes over T
        elif form == "hybrid":
            busy_ms += (n["optim_update"] * k3_head
                        + n["touched_update"] * hot_ms[("touched_update (fold)", model)]
                        + n["consolidate_keys"] * k4_ms["sequential main path, slice 0"])
        else:
            busy_ms += (n["optim_update"] * k3_head
                        + n["consolidate_keys"] * k4_ms["sparse main path"])
        busy = busy_ms / 1e3
        train_rows.append({
            "model": model, "mode": row["mode"], "card": card, "hot_mass": row["hot_mass"],
            "windowend": row.get("windowend"), "truncation": hot["truncation"][model],
            "examples_per_sec": row["examples_per_sec"],
            "step_time_p50": row["step_time_p50"], "phases": row["phases"],
            "put_batch_ms_per_dispatch": [p["h2d"] / (row["steps"] / TRAIN_EPOCHS) * 1e3
                                          for p in row["phases"]],
            "train_seconds": row["train_seconds"],
            "device_busy_s_from_kernel_times": busy,
            "device_idle_share_from_kernel_times": 1.0 - busy / row["train_seconds"],
            "eval_auc": row["eval"]["auc"], "eval_logloss": row["eval"]["logloss"],
            "auc_floor": train_path["bars"]["floor"],
            "bayes_auc": train_path["bars"]["bayes_auc"],
        })
    return train_rows


def hot_kernel_entries(hot: dict, k3_err: float) -> list:
    """The ``kernels`` line's entries for the hot modes: K1 with the hot
    plane, K2's three hot forms, K3 over the head rows, K5's fold and
    K6's hot tiers; launches counted on the hot paths (phases 18-19,
    each from 0 just before its path), times on the fm path's own
    batches (phase 20; K1 at the serving bucket, phase 17)."""
    by_path = hot["launches_by_path"]
    steps = {r["model"] + " " + r["mode"]: (r["steps"], r["tables"]) for r in hot["rows"]}

    def launches(kernel, modes):
        return sum(n[kernel] for path, n in by_path.items()
                   if path.split(" ", 1)[1] in modes)

    def timing(kernel):
        return next(r for r in hot["timings"] if r["kernel"] == kernel and r["model"] == "fm")

    window = ("hot_inner_mb128", "hot_inner_windowend_dense")
    head_passes = launches("optim_update", ("hot_hybrid_mb128", "hot_inner_mb128")) + sum(
        n["optim_update"] - steps[p][0] * steps[p][1] for p, n in by_path.items()
        if p.endswith("hot_inner_windowend_dense"))
    k2 = hot["checks"]["k2_hot"]
    k1t = hot["checks"]["k1"]["timing"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_why_null")
    entries = [{
        "name": "score (hot plane)", "route": "cuda", "source": "xflow_tpu_torch/csrc/score.cu",
        "replaces": B7_REPLACES + "; " + REPLACES,
        "launches": hot["serve"]["launches"] + launches("score", tuple(
            p.split(" ", 1)[1] for p in by_path)),
        "max_abs_err": hot["checks"]["k1"]["max_abs_err"],
        "host_path_ms": k1t["host_path_ms"], "bound_sector_ms": k1t["bound_sector_ms"],
        **{k: k1t[k] for k in keys},
        "shape": {k: k1t[k] for k in ("mode", "B", "Kc", "Kh", "H", "plane")},
    }]
    for form, modes in (("dense", ("hot_dense",)), ("hybrid", ("hot_hybrid_mb128",)),
                        ("window", window)):
        t = timing(f"train_step (hot: {form})")
        entries.append({
            "name": f"train_step (hot: {form})", "route": "cuda",
            "source": "xflow_tpu_torch/csrc/train.cu", "replaces": B7_REPLACES,
            "launches": launches("train_step", modes), "max_abs_err": k2["max_abs_err_g"],
            "max_err_over_tol": k2["max_err_over_tol"], **{k: t[k] for k in keys},
            "shape": {k: t[k] for k in ("model", "path", "B", "Kc", "Kh", "H", "D")}})
    for name, kernel, source, replaces, n, err in (
        ("optim_update (head rows)", "optim_update (head rows)", "csrc/optim.cu",
         K3_HEAD_REPLACES, head_passes, k3_err),
        ("touched_update (fold)", "touched_update (fold)", "csrc/sparse.cu",
         K5_FOLD_REPLACES, launches("touched_update", ("hot_hybrid_mb128",)),
         hot["checks"]["k5_fold"]["max_abs_err"]),
        ("dict_decode (hot tiers)", "dict_decode (hot tiers)", "csrc/wire.cu",
         K6_HOT_REPLACES, launches("dict_decode", tuple(p.split(" ", 1)[1] for p in by_path)),
         max(max(c["max_abs_err_plain"], c["max_abs_err_batch"])
             for c in hot["checks"]["k6_hot"])),
    ):
        t = timing(kernel)
        entries.append({
            "name": name, "route": "cuda", "source": "xflow_tpu_torch/" + source,
            "replaces": replaces, "launches": n,
            "max_abs_err": err,
            **{k: t[k] for k in keys},
            "shape": {k: t[k] for k in ("model", "path", "H", "D", "U", "B", "K", "Kh")
                      if k in t}})
    entries[-3]["max_abs_err_of"] = ("K3 over the head rows is K3 itself on views of "
                                     "rows [0, H): phase 7's check")
    entries[-1]["max_abs_err_of"] = (
        "every decoded cold key, label, weight and hot key against the plain version "
        "and against the batch's own planes (-1 on padding), over "
        + ", ".join(c["case"] for c in hot["checks"]["k6_hot"]))
    return entries


def phase_hot(dev, t_log2: int, workdir: str, dense: dict) -> dict:
    """Phases 17-20 at the flagship ``fm`` and ``lr`` (HOT_GEOMETRY,
    T = 2^24, batch 65,536, phase 8's shards and initial state): 17 the
    kernels' hot modes against their plain versions; 18 serving a hot
    artifact; 19 training on the default input path in dense, hybrid
    (sequential + sparse inner, microbatch 128) and hot-inner
    (microbatch 128, ``hot_windowend`` auto = sparse here) mode, 2
    epochs each, and one dispatch with ``hot_windowend="dense"``, the
    card against the CPU within TRAIN_BOUNDS (the sequential forms
    through ``lockstep_tables``), exact launches, the eval AUC inside
    the planted signal's bars; 20 the hot modes' kernel times on the
    paths' own batches."""
    import os

    import torch

    from xflow_tpu_torch.parallel.step import hot_windowend

    data, bars = dense["data"], dense["bars"]
    one = single_shard(data, workdir)
    out = {"rows": [], "checks": {}, "timings": [], "launches_by_path": {},
           "hot_mass": {}, "truncation": {}}
    k2w = {"max_abs_err_g": 0.0, "max_err_over_tol": 0.0, "cases": 0}
    k5w = {"max_abs_err": 0.0, "max_err_over_tol": 0.0, "folded_rows": 0, "stepped_rows": 0}
    out["checks"]["k1"] = phase_hot_k1(dev, t_log2)
    log(json.dumps({"phase": 17, "k1_hot": out["checks"]["k1"]}))
    torch.cuda.empty_cache()
    out["serve"] = phase_main_path(dev, t_log2, workdir, hot=True, phase=(18, 18))
    torch.cuda.empty_cache()
    k6_checks, flush = [], torch.empty(1 << 27, dtype=torch.uint8, device=dev)

    def book(label, model, run, **extra):
        row = dict(run["row"], phase=19, **extra)
        out["rows"].append(row)
        out["launches_by_path"][f"{model} {label}"] = row["launches"]
        log(json.dumps(row))

    for model in ("fm", "lr"):
        init = dense["inits"][model]
        geom = HOT_GEOMETRY[model]
        h = 1 << geom["hot_size_log2"]
        for label, mode in HOT_MODES:
            seq = mode.get("update_mode") == "sequential"
            run = run_mode(dev, model, t_log2, data, init, dict(geom, **mode), label, workdir,
                           keep=True, bars=bars, lockstep=seq, sync_check=seq)
            trainer, arrays = run["trainer"], run["shipped"][0]
            cfg = trainer.cfg
            if label == "hot_dense":
                out["hot_mass"][model] = trainer.hot_mass
                out["truncation"][model] = truncated_share(cfg, trainer, run["shipped"])
                checks, timings = check_k6_hot(cfg, trainer, dev)
                k6_checks += checks
                out["timings"] += timings
            tables = trainer.state["tables"]
            if seq:
                rows = arrays["ckeys"].shape[0] // SEQ_MICROBATCH
                view = {k: a[:rows] for k, a in arrays.items() if isinstance(a, torch.Tensor)}
                view["num_real"] = arrays["slice_num_real"][0]
            else:
                view = arrays
            form = {"hot_dense": "dense", "hot_hybrid_mb128": "hybrid",
                    "hot_inner_mb128": "window"}[label]
            check_k2_hot(f"{model} {label}", form, view, tables, h, k2w)
            if form == "dense":
                check_k2_hot(f"{model} {label} bf16", form, view, tables, h, k2w, bf16=True)
            torch.cuda.empty_cache()
            # K2's form timed alone on the path's own batch (or slice 0)
            out["timings"].append(time_k2_hot(model, label, form, view, tables, h, flush))
            if form == "hybrid":
                fold = check_k5_fold(f"{model} {label} slice 0", tables, trainer.step.optimizer,
                                     view, h, k5w)
                from xflow_tpu_torch.ops.sparse import touched_plain, touched_update

                name = "v" if "v" in tables else "w"
                copy = {k: tables[name][k].clone() for k in ("param", "n", "z")}
                head = fold["heads"][name]
                args = [(copy, trainer.step.optimizer, fold["ukeys"], fold["count"],
                         fold["gsum"][name], None, head, h)] * TIMED_RUNS
                def fold_plain(table, opt, ukeys, count, gsum, _slot_map, head, hot_size):
                    touched_plain(table, opt, ukeys, count, gsum, head, hot_size)

                out["timings"].append(hot_timing_row(
                    "touched_update (fold)", touched_update, fold_plain, args,
                    k5_bounds(fold["ukeys"], fold["n"], copy["param"].shape[1], "ftrl", h),
                    prelude=flush.zero_, model=model, path=label, table=name, U=fold["n"],
                    H=h, library_why_null="no single PyTorch call applies FTRL to gathered "
                    "rows"))
                # K3 over the head rows, the hybrid's and the hot inner's step
                from xflow_tpu_torch.ops.optim import optim_plain, optim_update

                hd = {k: tables[name][k][:h] for k in ("param", "n", "z")}
                hd["g"] = torch.zeros_like(hd["param"])
                out["timings"].append(hot_timing_row(
                    "optim_update (head rows)", optim_update, optim_plain,
                    [(hd, trainer.step.optimizer)] * TIMED_RUNS,
                    k3_bounds(hd["param"].numel(), True), model=model, path=label,
                    table=name, H=h, D=hd["param"].shape[1],
                    library_why_null="no single PyTorch call applies the FTRL recurrence"))
                del fold, copy, hd
            book(label, model, run, windowend=hot_windowend(cfg) if form == "window" else None,
                 hot_mass=trainer.hot_mass)
            del run, trainer, arrays, view, tables
            torch.cuda.empty_cache()
        run = run_mode(dev, model, t_log2, one, init, dict(geom, epochs=1, **HOT_WINDOW_DENSE),
                       "hot_inner_windowend_dense", workdir, evaluate=False, keep=True,
                       lockstep=True)
        book("hot_inner_windowend_dense", model, run, windowend="dense")
        del run
        torch.cuda.empty_cache()
    out["checks"]["k2_hot"] = k2w
    out["checks"]["k5_fold"] = k5w
    out["checks"]["k6_hot"] = k6_checks
    del flush
    return out


# ---------------------------------------------------------------------------
# C1 (FM past 32 factors) and MVM with its field planes (phases 21-27)

WIDE_DIMS = (33, 64, 156)
WIDE_T_LOG2 = 20  # v at D = 156 and T = 2^24 would take 10.5 GB a table
FM64_T_LOG2 = 22  # the served and trained v_dim = 64 FM
MVM_FIELDS = 39  # max_fields of the flagship geometries
MVM_NOHOT = {"max_nnz": K, "v_dim": D}  # scripts/bench_models.py mvm_nohot
C1_REPLACES = (
    "xflow_tpu/models/blocks.py:171 (B8 fm_pair_pieces) + xflow_tpu/models/fm.py:60-75 "
    "at any v_dim (the reference bounds v_dim nowhere, config.py:47); no "
    "pl.pallas_call in the reference"
)
B9_REPLACES = (
    "xflow_tpu/models/blocks.py:186 (B9 mvm_slot_terms) + xflow_tpu/models/mvm.py:82-112 "
    "(B9 MVMModel.logit / grad_logit, the 1e-12 guard) + "
    "xflow_tpu/parallel/step.py:782-810 (B4s the compact wire's u8 and the full wire's "
    "int32 field planes); no pl.pallas_call in the reference"
)
K6_FIELDS_REPLACES = (
    "xflow_tpu/parallel/step.py:691-701 (B4s flat_slots) over cw_cs (:727-731) and cw_hs "
    "(:758-762); no pl.pallas_call in the reference"
)
MVM_LIBRARY_WHY_NULL = ("no single PyTorch call computes MVM's fused per-field sums, "
                        "product and guarded gradient (with the gather, scatter and "
                        "log-loss in K2)")


def fm_logit_bound(keys, x, w, v):
    """Phase 6's bound on the logit's float32 rounding, both sides
    (k2_tolerances' ``dlogit``): 2 gamma times the summed magnitudes."""
    import torch

    live = keys >= 0
    kl = keys.clamp(min=0).long()
    xk = (live.double() if x is None else x.double()) * live
    mag = (w[kl, 0].double() * xk).abs().sum(1)
    vx = v[kl].double() * xk[..., None]
    s = vx.sum(1)
    mag = mag + (2 * s.abs() * vx.abs().sum(1) + (vx * vx).sum(1)).sum(1)
    return 2 * EPS32 * (keys.shape[1] + v.shape[1] + 4) * mag


def mvm_tolerances(keys, fields, x, labels, weights, num_real, v, s: int,
                   logit_only: bool = False) -> dict:
    """Bounds on K1's and K2's MVM form against their plain versions for
    one batch, in float64 from the inputs (``keys`` and ``fields`` hold
    the hot plane ahead of the cold one; -1 keys and fields outside
    [0, s) are dropped).  Per side: a field's 1 + sum within EPS32 (n +
    1) of its n slots' summed magnitudes plus |1 + sum|; the product
    within the sum of each factor's error times the other factors'
    product, plus EPS32 (fields + 1) of itself; the logit within the
    sum of those plus EPS32 (D + 1) of sum |prod - 1|; a slot's
    prod / own within the product's error over |own| plus |prod| times
    own's error over own^2 plus EPS32 of itself, and, where own's error
    reaches the guard's 1e-12 (``straddle``: one side may zero it), its
    whole magnitude; then the residual and the scatter as phase 6's
    k2_tolerances, each side's bound taken twice.  Returns {"logit" [B]
    (both sides), "straddle" [B, N]} and, unless ``logit_only``, "v"
    [rows of v, D] per-element tolerances and "logloss"."""
    import torch

    b, n = keys.shape
    d = v.shape[1]
    dev = keys.device
    live = (keys >= 0) & (fields >= 0) & (fields < s)
    kl = keys.clamp(min=0).long()
    xk = (torch.ones((b, n), dtype=torch.float64, device=dev) if x is None
          else x.double()) * live
    vx = v[kl].double() * xk[..., None]
    f = torch.where(live, fields.long(), torch.full_like(kl, s))
    idx = (torch.arange(b, device=dev)[:, None] * (s + 1) + f).reshape(-1)

    def per_field(vals):
        out = torch.zeros((b * (s + 1), vals.shape[-1]), dtype=torch.float64, device=dev)
        out.index_add_(0, idx, vals.reshape(-1, vals.shape[-1]))
        return out.view(b, s + 1, -1)[:, :s]

    own = 1.0 + per_field(vx)
    cnt = per_field(live.double()[..., None])
    err_own = EPS32 * ((cnt + 1) * per_field(vx.abs()) + own.abs())
    ones = torch.ones((b, 1, d), dtype=torch.float64, device=dev)
    pre = torch.cumprod(torch.cat([ones, own[:, :-1]], 1), 1)
    suf = torch.cumprod(torch.cat([ones, own.flip(1)[:, :-1]], 1), 1).flip(1)
    excl = pre * suf  # prod / own, exactly, [B, S, D]
    prod = pre[:, -1] * own[:, -1]
    present = (cnt[..., 0] > 0).sum(1, keepdim=True).double()
    err_prod = (err_own * excl.abs()).sum(1) + EPS32 * (present + 1) * prod.abs()
    logit = (prod - 1.0).sum(1)
    dlogit = 2 * (err_prod.sum(1) + EPS32 * (d + 1) * (prod - 1.0).abs().sum(1))
    gidx = f.clamp(max=s - 1)[..., None].expand(-1, -1, d)
    o, eo = own.gather(1, gidx), err_own.gather(1, gidx)
    straddle = (o.abs() - eo <= 1e-12) & live[..., None]
    out = {"logit": dlogit, "straddle": straddle.any(-1)}
    if logit_only:
        return out
    g = excl.gather(1, gidx)
    safe = torch.where(o == 0, torch.ones_like(o), o)
    err_g = (err_prod[:, None, :] / safe.abs() + prod.abs()[:, None, :] * eo / safe.square()
             + EPS32 * g.abs())
    err_g = torch.where(straddle, g.abs() * (1 + 1e-3), err_g)
    p = 1.0 / (1.0 + torch.exp(-logit))
    p = torch.where(logit < -30, torch.full_like(p, 1e-6), p)
    p = torch.where(logit > 30, torch.ones_like(p), p)
    dp = p * (1 - p) * dlogit + 4 * EPS32 * p
    dp = dp + torch.where((logit + 30).abs() <= dlogit, 1e-6, 0.0)
    y, wt = labels.double(), weights.double()
    r = (p - y) * wt / num_real
    dr = dp * wt / num_real + 4 * EPS32 * r.abs()
    occ = g * xk[..., None] * r[:, None, None]
    err = (xk.abs()[..., None] * (err_g * r.abs()[:, None, None] + g.abs() * dr[:, None, None])
           + 2 * EPS32 * occ.abs())
    flat = kl[live]
    t = v.shape[0]
    n_row = torch.bincount(flat, minlength=t).double()[:, None]

    def scatter(vals):
        acc = torch.zeros((t, d), dtype=torch.float64, device=dev)
        return acc.index_add_(0, flat, vals[live])

    out["v"] = 2 * (scatter(err) + EPS32 * (n_row + 4) * scatter(occ.abs()))
    pc = p.clamp(1e-6, 1 - 1e-6)
    ll = -(y * torch.log(pc) + (1 - y) * torch.log(1 - pc)) * wt
    dll = dp / torch.minimum(pc, 1 - pc) * wt
    out["logloss"] = 2 * (float(dll.sum()) + EPS32 * (b + 4) * float(ll.abs().sum()))
    return out


def view_fields(view: dict):
    """A view's field plane as the bounds read it: the hot fields (when
    there is a hot plane) ahead of the cold ones, int64."""
    import torch

    fields = view["fields"].long()
    if "hot_fields" in view:
        fields = torch.cat([view["hot_fields"].long(), fields], dim=1)
    return fields


def mvm_bounds(view: dict, dim: int, hot_size: int, train: bool, index: bool = False) -> dict:
    """K1's (``train`` False: v rows read, pctr written) or K2's (v rows
    read, gradient rows read and written; K4's slot plane in
    ``index`` mode) least time on this card for THIS batch: each byte
    once, or about 2D (K1) or 5D (K2) float32 operations a live slot
    and 2D a present field, whichever is longer."""
    import torch

    keys, hot = view["ckeys"], view.get("hot")
    live_keys, hot_bytes = hot_stream(keys, hot, hot_size)
    b, k = keys.shape
    kh = hot.shape[1] if hot is not None else 0
    # keys, the hot plane at its wire width, the field planes, and
    # labels and weights (K2) or pctr (K1)
    stream = (4 * b * k + hot_bytes + b * (k + kh) * view["fields"].element_size()
              + (2 * b * view["labels_u8"].element_size() if train else 4 * b))
    rows = int(torch.unique(live_keys).numel())
    live = int(live_keys.numel())
    used = stream + rows * (3 if train else 1) * 4 * dim + (4 * b * k if index else 0)
    ops = live * dim * (7 if train else 4) + (b * 30 if train else 0)
    used_ms = used / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(used_ms, ops_ms),
            "bound_by": "bytes" if used_ms >= ops_ms else "operations",
            "bound_bytes": used, "bound_ops": ops, "distinct_rows": rows,
            "live_slots": live}


def fresh_init(dev, cfg) -> dict:
    """A Trainer's seeded initial state for ``cfg`` on the card, as
    numpy (the paths of a cell start from it on the card and the CPU)."""
    from xflow_tpu_torch.convert import state_to_numpy
    from xflow_tpu_torch.trainer import Trainer

    trainer = Trainer(dataclasses.replace(cfg, metrics_out=""), device=dev,
                      log=lambda _: None)
    init = state_to_numpy(trainer.state, aux=True)
    trainer.close()
    del trainer
    return init


def phase_wide_fm(dev, workdir: str, dense: dict) -> dict:
    """Phase 21 (C1): K1 and K2's FM form at D = 33, 64 and 156 (two to
    five tiles of 32) against their plain versions at T = 2^20: K1 in
    every serving bucket (phase 2's tolerances plus phase 6's logit
    bound: 156 factors of s^2 - s2 cancel), K2 on a 65,536-row compact
    batch and a 1,024-row full-wire Zipf batch (phase 6's bounds); K1
    and K2 at D = 64 timed with their byte bounds; a reference-shaped
    v_dim = 64 FM artifact (T = 2^22) served as phases 3-4 serve; and
    one dispatch of v_dim = 64 FM trained on the card and the CPU from
    the same state (TRAIN_BOUNDS)."""
    import torch

    from xflow_tpu_torch.ops.score import score, score_plain
    from xflow_tpu_torch.ops.train import train_plain, train_step

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    t = 1 << WIDE_T_LOG2
    w = torch.randn((t, 1), generator=g, device=dev) * 3.0
    w[:64] = 20.0
    w[64:128] = -20.0
    v_all = torch.randn((t, max(WIDE_DIMS)), generator=g, device=dev)
    k1 = {"max_abs_err": 0.0, "cases": 0}
    k2 = {"max_abs_err_g": 0.0, "max_err_over_tol": 0.0, "max_abs_err_logloss_sum": 0.0}
    timings = []
    for d in WIDE_DIMS:
        v = (v_all[:, :d] * (0.3 * math.sqrt(D / d))).contiguous()
        for b in BUCKETS:
            for full in (False, True):
                keys, x = make_keys(b, t, g, dev, full)
                got_p, got_l = score(keys, x, w, v, return_logit=True)
                want_p, want_l = score_plain(keys, x, w, v, return_logit=True)
                torch.cuda.synchronize()
                ltol = LOGIT_ATOL + LOGIT_RTOL * want_l.abs() + fm_logit_bound(keys, x, w, v)
                ptol = PCTR_ATOL + want_p * (1 - want_p) * ltol
                if (float(((got_l - want_l).abs() - ltol).max()) > 0
                        or float(((got_p - want_p).abs() - ptol).max()) > 0
                        or not bool(torch.isfinite(got_p).all())):
                    raise AssertionError(f"K1 FM at D={d} disagrees with score_plain: B={b}")
                k1["max_abs_err"] = max(k1["max_abs_err"], float((got_p - want_p).abs().max()))
                k1["cases"] += 1
        for b, full, zipf in ((TRAIN_BATCHES[-1], False, False), (TRAIN_BATCHES[0], True, True)):
            case = f"D={d} B={b} {'full zipf' if full else 'compact uniform'}"
            check_k2(case, *k2_inputs(b, w, g, dev, full, zipf), w, v, k2)
        torch.cuda.empty_cache()
        if d != 64:
            continue
        pool = [(torch.randint(0, t, (BUCKETS[-1], K), generator=g, device=dev,
                               dtype=torch.int32),) for _ in range(KEY_POOL)]
        args = [(pool[i % KEY_POOL][0], None, w, v) for i in range(TIMED_RUNS)]
        timings.append({"kernel": "score (fm, D tiled)", "B": BUCKETS[-1], "K": K, "D": d,
                        "ms": time_device_ms(score, args),
                        "host_path_ms": time_host_path_ms(score, args),
                        "plain_ms": time_device_ms(score_plain, args),
                        **bounds(pool[0][0], None, d), "library_ms": None,
                        "library_why_null": "no single PyTorch call scores FM"})
        keys, x, labels, weights, num_real = k2_inputs(TRAIN_BATCHES[-1], w, g, dev, False,
                                                       False)
        gw, gv = torch.zeros_like(w), torch.zeros_like(v)
        acc = torch.zeros(2, dtype=torch.float64, device=dev)
        flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
        kargs = [(keys, None, labels, weights, num_real, w, v, gw, gv, acc)] * TIMED_RUNS
        timings.append({"kernel": "train_step (fm, D tiled)", "B": TRAIN_BATCHES[-1], "K": K,
                        "D": d, "ms": time_device_ms(train_step, kargs, prelude=flush.zero_),
                        "plain_ms": time_device_ms(train_plain, kargs, prelude=flush.zero_,
                                                   chunk_size=5),
                        **k2_bounds(keys, None, labels, d), "library_ms": None,
                        "library_why_null": "no single PyTorch call computes the gather, "
                        "logit, residual, scatter-add and log-loss"})
        del flush, gw, gv
    for row in timings:
        log(json.dumps(dict(row, phase=21)))
    del w, v_all, v
    torch.cuda.empty_cache()
    serve = phase_main_path(dev, FM64_T_LOG2, workdir, model="fm", v_dim=64, phase=(21, 21))
    torch.cuda.empty_cache()
    one = single_shard(dense["data"], workdir)
    mode = {"v_dim": 64, "epochs": 1}
    init = fresh_init(dev, mode_config("fm", FM64_T_LOG2, one, "", **mode))
    run = run_mode(dev, "fm", FM64_T_LOG2, one, init, mode, "fm_v64_dense", workdir,
                   evaluate=False)
    row = dict(run["row"], phase=21)
    log(json.dumps(row))
    del run, init
    torch.cuda.empty_cache()
    return {"k1": k1, "k2": k2, "timings": timings, "serve": serve, "train": row}


def mvm_planes(b: int, kc: int, kh: int, h: int, t: int, g, dev) -> dict:
    """K1's MVM inputs at a serving shape: make_keys' cold plane cut to
    ``kc`` slots, a u16 hot plane of ``kh`` slots (hot_keys), and u8
    field planes over MVM_FIELDS with about 5 % at the u8 clamp's 255."""
    import torch

    def fields(shape):
        f = torch.randint(0, MVM_FIELDS, shape, generator=g, device=dev)
        f[torch.rand(shape, generator=g, device=dev) < 0.05] = 255
        return f.to(torch.uint8).contiguous()

    keys = make_keys(b, t, g, dev, False)[0][:, :kc].contiguous()
    out = {"ckeys": keys, "fields": fields((b, kc)), "max_fields": MVM_FIELDS}
    if kh:
        out.update(hot=hot_keys(b, kh, h, g, dev, True), hot_fields=fields((b, kh)))
    return out


def phase_mvm_k1(dev, t_log2: int) -> dict:
    """Phase 23: K1's MVM form against score_plain at T = 2^24, D = 10:
    the flagship ``mvm`` planes (12 cold + 32 hot slots, u16 ids at
    H = 2^14), with the bf16 flag, and ``mvm_nohot``'s 40 cold slots,
    every serving bucket; the logit within mvm_tolerances' bound and
    pctr within PCTR_ATOL plus that bound through the sigmoid's slope.
    Rows [0, 64) of v hold 1 and rows [64, 128) -3, so steered rows
    reach the clamps.  Then K1 timed at B = 512 on the flagship planes."""
    import torch

    from xflow_tpu_torch.ops.hot import to_bf16_f32
    from xflow_tpu_torch.ops.score import hot_plane_keys, score, score_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    t, h = 1 << t_log2, 1 << HOT_GEOMETRY["mvm"]["hot_size_log2"]
    v = torch.randn((t, D), generator=g, device=dev) * 0.1
    v[:64] = 1.0
    v[64:128] = -3.0
    worst = {"max_abs_err": 0.0, "cases": 0, "clamped": 0}
    for case, kc, kh, bf16 in (("mvm u16 H=2^14", 12, 32, False),
                               ("mvm u16 H=2^14 bf16", 12, 32, True),
                               ("mvm_nohot K=40", K, 0, False)):
        for b in BUCKETS:
            pl = mvm_planes(b, kc, kh, h, t, g, dev)
            kw = dict(hot=pl.get("hot"), hot_size=h if kh else 0, hot_bf16=bf16,
                      **field_kw(pl))
            got_p, got_l = score(pl["ckeys"], None, None, v, True, **kw)
            want_p, want_l = score_plain(pl["ckeys"], None, None, v, True, **kw)
            torch.cuda.synchronize()
            keys = pl["ckeys"].long()
            if kh:
                keys = torch.cat([hot_plane_keys(pl["hot"], h), keys], dim=1)
            vb = v
            if bf16:  # the bound over the rounded head both sides read
                vb = v.clone()
                vb[:h] = to_bf16_f32(v[:h])
            ltol = 1.01 * mvm_tolerances(keys, view_fields(pl), None, None, None, 1.0, vb,
                                         MVM_FIELDS, logit_only=True)["logit"] + 1e-7
            ptol = PCTR_ATOL + want_p * (1 - want_p) * ltol
            if (float(((got_l - want_l).abs() - ltol).max()) > 0
                    or float(((got_p - want_p).abs() - ptol).max()) > 0
                    or not bool(torch.isfinite(got_p).all())):
                raise AssertionError(f"K1 MVM form disagrees with score_plain: {case} B={b}")
            worst["max_abs_err"] = max(worst["max_abs_err"], float((got_p - want_p).abs().max()))
            worst["clamped"] += int((want_l.abs() > 30).sum())
            worst["cases"] += 1
    if not worst["clamped"]:
        raise AssertionError("phase 23 did not reach the sigmoid's clamps")
    b = BUCKETS[-1]
    pool = [mvm_planes(b, 12, 32, h, t, g, dev) for _ in range(KEY_POOL)]
    args = [(pool[i % KEY_POOL],) for i in range(TIMED_RUNS)]

    def kernel(pl):
        return score(pl["ckeys"], None, None, v, hot=pl["hot"], hot_size=h, **field_kw(pl))

    def plain(pl):
        return score_plain(pl["ckeys"], None, None, v, hot=pl["hot"], hot_size=h,
                           **field_kw(pl))

    worst["timing"] = {"kernel": "score (mvm)", "model": "mvm", "B": b, "Kc": 12, "Kh": 32,
                       "H": h, "D": D, "plane": "u16, u8 fields",
                       "ms": time_device_ms(kernel, args),
                       "host_path_ms": time_host_path_ms(kernel, args),
                       "plain_ms": time_device_ms(plain, args),
                       **mvm_bounds(pool[0], D, h, train=False), "library_ms": None,
                       "library_why_null": MVM_LIBRARY_WHY_NULL}
    log(json.dumps({"phase": 23, "k1_mvm": worst}))
    del v, pool
    return worst


def clamp_fields(slots, mask) -> np.ndarray:
    """A field plane as the u8 wire carries it (outside [0, 255] → 255)
    and K6 decodes it (0 on padding)."""
    u8 = np.where((slots < 0) | (slots > 255), 255, slots)
    return np.where(mask > 0, u8, 0).astype(np.uint8)


def check_k6_fields(cfg, trainer, dev) -> tuple[list, list]:
    """Phase 22: K6 with the field streams against its plain version,
    exactly, and against the batch's own planes (keys, labels, weights,
    hot ids, and the field ids under the u8 clamp, 0 on padding), on
    ``hot_k6_batches`` (the path's batch 0, the 4-slot overflow, an
    empty hot plane) and batch 0 with 5 % of its field ids past
    max_fields (up to 300) and 5 % negative; then K6 timed on batch 0
    (device ms behind _sleep, plain ms, the byte bound over every
    plane read and written)."""
    import torch

    from xflow_tpu_torch.io.batch import Batch
    from xflow_tpu_torch.io.compact import compact_batch
    from xflow_tpu_torch.ops.wire import dict_decode, dict_decode_plain, to_device

    cases = hot_k6_batches(cfg, trainer)
    name, base, kh = cases[0]
    rng = np.random.default_rng(SEED)

    def scramble(slots):
        r = rng.random(slots.shape)
        out = np.where(r < 0.05, rng.integers(cfg.max_fields, 301, slots.shape), slots)
        return np.where((r >= 0.05) & (r < 0.1), -rng.integers(1, 50, slots.shape),
                        out).astype(np.int32)

    cases.append((f"{cfg.model} ids outside [0, max_fields)",
                  Batch(base.keys, scramble(base.slots), base.vals, base.mask, base.labels,
                        base.weights, base.hot_keys, scramble(base.hot_slots),
                        base.hot_vals, base.hot_mask), kh))
    checks, timings = [], []
    for name, batch, kh in cases:
        cb = compact_batch(batch, cfg.table_size, cfg.hot_size)
        wire = cb.wire(ship_slots=True)
        planes = to_device(wire, dev)
        kc = batch.max_nnz
        got = dict_decode(planes, kc, kh)
        want = dict_decode_plain(planes, kc, kh)
        torch.cuda.synchronize()
        truth = (np.where(batch.mask > 0, batch.keys, -1), batch.labels, batch.weights,
                 np.where(batch.hot_mask > 0, batch.hot_keys, -1),
                 clamp_fields(batch.slots, batch.mask),
                 clamp_fields(batch.hot_slots, batch.hot_mask))
        labels = ("ckeys", "labels", "weights", "hot", "fields", "hot_fields")
        err = {"plain": 0.0, "batch": 0.0}
        if len(got) != 6 or len(want) != 6:
            raise AssertionError(f"K6 field streams {name}: {len(got)} planes, want 6")
        for gg, ww, tt, label in zip(got, want, truth, labels):
            got_np = gg.cpu().numpy().astype(np.float64)
            err["plain"] = max(err["plain"],
                               float(np.abs(got_np - ww.cpu().numpy()).max(initial=0)))
            err["batch"] = max(err["batch"], float(np.abs(got_np - tt).max(initial=0)))
            if gg.dtype != ww.dtype or not torch.equal(gg, ww):
                raise AssertionError(f"K6 field streams {name}: {label} differs from the "
                                     "plain version")
            if not np.array_equal(gg.cpu().numpy(), tt.astype(gg.cpu().numpy().dtype)):
                raise AssertionError(f"K6 field streams {name}: {label} differs from the batch")
        checks.append({"case": name, "B": batch.batch_size, "K": kc, "hot_nnz": kh,
                       "n_cold": cb.n_cold, "n_hot": cb.n_hot,
                       "fields_at_255": int((truth[4] == 255).sum() + (truth[5] == 255).sum()),
                       "max_abs_err_plain": err["plain"], "max_abs_err_batch": err["batch"],
                       "exact": True})
        if name.endswith("main path batch 0"):
            in_bytes = sum(int(a.nbytes) for k, a in wire.items() if k != "cw_cun")
            out_bytes = batch.batch_size * (5 * (kc + kh) + 2)
            timings.append(hot_timing_row(
                "dict_decode (field streams)", dict_decode, dict_decode_plain,
                [(planes, kc, kh)] * TIMED_RUNS,
                {"bound_ms": (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes", "bytes": in_bytes + out_bytes}, phase=22,
                model=cfg.model, B=batch.batch_size, K=kc, Kh=kh,
                library_why_null=K6_LIBRARY_WHY_NULL))
    log(json.dumps({"phase": 22, "k6_fields": checks}))
    return checks, timings


def guard_tables(view: dict, tables: dict, h: int) -> tuple[dict, list]:
    """Copies of ``tables`` in which the guard fires on ``view``: for
    each row whose field 0 holds exactly one live slot, and that on the
    cold plane, that slot's v[key, 0] = -1 (x = 1 on the compact wire),
    so its own-field factor is 1 + (-1) = 0 exactly.  Returns the
    tables and the (row, slot) pairs."""
    import torch

    keys, fields = view["ckeys"], view["fields"].long()
    live = keys >= 0
    in0 = (fields == 0) & live
    one = in0.sum(1) == 1
    from xflow_tpu_torch.ops.score import hot_plane_keys

    if "hot" in view:
        hot_live = hot_plane_keys(view["hot"], h) >= 0
        one &= ((view["hot_fields"].long() == 0) & hot_live).sum(1) == 0
    rows = one.nonzero()[:, 0]
    slots = in0[rows].int().argmax(1)
    # a key that another field's slot also holds would move that field too
    others = keys[live & (fields != 0)]
    if "hot" in view:
        others = torch.cat([others, hot_plane_keys(view["hot"], h)[
            hot_live & (view["hot_fields"].long() != 0)]])
    clean = ~torch.isin(keys[rows, slots], others)
    rows, slots = rows[clean], slots[clean]
    v = tables["v"]["param"].clone()
    v[keys[rows, slots].long(), 0] = -1.0
    return {"v": {"param": v}}, list(zip(rows.tolist(), slots.tolist()))


def check_mvm_k2(case: str, form: str, view: dict, tables: dict, h: int, worst: dict,
                 bf16: bool = False) -> None:
    """K2's MVM form against train_plain on one batch or slice
    (``k2_hot_call``'s forms: "dense", "hybrid" — index mode, with a
    head buffer when the view has a hot plane — and "window"), compared
    in table-row space within mvm_tolerances' per-row bound over the hot
    and cold planes together (in window form over [v; snapshot], the
    cold plane's keys < H as rows T + key); the log-loss sum within its
    bound, the count exact; with ``bf16``, check_bf16's three rules at
    this bound."""
    import torch

    from xflow_tpu_torch.ops.score import hot_plane_keys
    from xflow_tpu_torch.ops.train import train_plain, train_step

    v = tables["v"]["param"]
    t = v.shape[0]
    snap = {"v": (v[:h] * 0.5).contiguous()} if form == "window" else None
    outs = []
    for fn in (train_step, train_plain):
        args, kw, rows = k2_hot_call(form, view, tables, h, snap, bf16)
        fn(*args, **kw)
        outs.append(rows())
    torch.cuda.synchronize()
    ck = view["ckeys"].long()
    tv = v
    if snap is not None:
        ck = torch.where((ck >= 0) & (ck < h), ck + t, ck)
        tv = torch.cat([v, snap["v"]])
    keys = ck
    if "hot" in view:
        keys = torch.cat([hot_plane_keys(view["hot"], h), ck], dim=1)
    tols = mvm_tolerances(keys, view_fields(view), None, view["labels_u8"],
                          view["weights_u8"], view["num_real"], tv, view["max_fields"])
    tol = tols["v"]
    if snap is not None:
        tol = tol[:t].index_add(0, torch.arange(h, device=v.device), tol[t:])
    (gk, acc), (gp, pacc) = outs
    if bf16:
        check_bf16(case, form, view, tables, h, gk, gp, acc, pacc, {"v": tol}, worst)
    else:
        diff = (gk["v"].double() - gp["v"].double()).abs()
        excess = float((diff - tol).max())
        if excess > 0 or not bool(torch.isfinite(gk["v"]).all()):
            raise AssertionError(f"K2 MVM {form} form disagrees with train_plain: {case} "
                                 f"excess {excess}")
        worst["max_abs_err_g"] = max(worst["max_abs_err_g"], float(diff.max()))
        ratio = diff / torch.where(tol > 0, tol, 1.0)
        worst["max_err_over_tol"] = max(worst["max_err_over_tol"], float(ratio.max()))
    if abs(float(acc[0]) - float(pacc[0])) > tols["logloss"] or float(acc[1]) != float(pacc[1]):
        raise AssertionError(f"K2 MVM {form} form log-loss/count {acc.tolist()} vs plain "
                             f"{pacc.tolist()} ({case})")
    worst["straddling_slots"] += int(tols["straddle"].sum())
    worst["cases"] += 1


def check_mvm_guard(view: dict, tables: dict, h: int, worst: dict) -> None:
    """K2's dense MVM form where the guard fires (guard_tables): within
    check_mvm_k2's bound, and the plain version's gradient of every
    guarded slot exactly 0 in factor 0."""
    from xflow_tpu_torch.ops.train import occurrence_grads

    gt, guarded = guard_tables(view, tables, h)
    if len(guarded) < 100:
        raise AssertionError(f"the guard batch holds {len(guarded)} guarded slots")
    check_mvm_k2("mvm guard batch", "dense", view, gt, h, worst)
    occ, _, _, _ = occurrence_grads(view["ckeys"], None, view["labels_u8"],
                                    view["weights_u8"], view["num_real"], None,
                                    gt["v"]["param"], hot=view.get("hot"), hot_size=h,
                                    **field_kw(view))
    kh = view["hot"].shape[1] if "hot" in view else 0
    vals = occ["v"][[r for r, _ in guarded], [kh + s for _, s in guarded], 0]
    if bool(vals.any()):
        raise AssertionError("the plain version's guard did not zero the guarded slots")
    worst["guarded_slots"] = len(guarded)


def time_mvm_k2(label: str, form: str, view: dict, tables: dict, h: int, flush,
                phase: int = 24, name: str | None = None) -> dict:
    """K2's MVM form timed alone on one batch (or slice) of its path,
    beside its plain version (k2_hot_call's buffers, the plan made once
    before; each call behind an L2 flush), with mvm_bounds."""
    from xflow_tpu_torch.ops.train import train_plain, train_step

    snap = ({"v": (tables["v"]["param"][:h] * 0.5).contiguous()} if form == "window"
            else None)
    args, kw, _ = k2_hot_call(form, view, tables, h, snap)

    def kernel():
        train_step(*args, **kw)

    def plain():
        train_plain(*args, **kw)

    dim = tables["v"]["param"].shape[1]
    row = {"kernel": name or f"train_step (mvm: {form})", "model": "mvm", "path": label,
           "B": view["ckeys"].shape[0], "Kc": view["ckeys"].shape[1],
           "Kh": view["hot"].shape[1] if "hot" in view else 0, "H": h, "D": dim,
           "ms": time_device_ms(kernel, [()] * TIMED_RUNS, prelude=flush.zero_),
           "plain_ms": time_device_ms(plain, [()] * TIMED_RUNS, prelude=flush.zero_,
                                      chunk_size=5),
           **mvm_bounds(view, dim, h, train=True, index=form == "hybrid"),
           "library_ms": None, "library_why_null": MVM_LIBRARY_WHY_NULL}
    log(json.dumps(dict(row, phase=phase)))
    return row


def phase_mvm(dev, t_log2: int, workdir: str, dense: dict) -> dict:
    """Phases 22-27 at the flagship ``mvm`` (HOT_GEOMETRY: 12 cold + 32
    hot slots, H = 2^14, D = 10, max_fields = 39, T = 2^24, batch
    65,536; phase 8's shards) and ``mvm_nohot`` (40 cold slots): 23 K1's
    MVM form against its plain version; 25 serving a hot ``mvm``
    artifact; 26 training on the default input path (native text,
    dictionary wire with the field streams) in dense, hybrid (sequential
    + sparse inner, microbatch 128) and hot-inner (microbatch 128,
    ``hot_windowend`` auto = sparse) mode, 2 epochs each from one seeded
    initial state, the card against the CPU within TRAIN_BOUNDS (the
    sequential forms through ``lockstep_tables``), exact launches, the
    eval AUC inside the planted bars, the sync guard on the sequential
    paths' first dispatch; on the paths' own batches 22 K6's field
    streams (exactly) and 24 K2's MVM forms (dense, hybrid, window and
    index mode on the 65,536-row batch, hybrid and window on slice 0,
    bf16, the guard) against their plain versions, and timed;
    27 ``mvm_nohot`` dense on the default path."""
    import torch

    from xflow_tpu_torch.parallel.step import hot_windowend

    data, bars = dense["data"], dense["bars"]
    out = {"rows": [], "checks": {}, "timings": [], "launches_by_path": {}}
    k2w = {"max_abs_err_g": 0.0, "max_err_over_tol": 0.0, "cases": 0, "straddling_slots": 0}
    out["checks"]["k1"] = phase_mvm_k1(dev, t_log2)
    torch.cuda.empty_cache()
    out["serve"] = phase_main_path(dev, t_log2, workdir, hot=True, model="mvm",
                                   phase=(25, 25))
    torch.cuda.empty_cache()
    geom = HOT_GEOMETRY["mvm"]
    h = 1 << geom["hot_size_log2"]
    init = fresh_init(dev, mode_config("mvm", t_log2, data, "", **geom))
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)

    def book(label, run, **extra):
        row = dict(run["row"], phase=26 if label != "nohot_dense" else 27, **extra)
        out["rows"].append(row)
        out["launches_by_path"][f"mvm {label}"] = row["launches"]
        log(json.dumps(row))

    for label, mode in HOT_MODES:
        seq = mode.get("update_mode") == "sequential"
        run = run_mode(dev, "mvm", t_log2, data, init, dict(geom, **mode), label, workdir,
                       keep=True, bars=bars, lockstep=seq, sync_check=seq)
        trainer, arrays = run["trainer"], run["shipped"][0]
        cfg = trainer.cfg
        tables = trainer.state["tables"]
        if seq:
            rows = arrays["ckeys"].shape[0] // SEQ_MICROBATCH
            view = {k: a[:rows] for k, a in arrays.items() if isinstance(a, torch.Tensor)}
            view["num_real"] = arrays["slice_num_real"][0]
        else:
            view = dict(arrays)
        view["max_fields"] = cfg.max_fields
        form = {"hot_dense": "dense", "hot_hybrid_mb128": "hybrid",
                "hot_inner_mb128": "window"}[label]
        if form == "dense":
            out["hot_mass"] = trainer.hot_mass
            out["truncation"] = truncated_share(cfg, trainer, run["shipped"])
            checks, timings = check_k6_fields(cfg, trainer, dev)
            out["checks"]["k6_fields"] = checks
            out["timings"] += timings
            cold = {k: a for k, a in view.items() if k not in ("hot", "hot_fields")}
            for form, v_ in (("dense", view), ("hybrid", view), ("window", view),
                             ("hybrid", cold)):
                what = "index (cold plane)" if v_ is cold else form
                check_mvm_k2(f"mvm batch 0 {what}", form, v_, tables, h, k2w)
            check_mvm_k2("mvm batch 0 dense bf16", "dense", view, tables, h, k2w, bf16=True)
            check_mvm_guard(view, tables, h, k2w)
            out["timings"].append(time_mvm_k2(label, "dense", view, tables, h, flush))
            out["timings"].append(time_mvm_k2(label, "hybrid", cold, tables, h, flush,
                                              name="train_step (mvm: index)"))
            for form in ("hybrid", "window"):  # the 65,536-row batch in those forms
                out["timings"].append(time_mvm_k2(
                    label, form, view, tables, h, flush,
                    name=f"train_step (mvm: {form}, 65,536 rows)"))
        else:
            check_mvm_k2(f"mvm {label} slice 0", form, view, tables, h, k2w)
            out["timings"].append(time_mvm_k2(label, form, view, tables, h, flush))
        torch.cuda.empty_cache()
        book(label, run, windowend=hot_windowend(cfg) if form == "window" else None,
             hot_mass=trainer.hot_mass)
        del run, trainer, arrays, view, tables
        torch.cuda.empty_cache()
    run = run_mode(dev, "mvm", t_log2, data, init, dict(MVM_NOHOT), "nohot_dense", workdir,
                   keep=True, bars=bars)
    view = dict(run["shipped"][0], max_fields=run["trainer"].cfg.max_fields)
    check_mvm_k2("mvm_nohot batch 0 dense", "dense", view, run["trainer"].state["tables"], h,
                 k2w)
    out["timings"].append(time_mvm_k2("nohot_dense", "dense", view,
                                      run["trainer"].state["tables"], h, flush, phase=27))
    book("nohot_dense", run)
    out["checks"]["k2"] = k2w
    log(json.dumps({"phase": 24, "k2_mvm": k2w}))
    del run, view, flush, init
    torch.cuda.empty_cache()
    return out


def mvm_train_rows(mvm: dict, hot: dict, modes: dict, train_path: dict, card: str) -> list:
    """The ``train`` line's rows for the MVM paths (phases 26-27):
    device busy from the launches times each kernel form's device ms
    on the path's own batch or slice 0 (phase 24), K6 with the field
    streams (phase 22), K3 over the whole table (phase 8's fm v table:
    the same [2^24, 10] FTRL pass), K3 over the head rows and K5's fold
    (phase 20's fm rows: the same widths), K4 (phase 14)."""
    ms = {r["kernel"]: r["ms"] for r in mvm["timings"] if r.get("path") != "nohot_dense"}
    hot_ms = {(r["kernel"], r.get("model")): r["ms"] for r in hot["timings"]}
    fm = next(r for r in train_path["rows"] if r["model"] == "fm")
    k3_v = next(r["ms"] for r in fm["k3_main_path"] if r["table"] == "v")
    k4_ms = {r["path"]: r["ms"] for r in modes["timings"]
             if r["kernel"] == "consolidate_keys" and r["model"] == "fm"}
    nohot_k2 = next(r["ms"] for r in mvm["timings"] if r.get("path") == "nohot_dense")
    rows = []
    for row in mvm["rows"]:
        n = row["launches"]
        form = {"hot_dense": "dense", "hot_hybrid_mb128": "hybrid",
                "hot_inner_mb128": "window", "nohot_dense": "dense"}[row["mode"]]
        k2 = nohot_k2 if row["mode"] == "nohot_dense" else ms[f"train_step (mvm: {form})"]
        busy_ms = n["train_step"] * k2 + n["dict_decode"] * ms["dict_decode (field streams)"]
        k3_head = hot_ms[("optim_update (head rows)", "fm")]
        if form == "dense":
            busy_ms += row["steps"] * k3_v
        elif form == "hybrid":
            busy_ms += (n["optim_update"] * k3_head
                        + n["touched_update"] * hot_ms[("touched_update (fold)", "fm")]
                        + n["consolidate_keys"] * k4_ms["sequential main path, slice 0"])
        else:
            busy_ms += n["optim_update"] * k3_head + n["consolidate_keys"] * k4_ms[
                "sparse main path"]
        busy = busy_ms / 1e3
        rows.append({
            "model": "mvm", "mode": row["mode"], "card": card,
            "hot_mass": row.get("hot_mass"), "windowend": row.get("windowend"),
            "truncation": mvm["truncation"] if row["mode"] != "nohot_dense" else None,
            "examples_per_sec": row["examples_per_sec"],
            "step_time_p50": row["step_time_p50"], "phases": row["phases"],
            "put_batch_ms_per_dispatch": [p["h2d"] / (row["steps"] / TRAIN_EPOCHS) * 1e3
                                          for p in row["phases"]],
            "train_seconds": row["train_seconds"],
            "device_busy_s_from_kernel_times": busy,
            "device_idle_share_from_kernel_times": 1.0 - busy / row["train_seconds"],
            "eval_auc": row["eval"]["auc"], "eval_logloss": row["eval"]["logloss"],
            "auc_floor": train_path["bars"]["floor"],
            "bayes_auc": train_path["bars"]["bayes_auc"],
        })
    return rows


def mvm_kernel_entries(wide: dict, mvm: dict) -> list:
    """The ``kernels`` line's entries for C1's D-tiled FM forms (phase
    21) and MVM's forms (phases 22-27): launches counted on their paths
    (each from 0 just before it), times on the paths' own batches."""
    by_path = mvm["launches_by_path"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_why_null")

    def timing(rows, kernel):
        return next(r for r in rows if r["kernel"] == kernel)

    def launches(kernel, modes):
        return sum(n[kernel] for path, n in by_path.items() if path.split(" ", 1)[1] in modes)

    wk1, wk2 = (timing(wide["timings"], f"{k} (fm, D tiled)") for k in ("score", "train_step"))
    k1 = mvm["checks"]["k1"]["timing"]
    k2 = mvm["checks"]["k2"]
    every = tuple(p.split(" ", 1)[1] for p in by_path)
    entries = [{
        "name": "score (fm, D tiled)", "route": "cuda", "source": "xflow_tpu_torch/csrc/score.cu",
        "replaces": C1_REPLACES + "; " + REPLACES, "launches": wide["serve"]["launches"],
        "launches_of": "the served v_dim=64 fm artifact (phase 21)",
        "max_abs_err": wide["k1"]["max_abs_err"], "host_path_ms": wk1["host_path_ms"],
        **{k: wk1[k] for k in keys}, "shape": {"B": wk1["B"], "K": K, "D": wk1["D"]}}, {
        "name": "train_step (fm, D tiled)", "route": "cuda",
        "source": "xflow_tpu_torch/csrc/train.cu", "replaces": C1_REPLACES + "; " + K2_REPLACES,
        "launches": wide["train"]["launches"]["train_step"],
        "launches_of": "one dispatch of v_dim=64 fm training (phase 21)",
        "max_abs_err": wide["k2"]["max_abs_err_g"],
        "max_err_over_tol": wide["k2"]["max_err_over_tol"],
        **{k: wk2[k] for k in keys}, "shape": {"B": wk2["B"], "K": K, "D": wk2["D"]}}, {
        "name": "score (mvm)", "route": "cuda", "source": "xflow_tpu_torch/csrc/score.cu",
        "replaces": B9_REPLACES, "launches": mvm["serve"]["launches"] + launches("score", every),
        "max_abs_err": mvm["checks"]["k1"]["max_abs_err"], "host_path_ms": k1["host_path_ms"],
        **{k: k1[k] for k in keys},
        "shape": {k: k1[k] for k in ("model", "B", "Kc", "Kh", "H", "D", "plane")}}]
    for form, modes in (("dense", ("hot_dense", "nohot_dense")), ("hybrid", ("hot_hybrid_mb128",)),
                        ("window", ("hot_inner_mb128",))):
        t = timing(mvm["timings"], f"train_step (mvm: {form})")
        entry = {"name": f"train_step (mvm: {form})", "route": "cuda",
                 "source": "xflow_tpu_torch/csrc/train.cu", "replaces": B9_REPLACES,
                 "launches": launches("train_step", modes), "max_abs_err": k2["max_abs_err_g"],
                 "max_err_over_tol": k2["max_err_over_tol"], **{k: t[k] for k in keys},
                 "shape": {k: t[k] for k in ("path", "B", "Kc", "Kh", "H", "D")}}
        if form == "hybrid":
            entry["index_mode_cold_plane"] = {
                k: timing(mvm["timings"], "train_step (mvm: index)")[k] for k in keys}
        if form != "dense":
            entry["batch_65536_rows"] = {
                k: timing(mvm["timings"], f"train_step (mvm: {form}, 65,536 rows)")[k]
                for k in keys}
        if form == "dense":
            entry["guarded_slots_checked"] = k2.get("guarded_slots")
            entry["per_path"] = [r for r in mvm["timings"]
                                 if r["kernel"] == "train_step (mvm: dense)"]
        entries.append(entry)
    k6 = timing(mvm["timings"], "dict_decode (field streams)")
    entries.append({
        "name": "dict_decode (field streams)", "route": "cuda",
        "source": "xflow_tpu_torch/csrc/wire.cu", "replaces": K6_FIELDS_REPLACES,
        "launches": launches("dict_decode", every),
        "max_abs_err": max(max(c["max_abs_err_plain"], c["max_abs_err_batch"])
                           for c in mvm["checks"]["k6_fields"]),
        "max_abs_err_of": "every decoded plane (keys, labels, weights, hot ids, field ids) "
        "against the plain version and the batch's own planes, over "
        + ", ".join(c["case"] for c in mvm["checks"]["k6_fields"]),
        **{k: k6[k] for k in keys}, "shape": {k: k6[k] for k in ("model", "B", "K", "Kh")}})
    return entries


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


def view_keys(view: dict, hot_size: int):
    """A view's key plane as phase 6's bound reads it: the hot plane
    (when there is one, -1 on padding) ahead of the cold one, int64."""
    import torch

    from xflow_tpu_torch.ops.score import hot_plane_keys

    keys = view["ckeys"].long()
    if "hot" in view:
        keys = torch.cat([hot_plane_keys(view["hot"], hot_size), keys], dim=1)
    return keys


def local_keys(view: dict, uk, hot_size: int):
    """A view's key plane (view_keys) as indices into the sorted unique
    keys ``uk``, -1 on padding."""
    import torch

    keys = view_keys(view, hot_size)
    return torch.where(keys >= 0, torch.searchsorted(uk, keys.clamp(min=0)),
                       torch.full_like(keys, -1)).to(torch.int32)


def split_tolerance(name: str, view: dict, num_real: float, uk, before: dict,
                    hot_size: int = 0, max_fields: int = 0):
    """Phase 6's per-row bound on K2's summed gradients (k2_tolerances;
    for MVM, mvm_tolerances), for the slice ``view`` (hot plane and cold
    plane) over the tables as they were before it, gathered at the
    sorted unique keys ``uk``, which hold every live key of the view:
    the [U, width] tolerances of table ``name``."""
    local = local_keys(view, uk, hot_size)
    if "fields" in view:
        return mvm_tolerances(local, view_fields(view), None, view["labels_u8"],
                              view["weights_u8"], num_real, before["v"]["param"],
                              max_fields)["v"]
    v = before["v"]["param"] if "v" in before else None
    tol_w, tol_v, _ = k2_tolerances(local, None, view["labels_u8"], view["weights_u8"],
                                    num_real, before["w"]["param"], v)
    return tol_w if name == "w" else tol_v


def guard_rows(view: dict, num_real: float, uk, before: dict, hot_size: int,
               max_fields: int):
    """MVM: which of the rows ``uk`` hold a slot of ``view`` whose
    own-field factor lies within its rounding of the guard's 1e-12
    (mvm_tolerances' straddle), over the tables as they were before the
    slice: [U] bool."""
    import torch

    local = local_keys(view, uk, hot_size)
    straddle = mvm_tolerances(local, view_fields(view), None, None, None, num_real,
                              before["v"]["param"], max_fields, logit_only=True)["straddle"]
    rows = torch.zeros(uk.numel(), dtype=torch.bool)
    rows[local[straddle].long()] = True
    return rows


def lockstep_tables(card_step, cfg, init: dict, shipped: list, synchronize: bool = True,
                    records: int = 6) -> dict:
    """Replay the sequential batches ``shipped`` from ``init`` on the
    card (``card_step``, the main path's TrainStep) and on the CPU in
    lockstep, slice by slice, each side through the per-slice update the
    main path runs (``TrainStep._update``; with the hot inner,
    ``window_open``, ``window_slice`` per slice and ``window_close``),
    and compare the rows each slice touched (hot and cold keys) and
    each window's close touched.

    FTRL keeps w's init where n' == 0 (the reference's lazy init), so an
    element's update is discontinuous where its first gradient is 0:
    when one side's float32 gradient is exactly 0 and the other's is not
    (a tiny term absorbed by the larger v in one summation order and not
    in the other), one side keeps w's init and the other zeroes it, and
    that difference then reaches every row the element shares an example
    with.  Such a split is verified as rounding: n was 0 before on both
    sides, and the nonzero side's gradient (sqrt(n')) lies within phase
    6's bound on K2's sum (``split_tolerance``; at a window's close, the
    sum of that bound over the window's slices, each over the rows at
    the window's start).  MVM's gradient has a second discontinuity, its
    guard: a slot whose own-field factor lies within rounding of 1e-12
    takes a zero gradient on one side and prod / own on the other.  An
    element whose z jumps apart in a slice is such a guard split when
    its row holds a slot that straddles the guard (``guard_rows``); it
    is recorded and, with ``synchronize``, synchronised like an n' == 0
    split.  With ``synchronize``
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
    h = cfg.hot_size
    s_fields = cfg.max_fields if card_step.predict_step.ship_slots else 0
    steps = {"card": card_step,
             "cpu": TrainStep(card_step.model, card_step.optimizer, cfg, torch.device("cpu"))}
    states = {"card": state_from_numpy(cfg, init, dev),
              "cpu": state_from_numpy(cfg, init, "cpu")}
    out = {"slices": 0, "windows": 0, "splits": 0, "split_records": [], "jump_slices": 0,
           "jump_records": [], "guard_splits": 0, "guard_records": []}

    def rows_of(side, uk):
        idx = uk.to(steps[side].device)
        return {n: {k: t[k][idx].cpu() for k in ("param", "n", "z")}
                for n, t in states[side]["tables"].items()}

    def step_both(uk, update, tolerance, straddle=None):
        """``update(side)`` on both sides, then the n' == 0 splits and z
        jumps among the rows ``uk``; ``tolerance(name)`` gives the bound
        on their summed gradients ([U, width]) when a split needs it, and
        ``straddle(before)`` (MVM) the rows whose slots straddle the
        guard, when a z jump needs it."""
        snap = {}
        for side in steps:
            before = rows_of(side, uk)
            update(side)
            snap[side] = (before, rows_of(side, uk))
        (cb, ca), (pb, pa) = snap["card"], snap["cpu"]
        for name in ca:
            split = (ca[name]["n"] == 0) != (pa[name]["n"] == 0)
            tol = None
            for i, col in split.nonzero().tolist():
                if tol is None:
                    tol = tolerance(name, pb)
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
            if jumped.numel() and straddle is not None:
                guarded = straddle(pb)
                for i, col in jumped.tolist():
                    if not bool(guarded[i]):
                        continue
                    out["guard_splits"] += 1
                    if len(out["guard_records"]) < records:
                        out["guard_records"].append(
                            {"slice": out["slices"], "array": name, "row": int(uk[i]),
                             "col": col, "z": {"card": float(ca[name]["z"][i, col]),
                                               "cpu": float(pa[name]["z"][i, col])}})
                    if synchronize:
                        for k in ("param", "n", "z"):
                            states["cpu"]["tables"][name][k][uk[i], col] = ca[name][k][i, col]
            if jumped.numel():
                out["jump_slices"] += 1
                for i, col in jumped.tolist()[:max(0, records - len(out["jump_records"]))]:
                    out["jump_records"].append(
                        {"slice": out["slices"], "array": name, "row": int(uk[i]),
                         "col": col, "z": {"card": float(ca[name]["z"][i, col]),
                                           "cpu": float(pa[name]["z"][i, col])}})

    def live_unique(view):
        keys = view_keys(view, h)
        return torch.unique(keys[keys >= 0])  # sorted

    for arrays in shipped:
        planes = {"card": arrays, "cpu": {k: a.cpu() if isinstance(a, torch.Tensor) else a
                                          for k, a in arrays.items()}}
        rows = arrays["ckeys"].shape[0] // cfg.microbatch
        views = [{side: {k: a[j * rows:(j + 1) * rows] for k, a in planes[side].items()
                         if isinstance(a, torch.Tensor)} for side in steps}
                 for j in range(len(arrays["slice_num_real"]))]
        window = {}
        if card_step.window:
            uk_batch = live_unique(planes["cpu"])
            start = rows_of("cpu", uk_batch)
            window = {side: steps[side].window_open(states[side]["tables"], planes[side])
                      for side in steps}
        for j, num_real in enumerate(arrays["slice_num_real"]):
            view = views[j]
            uk = live_unique(view["cpu"])
            acc = {side: torch.zeros(2, dtype=torch.float64, device=steps[side].device)
                   for side in steps}

            def update(side, j=j, view=view, num_real=num_real):
                if window:
                    steps[side].window_slice(states[side]["tables"], window[side], j,
                                             view[side], num_real, acc[side])
                else:
                    steps[side]._update(states[side]["tables"], view[side], num_real,
                                        acc[side])

            step_both(uk, update, lambda name, before, view=view, num_real=num_real, uk=uk:
                      split_tolerance(name, view["cpu"], num_real, uk, before, h, s_fields),
                      straddle=None if not s_fields else
                      lambda before, view=view, num_real=num_real, uk=uk:
                      guard_rows(view["cpu"], num_real, uk, before, h, s_fields))
            out["slices"] += 1
        if window:
            keys = planes["cpu"]["ckeys"]
            uk = torch.unique(keys[keys >= 0].long())

            def close(side):
                steps[side].window_close(states[side]["tables"], window[side])

            def window_tolerance(name, _before, uk=uk, views=views, arrays=arrays,
                                 uk_batch=uk_batch, start=start):
                total = None
                for j, num_real in enumerate(arrays["slice_num_real"]):
                    tol = split_tolerance(name, views[j]["cpu"], num_real, uk_batch, start, h,
                                          s_fields)
                    total = tol if total is None else total + tol
                return total[torch.searchsorted(uk_batch, uk)]

            def window_straddle(_before, uk=uk, views=views, arrays=arrays,
                                uk_batch=uk_batch, start=start):
                rows = torch.zeros(uk_batch.numel(), dtype=torch.bool)
                for j, num_real in enumerate(arrays["slice_num_real"]):
                    rows |= guard_rows(views[j]["cpu"], num_real, uk_batch, start, h, s_fields)
                return rows[torch.searchsorted(uk_batch, uk)]

            step_both(uk, close, window_tolerance,
                      straddle=window_straddle if s_fields else None)
            out["windows"] += 1
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
    for name in ("score", "train", "optim", "sparse", "wire"):
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
        torch.cuda.empty_cache()
        k6 = phase_k6(dev, train_path["data"], T_LOG2)
        log(json.dumps({"phase": 15, "checks": k6["checks"]}))
        torch.cuda.empty_cache()
        paths = phase_input_paths(dev, T_LOG2, workdir, train_path)
        torch.cuda.empty_cache()
        hot = phase_hot(dev, T_LOG2, workdir, train_path)
        torch.cuda.empty_cache()
        wide = phase_wide_fm(dev, workdir, train_path)
        log(json.dumps({"phase": 21, "k1_fm_d_tiled": wide["k1"],
                        "k2_fm_d_tiled": wide["k2"]}))
        torch.cuda.empty_cache()
        mvm = phase_mvm(dev, T_LOG2, workdir, train_path)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(json.dumps({"phase": 17, "checks": hot["checks"]}))
    del train_path["inits"], train_path["finals"], train_path["planes"]
    log(json.dumps({"phase": 10, "checks": modes["checks"], **modes["worst"]}))
    torch.cuda.empty_cache()
    train_timings = phase_train_timings(dev, T_LOG2)

    # the training line: examples/s per epoch, step times, phase seconds,
    # the batches' key statistics, and the device's busy share from K2's
    # and K3's device times on this path's own batches and tables (phase
    # 8) times the steps that ran them -- not a profiler trace
    train_rows = []
    k6_ms = statistics.mean(r["ms"] for r in k6["timings"]
                            if r["case"].startswith("main path"))
    step_ms = {}  # a dense step's device ms on phase 8's batches, without K6
    for row in train_path["rows"]:
        k2_ms = [r["ms"] for r in row["k2_main_path"] if r["keys"] == "main_path"]
        k3_ms = [r["ms"] for r in row["k3_main_path"]]
        step_ms[row["model"]] = statistics.mean(k2_ms) + sum(k3_ms)
        busy = (TRAIN_EPOCHS * sum(k2_ms) + row["steps"] * (sum(k3_ms) + k6_ms)) / 1e3
        train_rows.append({
            "path": "native text + dict", "parser": row["parser"], "wire": row["wire"],
            "put_batch_ms_per_dispatch": [p.get("h2d", 0.0) / (row["steps"] / TRAIN_EPOCHS)
                                          * 1e3 for p in row["phases"]],
            "parse_mb_per_sec": row["parse_mb_per_sec"],
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
    # the other input paths (phase 16): the device work of phase 8's
    # steps (the same batches), plus K6 on the dictionary wire
    for row in paths["rows"]:
        busy = row["steps"] * (step_ms[row["model"]]
                               + (k6_ms if row["wire"] == "dict" else 0.0)) / 1e3
        train_rows.append(dict(
            {k: v for k, v in row.items() if k not in ("vs_phase8", "launches")},
            card=card, device_busy_s_from_kernel_times=busy,
            device_idle_share_from_kernel_times=1.0 - busy / row["train_seconds"]))
    for row in modes["compact_rows"]:
        train_rows.append({k: v for k, v in row.items()
                           if k not in ("vs_dict_wire_card", "launches")})
    train_rows += hot_train_rows(hot, modes, train_path, card)
    train_rows += mvm_train_rows(mvm, hot, modes, train_path, card)
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
                      + paths["launches"][k] for k in KERNEL_WRAPPERS}
    by_path = dict(modes["launches_by_path"], **paths["launches_by_path"],
                   dense=train_path["launches"])
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
        "embedding_bag yardstick is library_ms_lr)",
        "library_ms_lr": next(r["library_ms"] for r in timings
                              if r["mode"] == "lr" and r["B"] == BUCKETS[-1]),
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
    }, {
        "name": "dict_decode",
        "route": "cuda",
        "source": "xflow_tpu_torch/csrc/wire.cu",
        "replaces": K6_REPLACES,
        "launches": train_launches["dict_decode"],
        "launches_by_path": {k: n["dict_decode"] for k, n in by_path.items()},
        "max_abs_err": 0.0,
        "max_abs_err_of": "every decoded key, label and weight against the plain "
        "version and the compact wire, exactly, over phase 15's cases",
        "cases": [c["case"] for c in k6["checks"]],
        "ms": k6["timings"][0]["ms"],
        "host_path_ms": k6["timings"][0]["host_path_ms"],
        "plain_ms": k6["timings"][0]["plain_ms"],
        "bound_ms": k6["timings"][0]["bound_ms"],
        "bound_by": k6["timings"][0]["bound_by"],
        "library_ms": None,
        "library_why_null": K6_LIBRARY_WHY_NULL,
        "shape": {"mode": "fm", "B": k6["timings"][0]["B"], "K": K,
                  "keys": "the training main path's first batch, dictionary wire"},
        "per_shape": k6["timings"],
    }]
    kernels += hot_kernel_entries(hot, k3_check["max_abs_err"])
    kernels += mvm_kernel_entries(wide, mvm)
    # the hot paths' K4 plans and full-table K3 passes, beside the
    # entries' own paths above
    hot_rows = {f"{r['model']} {r['mode']}": r for r in hot["rows"]}
    kernels[3]["launches_hot_paths"] = sum(n["consolidate_keys"]
                                           for n in hot["launches_by_path"].values())
    kernels[2]["launches_hot_paths_full_table"] = sum(
        r["steps"] * r["tables"] for p, r in hot_rows.items()
        if r["mode"] in ("hot_dense", "hot_inner_windowend_dense"))
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
