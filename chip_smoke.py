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
6b. K2's LR/FM form, which sums repeated destinations in a block's
   shared-memory table first (csrc/train.cu), within the same bounds
   at T=2^20 on the batches that stress the table: one key in every
   row and in every live slot, uniform keys whose distinct rows
   overflow every block's table (LR and FM; the phase asserts from the
   card's launch shape that some block takes the direct-to-global
   path), v widths 4, 24 and 33 (the table on at
   CAP 8 and 32; off for tiles), and the hot plane (u16 and int32, the
   dense, hybrid and window forms, bf16);
7. hold K3 (ops/optim.py, csrc/optim.cu) against its plain version on
   the card at T=2^24, D in {1, 10}, FTRL and SGD, on three gradients:
   the first quarter of the rows, 2 % of the rows at random (groups
   straddling rows), and all zero; with rows never touched (n = 0) and
   |z'| near lambda1.  Every element of a zero 16-byte gradient group
   (w, n, z and g) must keep every bit (the kernel skips it, even where
   the random state's w is not FTRL's and the plain version rewrites
   it); every other element is held to the tolerances
   (k3_tolerances): elementwise float32 rounding bounds — n' 2 ulp
   (FMA contraction of n + g*g), z' 4 ulp of |z| + |g| + |sigma w|
   terms, w' that z' bound over the FTRL denominator plus 4 ulp (the
   soft threshold is continuous in z', so a last-ulp difference at
   |z'| = lambda1 moves w' by at most that much); SGD 2 ulp of
   |w| + |lr g|.  g == 0 afterwards everywhere;
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
   repeated key made distinct), and K3 on copies of the trained
   tables with g restored before every call (outside the events) to
   what one dense K2 launch leaves for the path's first batch: K3
   skips zero gradient groups, so a pass over the g a step has already
   cleared would time nothing;
9. K2 and K3 timings at synthetic shapes (keys uniform and Zipf-like;
   K3 on the g one K2 launch leaves for each, and on a g with no zero
   group; device time behind ``_sleep``, host path, plain, bounds, for
   K3 the full pass's bound beside this g's, library call where one
   exists: for SGD ``param.add_`` then ``g.zero_()``, the same work)
   and the ``train`` line, whose device busy
   share comes from phase 8's and phase 14's kernel times on the paths'
   own inputs;
10. hold K4 (``consolidate_keys``) and K5 (``touched_update``, both in
   csrc/sparse.cu) and K2's index mode against their plain versions on
   the sparse path's own first batch (B = 65,536, FM and LR) and on
   cases made from it: its first 512 rows, 512 rows of padding, one key
   in every row, uniform keys; and (FM) K4 at M = 0 and 1, on keys -1,
   T - 1 and T, at the slice form's threshold and one past it, with its device
   operations per call counted by torch.profiler (1 at a 512-row slice,
   3 at the batch), and K5 at widths 1 + 10, 1 + 156 and 1 + 8, U = 0
   and U = cap.  K4 exactly: the same count and key set
   as the plain version (the kernel's slots are a permutation of the
   plain version's sorted ones), every occurrence's slot holding its
   own key, padding -1.  K2's per-key sums within the sum of their
   occurrences' phase-6 bounds.  K5 (FTRL on every table in ONE
   launch; SGD on the widest) within phase 7's
   bounds, with planted rows that keep w (g = 0, n = 0) and rows whose
   |z'| lands on lambda1; every row outside the unique keys
   bit-identical, the summed gradients cleared, the slot map restored;
11. the sparse update mode (``update_mode="sparse"``) on phase 8's
   shards from phase 8's initial state, 2 epochs, FM and LR: launches
   K4 = K2 = K5 = steps, K3 = 0, no [T, D] gradient
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
   against the CPU;
28. K1's FFM form (B10) against its plain version at the flagship
   ``ffm`` (scripts/bench_models.py:84-92: T = 2^21, 40 slots, F = 39
   fields, D = 4 factors, u8 fields) on the compact and full wires
   (values, int32 fields with negative ids), and ``ffm_hot``'s planes
   (12 cold + 32 hot slots, u16 ids at H = 2^14) with and without the
   bf16 flag (w's head alone rounds: v opts out of the hot path), every
   bucket, within ffm_tolerances' derived bound, and timed at B = 512;
29. serving a full-width ``ffm`` artifact and a hot ``ffm_hot`` one
   (phases 3-4 again, the float64 reference FFM's pairwise sum);
30. training the flagship ``ffm`` on the default input path in dense
   microbatch 4 and sparse mode (2 epochs) and sequential + sparse
   inner (microbatch 128, 1 epoch), and one dispatch each of dense
   microbatch 1 and
   the sequential dense inner (microbatch 2), from one seeded state:
   exact launches, the card against the CPU within TRAIN_BOUNDS (every
   path's first dispatch through ``lockstep_tables``: FFM's dense paths
   meet FTRL's n' == 0 split too; the eval at that depth card against
   CPU), the sync guard on the
   sequential path's first dispatch, the eval AUC inside the planted
   bars;
31. ``ffm_hot`` dense (2 epochs) and hybrid (sequential + sparse
   inner, microbatch 128, 1 epoch) the same way, and the hot inner
   refused with the reference's message;
32. K2's FFM form against its plain version on the paths' own batches:
   dense (65,536 rows, with and without the hot plane), index mode (the
   sparse path's batch, the sequential path's slice 0), the hybrid's
   slice 0, and the dense batch with every logit below -30 (the
   residual is the unclamped sigmoid's), within ffm_tolerances'
   per-row bound; each timed with its bound; K6 with the field streams
   (exactly) and K3 on the ``ffm`` path, timed on the g one K2 launch
   leaves for the path's first batch;
33. K1 and K2 at D = 16 (F = 39) and F = 64 (D = 4), where they run two
   D-tiles, against their plain versions, and timed; K2 on FFM_EDGE's
   cases (its vector reductions at D = 4 and the scalar atomics at D =
   3 and in tiles; a key in every example, a key twice in one example;
   dense, index mode and the head buffer);
34. K7 (``field_pool``) and K8 (``field_pool_grad``, ops/pool.py,
   csrc/pool.cu; B11, the embedding tower of wide_deep, dcn and
   two_tower) against their plain versions on seed-made planes at
   T = 2^20: with ``w`` and without (two_tower), u8 fields with the
   clamp's 255 and int32 fields with negative ids, the hot plane (u16
   and int32 keys, keys past H) and the bf16 flag on both tables, dense,
   index and hybrid destinations, B = 512 and 65,536, and the edges of
   K7's per-field slot lists (every slot in one field, a field of 34
   slots, fields -5 and 255, B = 1 and 513).  Tolerances: K7
   per element twice n 2^-23 times the sum of the magnitudes it adds
   (n the row's slots); K8 per destination element twice its
   occurrences times 2^-23 times the sum of its terms' magnitudes, the
   log-loss within B 2^-23 of its sum, the weight sum exactly;
35. the flagship ``wide_deep`` (scripts/bench_models.py:93-99: 12 cold
   + 32 hot slots, H = 2^14, E = 8, hidden 64, T = 2^24, batch 65,536)
   on the default input path: dense (2 epochs), the hybrid (sequential +
   sparse inner, microbatch 128, 1 epoch) and one dispatch of the hot
   inner, from one seeded state (tables and dense parameters): exact
   launches (K7 = forward calls, K8 = updates), each path's first
   dispatch held through ``lockstep_tables`` (the dense parameters
   compared too), the sync guard on the hybrid's first dispatch (8
   slices a segment: a pooled slice queues about 40 launches), eval AUC
   inside the planted bars (AUC_Z); the trained dense model exported
   and served (``score_text`` against the plain version, 1e-6, and a
   float64 numpy reference, 1e-5; ``MicroBatcher``, ``compile_count``);
36. the flagship ``dcn`` (40 slots, cross_layers 2): dense (2 epochs),
   one dispatch each of sparse and the sequential dense inner
   (microbatch 2), the same way, and its dense model served;
37. the flagship ``two_tower`` (40 slots, tower_dim 16, split at field
   20): the sequential sparse inner at microbatch 128 and sgd_lr 0.02
   (1 epoch, AUC bars) and one dense dispatch (lockstep alone: no AUC
   bar), the sequential model served, its item index built on the card
   from the test shard's item-side features (``item_catalog_from_block``),
   and ``topk`` held against a float64 numpy full scan of the same user
   embeddings (ids equal up to near-ties), ``compile_count`` = 2 x
   len(buckets) and flat under mixed batch sizes and ``k``,
   requests/s and latency of single-row requests;
38. K7 and K8 against their plain versions on each pooled path's own
   first batch or slice (dense, index, hybrid), and timed on the dense
   paths' batches and their first 512 rows beside their bounds, plain
   versions and (K7) ``F.embedding_bag`` over (row, field) bags;
39. ROADMAP C5: each field form past its shared-memory cap stages a row in
   device memory (csrc/stage.cuh): K1 and K2's MVM form at 1,600 slots,
   their FFM form at max_fields 256 with 40 slots, K7 at 4,200 slots
   (and K8 there, which stages 128 slots at a time), dense and index
   mode, against their plain versions at B = 64 (rtol 1e-5 with an atol
   of 1e-5 of the largest magnitude), timed.

The card-against-CPU replays are cut for the time limit: every
``compare_states`` holds the two sides on the card (the CPU's arrays
copied there one at a time), and the CPU replays run K3 on the rows
whose summed gradient is nonzero (``cpu_k3_on_touched_rows``: where g
== 0 FTRL and SGD leave a row exactly as it was); K3 is still held
against its plain version over whole tables (phases 7, 32).

Output: the card line, per-phase lines, a ``{"kernels": [...]}`` JSON
line, and last ``{"ok": true, "device": {...}}``.  Each kernel's
``launches`` is its main paths': K1's serving path (phases 3 and 4)
plus the training paths' eval and engine batches (phases 8, 11, 12,
16), K2-K6's training paths (phases 8, 11-13 and 16, by path in
``launches_by_path``); the hot modes' entries count the hot paths
(phases 18-19), the D-tiled FM forms their phase-21 paths, and the
MVM forms the MVM paths (phases 25-27), the FFM forms the FFM paths
(phases 29-31), K7 and K8 the pooled paths, serving and top-k
(phases 35-37); every count is set to 0 just before each path and
read just after it.  K1's entry splits its launches by the rows a
launch covers (``launches_by_shape``: serving buckets, the artifact's
buckets in phase 8, 16,384-row eval batches).
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
T_START = time.perf_counter()  # main() resets it: the progress lines' clock
K = 40  # fm_nohot max_nnz
D = 10  # fm_nohot v_dim (reference ftrl.h:16)
T_LOG2 = 24  # fm_nohot table_size_log2
BUCKETS = (1, 8, 64, 512)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM data sheet, outside the tensor cores
SECTOR = 32  # bytes: the least a random DRAM read moves
SECTOR_FLOATS = SECTOR // 4
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


def time_host_path_ms(fn, args_list, prelude=None) -> float:
    """Median milliseconds of ``fn(*args)`` over ``args_list``, CUDA
    events around each call on an idle stream: the card waits at the
    start event until the host reaches the launch, so this is the
    device work plus the Python path to it.  ``prelude()``, when given,
    is enqueued ahead of each call, outside its events."""
    import torch

    for args in args_list[:5]:
        fn(*args)  # warm-up
    torch.cuda.synchronize()
    pairs = []
    for args in args_list:
        if prelude is not None:
            prelude()
            torch.cuda.synchronize()
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
    planes beside the keys), ``model="ffm"`` (phase 29) the flagship
    ``ffm`` (T = 2^21, v [T, 39 x 4]) or with ``hot`` ``ffm_hot``, and
    ``v_dim`` (phase 21: 64) an FM wider than one of the kernels'
    32-factor tiles."""
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
    ffm = model == "ffm"
    if ffm:
        cfg = dataclasses.replace(cfg, ffm_v_dim=FFM["ffm_v_dim"], max_fields=FFM["max_fields"])
        v_dim = cfg.max_fields * cfg.ffm_v_dim
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
    planes = to_device_planes(compact_wire_np(batch, hot_u16=True, ship_slots=mvm or ffm),
                              dev)
    tables = engine.state["tables"]
    want = score_plain(planes["ckeys"], None, tables["w"]["param"] if not mvm else None,
                       tables["v"]["param"], hot=planes.get("hot"), hot_size=cfg.hot_size,
                       fields=planes.get("fields"), hot_fields=planes.get("hot_fields"),
                       max_fields=cfg.max_fields, form=cfg.model)
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
        elif ffm:  # the pairwise definition: <v[k_a, f_b], v[k_b, f_a]> over a < b
            fields_i = np.concatenate([batch.hot_slots[i][hlive], batch.slots[i][live]])
            ok = (fields_i >= 0) & (fields_i < cfg.max_fields)
            v4 = vr[ok].reshape(-1, cfg.max_fields, cfg.ffm_v_dim)
            fv = fields_i[ok]
            cross = v4[:, fv, :]  # [a, b, D] = v[k_a, f_b]
            pair = np.einsum("abd,bad->ab", cross, cross)
            logit = float(w[keys_i, 0].astype(np.float64).sum()) + float(np.triu(pair, 1).sum())
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
                   "touched_update", "dict_decode", "field_pool", "field_pool_grad")


def wrappers() -> dict:
    """The kernels' wrappers by name, K1-K8."""
    from xflow_tpu_torch.ops.optim import optim_update
    from xflow_tpu_torch.ops.pool import field_pool, field_pool_grad
    from xflow_tpu_torch.ops.score import score
    from xflow_tpu_torch.ops.sparse import consolidate_keys, touched_update
    from xflow_tpu_torch.ops.train import train_step
    from xflow_tpu_torch.ops.wire import dict_decode

    return {"score": score, "train_step": train_step, "optim_update": optim_update,
            "consolidate_keys": consolidate_keys, "touched_update": touched_update,
            "dict_decode": dict_decode, "field_pool": field_pool,
            "field_pool_grad": field_pool_grad}


def cpu_k3_on_touched_rows() -> None:
    """The CPU side of every card-against-CPU replay runs the plain K3 on
    the rows whose summed gradient is nonzero, and leaves the others.
    That is the same table the whole-table pass leaves: where g == 0,
    FTRL's n' = n and sigma = 0, so z' = z and w' is recomputed from the
    same z and n by the same plain formula that last wrote it (or keeps
    its init where n == 0), and SGD subtracts 0.  The card still runs
    K3 over every row, and every table is held against the CPU's in
    full (compare_states); K3 is held against its plain version over
    whole tables in phases 7 and 32.  Installed in the train step's
    module, where ``_update`` and the head steps call K3; a CUDA table
    goes to K3 as before."""
    import xflow_tpu_torch.parallel.step as step_mod
    from xflow_tpu_torch.ops.optim import optim_plain, optim_update

    def k3(table: dict, opt) -> None:
        g = table["g"]
        if g.device.type != "cpu":
            optim_update(table, opt)
            return
        rows = (g != 0).any(dim=1).nonzero().squeeze(1)
        sub = {k: t[rows] for k, t in table.items()}
        optim_plain(sub, opt)
        for k, t in sub.items():
            table[k][rows] = t

    step_mod.optim_update = k3


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


def k2_table_cover(keys, d: int, hot=None, hot_size: int = 0, slots=None,
                   lw_u8: bool = True) -> dict:
    """How K2's LR/FM form meets this batch in shared memory: the shape
    it launches with (ops/train.py ``table_shape``) and, per block, the
    distinct gradient destinations among the rows it walks (cold rows,
    or K4's slots with ``slots``, and head rows, told apart).  A block
    with more of them than its table's entries certainly sends some
    slots down the direct-to-global path; ``blocks_over`` counts those
    blocks."""
    import torch

    from xflow_tpu_torch.ops.score import hot_plane_keys
    from xflow_tpu_torch.ops.train import table_shape

    b, k = keys.shape
    kh = hot.shape[1] if hot is not None else 0
    shape = table_shape(b, k, kh, d, lw_u8)
    block = ((torch.arange(b, device=keys.device) // shape["warps"])
             % shape["grid"])[:, None]
    cold = (slots if slots is not None else keys).long()
    live = (keys >= 0) & (cold >= 0)
    tags = [(cold * 2)[live]]
    blocks = [block.expand(-1, k)[live]]
    if hot is not None:
        hk = hot_plane_keys(hot, hot_size)
        tags.append((hk * 2 + 1)[hk >= 0])
        blocks.append(block.expand(-1, kh)[hk >= 0])
    pairs = torch.unique(torch.cat(blocks) * (1 << 33) + torch.cat(tags))
    per_block = torch.bincount(pairs // (1 << 33), minlength=shape["grid"])
    over = int((per_block > shape["entries"]).sum()) if shape["entries"] else 0
    return dict(shape, max_destinations_a_block=int(per_block.max()),
                min_destinations_a_block=int(per_block.min()), blocks_over=over)


def one_key_batch(b: int, w, g, dev, full: bool, every_slot: bool):
    """k2_inputs' uniform batch with key 1000 in slot 0 of every row
    (live there), or in every live slot: one row that every example of
    the batch adds into."""
    import torch

    keys, x, labels, weights, num_real = k2_inputs(b, w, g, dev, full, False)
    if every_slot:
        keys = torch.where(keys >= 0, 1000, keys)
    else:
        keys[:, 0] = 1000
        if x is not None:
            x[:, 0] = torch.where(x[:, 0] > 0, x[:, 0], 1.0)
    return keys.contiguous(), x, labels, weights, num_real


K2_TABLE_DIMS = (4, 24, 33)  # CAP 8 and 32 with the table; tiles, without
K2_TABLE_T_LOG2 = 20


def phase_k2_table(dev) -> dict:
    """Phase 6b: K2's LR/FM form, its privatised table, against
    train_plain within phase 6's bounds (check_k2, check_k2_hot) at
    T = 2^20, B = 65,536: one key in every row and in every live slot
    (LR, FM, compact and full wire), uniform keys whose distinct rows
    overflow every block's table (LR and FM), v widths 4, 24
    (CAP 8 and 32 with the table) and 33 (tiles: the table off), and the
    hot plane (u16 and int32, a log-uniform head, the dense, hybrid and
    window forms, bf16 on the dense one).  Asserts that the overflow
    cases drive the direct-to-global path in some block."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    t = 1 << K2_TABLE_T_LOG2
    b = TRAIN_BATCHES[-1]
    worst = {"max_abs_err_g": 0.0, "max_err_over_tol": 0.0,
             "max_abs_err_logloss_sum": 0.0, "cases": 0}
    cover = []
    w = torch.randn((t, 1), generator=g, device=dev) * 0.3
    v = torch.randn((t, D), generator=g, device=dev) * 0.05

    def case(name, keys, x, labels, weights, num_real, vv):
        check_k2(name, keys, x, labels, weights, num_real, w, vv, worst)
        worst["cases"] += 1
        cover.append(dict(k2_table_cover(keys, vv.shape[1] if vv is not None else 0,
                                         lw_u8=labels.dtype == torch.uint8), case=name))
        log(json.dumps(dict(cover[-1], phase="6b")))
        return cover[-1]

    for mode, vv in (("lr", None), ("fm", v)):
        for full in (False, True):
            for every in (False, True):
                case(f"{mode} {'full' if full else 'compact'} one key in every "
                     f"{'slot' if every else 'row'}",
                     *one_key_batch(b, w, g, dev, full, every), vv)
    for mode, vv in (("lr", None), ("fm", v)):
        got = case(f"{mode} uniform (overflow)", *k2_inputs(b, w, g, dev, False, False), vv)
        if not got["blocks_over"]:
            raise AssertionError(f"phase 6b: {mode}'s uniform batch fit every table: {got}")
    for d in K2_TABLE_DIMS:
        vd = torch.randn((t, d), generator=g, device=dev) * 0.05
        for name, batch in (("zipf", k2_inputs(b, w, g, dev, False, True)),
                            ("one key in every row", one_key_batch(b, w, g, dev, False,
                                                                   False))):
            case(f"fm D={d} {name}", *batch, vd)
        del vd
    # the hot plane: 12 cold slots and 32 hot ones over H = 2^14
    h = 1 << 14
    tables = {"w": {"param": w}, "v": {"param": v}}
    for u16 in (True, False):
        keys, _, labels, weights, num_real = k2_inputs(b, w, g, dev, False, True)
        arrays = {"ckeys": keys[:, :12].contiguous(), "labels_u8": labels,
                  "weights_u8": weights, "num_real": num_real,
                  "hot": hot_keys(b, 32, h, g, dev, u16)}
        for form in ("dense", "hybrid", "window"):
            name = f"hot {'u16' if u16 else 'int32'} {form}"
            check_k2_hot(name, form, arrays, tables, h, worst)
            if form == "dense":
                check_k2_hot(name + " bf16", form, arrays, tables, h, worst, bf16=True)
        cover.append(dict(k2_table_cover(arrays["ckeys"], D, arrays["hot"], h),
                          case=f"hot {'u16' if u16 else 'int32'} dense"))
        log(json.dumps(dict(cover[-1], phase="6b")))
    del w, v, tables
    return dict(worst, table_cover=cover)


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


def k3_untouched(g):
    """Elementwise: True where the element's 16-byte group of ``g`` is
    +0.0 bit for bit, which K3 leaves as it is (csrc/optim.cu)."""
    import torch

    groups = g.reshape(-1).view(torch.int32).view(-1, 4)
    return (groups == 0).all(dim=1, keepdim=True).expand(-1, 4).reshape(g.shape)


def check_k3(case: str, table: dict, opt, worst: dict) -> dict:
    """K3 against optim_plain on one table, in place: every element of a
    nonzero 16-byte gradient group within k3_tolerances of the plain
    version, every element of a zero group (w, n, z and g) bit-equal to
    its input, and g all zero after.  Raises on a disagreement, else
    updates ``worst`` and returns the counts."""
    import torch

    from xflow_tpu_torch.ops.optim import optim_plain, optim_update
    from xflow_tpu_torch.optim import FTRL

    plain = {k: a.clone() for k, a in table.items()}
    before = {k: a.clone() for k, a in table.items()}
    optim_update(table, opt)
    optim_plain(plain, opt)
    torch.cuda.synchronize()
    skip = k3_untouched(before["g"])
    tols = k3_tolerances(before, plain.get("n"), opt)
    rewritten = 0
    for name in table:
        got = table[name]
        if not torch.equal(got.view(torch.int32)[skip], before[name].view(torch.int32)[skip]):
            raise AssertionError(f"K3 changed an element of a zero gradient group: "
                                 f"{case} {name}")
        if name == "g":
            continue
        rewritten += int((plain[name].view(torch.int32)[skip]
                          != before[name].view(torch.int32)[skip]).sum())
        diff = torch.where(skip, 0.0, (got - plain[name]).abs())
        excess = float((diff - tols[name]).max())
        if excess > 0:
            raise AssertionError(f"K3 disagrees with optim_plain: {case} {name} "
                                 f"excess {excess}")
        worst["max_abs_err"] = max(worst["max_abs_err"], float(diff.max()))
        ratio = diff / torch.where(tols[name] > 0, tols[name], 1.0)
        worst["max_err_over_tol"] = max(worst["max_err_over_tol"], float(ratio.max()))
    if not bool((table["g"] == 0).all()):
        raise AssertionError(f"K3 left a non-zero gradient ({case})")
    out = {"skipped_elements": int(skip.sum()),
           "plain_rewrote_skipped": rewritten}
    if isinstance(opt, FTRL):
        zn = plain["z"].abs()
        out["near_lambda1"] = int((~skip & ((zn - opt.lambda1).abs() <= tols["z"])).sum())
    del plain, before
    return out


K3_G_CASES = ("quarter", "rows", "zero")


def phase_k3_vs_plain(dev, t_log2: int) -> dict:
    """Phase 7: K3 against optim_plain at D in {1, 10}, FTRL and SGD, on
    three gradients: rows [0, T/4) nonzero ("quarter"), 2 % of the rows
    at random, each straddling 16-byte groups at D = 10 ("rows"), and
    all zero ("zero": every byte of the state and g unchanged)."""
    import torch

    from xflow_tpu_torch.optim import FTRL, SGD

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    t = 1 << t_log2
    worst = {"max_abs_err": 0.0, "max_err_over_tol": 0.0}
    near_l1 = untouched = skipped = rewritten = 0
    for d in (1, D):
        for opt in (FTRL(), SGD()):
            for kind in K3_G_CASES:
                quarter = t // 4
                gr = torch.zeros((t, d), device=dev)
                if kind == "quarter":
                    gr[:quarter] = torch.randn((quarter, d), generator=g, device=dev) * 0.01
                elif kind == "rows":
                    rows = torch.rand(t, generator=g, device=dev) < 0.02
                    gr[rows] = torch.randn((int(rows.sum()), d), generator=g,
                                           device=dev) * 0.01
                table = {"param": torch.randn((t, d), generator=g, device=dev) * 0.01,
                         "g": gr}
                if isinstance(opt, FTRL):
                    n = torch.rand((t, d), generator=g, device=dev) * 1e-3
                    n[t // 2:] = 0.0  # rows [t/2, t): never touched (n = 0)
                    z = torch.randn((t, d), generator=g, device=dev) * 1e-3
                    # rows [t/8, t/4): w = 0 and z = +-lambda1 - g, so |z'|
                    # lands within rounding of lambda1
                    near = slice(t // 8, quarter)
                    sgn = torch.where(torch.rand((quarter - t // 8, d), generator=g,
                                                 device=dev) > 0.5, 1.0, -1.0)
                    z[near] = sgn * opt.lambda1 - gr[near]
                    table["param"][near] = 0.0
                    table.update(n=n, z=z)
                    untouched += int((n[t // 2:] == 0).sum())
                got = check_k3(f"D={d} {opt.name} g={kind}", table, opt, worst)
                skipped += got["skipped_elements"]
                rewritten += got["plain_rewrote_skipped"]
                near_l1 += got.get("near_lambda1", 0)
                del table
    if not near_l1:
        raise AssertionError("phase 7 did not cover |z'| near lambda1")
    return dict(worst, never_touched_elements=untouched, near_lambda1_elements=near_l1,
                skipped_elements=skipped, plain_rewrote_skipped=rewritten)


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
    """Tables of the card's run against the CPU run's, and the dense
    parameters of the pooled families, held to TRAIN_BOUNDS' table
    terms.  Reports the worst ratio to them, the
    elements whose |z| lies within rounding of lambda1, and the worst
    element: its table array, row and column, its values on both sides,
    its FTRL state on the CPU (|z| over lambda1, n) and, given ``occ``
    (occurrences per row over the run's batches), how often its row
    occurred.  With ``gate``, a breach raises with that element.  The
    arithmetic runs where the card's state lies (the CPU's arrays are
    copied there one at a time): elementwise passes over the full
    tables, which take seconds each on the host."""
    import torch

    from xflow_tpu_torch.optim import FTRL

    worst = {"max_err_over_bound": 0.0, "near_lambda1": 0, "worst_element": None}
    l1 = FTRL().lambda1
    failed = None
    arrays = [(name, key, want, gpu_state["tables"][name][key])
              for name, table in cpu_state["tables"].items()
              for key, want in table.items() if key != "g"]

    def as_2d(t):
        return t.reshape(t.shape[0] if t.dim() else 1, -1)

    arrays += [("dense", key, as_2d(want), as_2d(gpu_state["dense"][key]))
               for key, want in cpu_state.get("dense", {}).items()]
    for name, key, want_host, got in arrays:
        table = cpu_state["tables"].get(name, {})
        want = want_host.to(got.device)
        bound = (TRAIN_BOUNDS["table_rtol"] * want.abs()
                 + TRAIN_BOUNDS["table_atol_frac"] * want.abs().max())
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
                "row_occurrences": int(occ[row]) if occ is not None and name != "dense"
                else None,
            }
        if ratio > 1.0 and failed is None:
            failed = dict(worst["worst_element"], ratio=ratio)
        if key == "z":
            zb = TRAIN_BOUNDS["table_rtol"] * want.abs()
            worst["near_lambda1"] += int(((want.abs() - l1).abs() <= zb).sum())
        del want, bound, ratios
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

    from xflow_tpu_torch.convert import state_to_numpy
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
    engine_launches = 0  # K1's at the artifact's serving buckets (<= 512 rows)
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
        engine_launches += want_score - 1
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
        cpu.state = state_of(cfg, init, "cpu")
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
            "planes": planes, "k1_engine_launches": engine_launches}


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
    B*K <= T), which isolates what the repeats cost; and K3 on copies of
    the trained tables, with g restored before every call to what one
    dense K2 launch leaves for the path's first batch (k3_timing_row)."""
    import torch

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
    # K3 on copies of the trained tables, g restored before every call
    # to what one dense K2 launch leaves for the path's first batch
    arrays = batches[0]
    lw = ("labels_u8", "weights_u8") if "labels_u8" in arrays else ("labels", "weights")
    grads = {"w": torch.zeros_like(w)}
    if v is not None:
        grads["v"] = torch.zeros_like(v)
    train_step(arrays["ckeys"], arrays.get("x"), arrays[lw[0]], arrays[lw[1]],
               arrays["num_real"], w, v, grads["w"], grads.get("v"),
               torch.zeros(2, device=dev, dtype=torch.float64))
    k3_rows = []
    opt = trainer.step.optimizer
    for name, table in tables.items():
        copy = {k: a.clone() for k, a in table.items()}
        k3_rows.append(k3_timing_row(copy, opt, grads[name], prelude=flush.zero_,
                                     table=name,
                                     g="one dense K2 launch on the path's batch 0"))
        log(json.dumps(dict(k3_rows[-1], phase=8, model=model)))
        del copy
        torch.cuda.empty_cache()
    del flush, grads
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


def k3_bounds(g, ftrl: bool) -> dict:
    """K3's least time for THIS gradient (csrc/optim.cu header): every
    element of g read once (4 B), and each 32-byte sector of g that
    holds a nonzero bit with its state read and written and g cleared
    (FTRL: w, n, z in and w, n, z, g out, 7 sectors; SGD: w in and w, g
    out, 3), or about 20 (FTRL) or 2 (SGD) float32 operations per
    element of such a sector, whichever takes longer.  ``bound_full_ms``
    is a pass that rewrites every element, the work of K3's first form,
    whatever g holds.  Synchronises (it counts on g's device)."""
    import torch

    flat = g.detach().reshape(-1)
    count = flat.numel()
    bits = flat.view(torch.int32)
    pad = (-count) % SECTOR_FLOATS
    if pad:
        bits = torch.cat([bits, bits.new_zeros(pad)])
    touched = int((bits.view(-1, SECTOR_FLOATS) != 0).any(dim=1).sum())
    used = 4 * count + touched * SECTOR * (7 if ftrl else 3)
    ops = touched * SECTOR_FLOATS * (20 if ftrl else 2)
    full = count * 4 * (8 if ftrl else 4)
    used_ms = used / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(used_ms, ops_ms),
            "bound_by": "bytes" if used_ms >= ops_ms else "operations",
            "bound_bytes": used, "bound_ops": ops,
            "touched_sectors": touched, "sectors": (count + pad) // SECTOR_FLOATS,
            "bound_full_ms": max(full / HBM_BYTES_PER_S * 1e3,
                                 count * (20 if ftrl else 2) / FP32_FLOPS_PER_S * 1e3),
            "bound_full_bytes": full}


def k3_timing_row(state: dict, opt, g_src, prelude=None, plain_runs: int = TIMED_RUNS,
                  **extra) -> dict:
    """K3's device time on ``state`` (one table's param, aux tensors and
    g) with its g set to ``g_src`` before every call, outside the events
    (a K3 call clears g, so without it every call after the first would
    time a pass over zeros), beside the
    plain version's on the same g, the bounds of this g, and for SGD the
    library call at equal work (``param.add_(g, alpha=-lr)`` then
    ``g.zero_()``; ``library_add_ms`` the add alone).  ``prelude`` runs
    after the restore (an L2 flush, say)."""
    import torch

    from xflow_tpu_torch.ops.optim import optim_plain, optim_update
    from xflow_tpu_torch.optim import FTRL

    ftrl = isinstance(opt, FTRL)

    def restore():
        state["g"].copy_(g_src)
        if prelude is not None:
            prelude()

    args = [(state, opt)] * TIMED_RUNS
    row = dict(extra, optimizer=opt.name, T=state["param"].shape[0],
               D=state["param"].shape[1],
               ms=time_device_ms(optim_update, args, prelude=restore),
               host_path_ms=time_host_path_ms(optim_update, args, prelude=restore),
               plain_ms=time_device_ms(optim_plain, args[:plain_runs], prelude=restore,
                                       chunk_size=5),
               **k3_bounds(g_src, ftrl))
    if ftrl:
        row.update(library_ms=None,
                   library_why_null="no single PyTorch call applies the FTRL recurrence")
    else:
        def library(table_, opt_):
            table_["param"].add_(table_["g"], alpha=-opt_.lr)
            table_["g"].zero_()

        def library_add(table_, opt_):
            table_["param"].add_(table_["g"], alpha=-opt_.lr)

        row.update(library_ms=time_device_ms(library, args, prelude=restore),
                   library_add_ms=time_device_ms(library_add, args, prelude=restore),
                   library_why_null=None,
                   library_call="param.add_(g, alpha=-lr); g.zero_()")
    torch.cuda.synchronize()
    return row


def phase_train_timings(dev, t_log2: int) -> dict:
    """Phase 9: K2 and K3 device times beside their plain versions,
    their bounds and, where one exists, one PyTorch call computing the
    same function.  K3 runs on the g that one dense K2 launch leaves for
    this phase's uniform and Zipf batches, and on a g with no zero group,
    restored before every call (k3_timing_row)."""
    import torch

    from xflow_tpu_torch.ops.train import train_plain, train_step
    from xflow_tpu_torch.optim import FTRL, SGD

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    t = 1 << t_log2
    w = torch.randn((t, 1), generator=g, device=dev) * 0.3
    v = torch.randn((t, D), generator=g, device=dev) * 0.05
    k2_rows = []
    k3_batches = {}  # keys name -> an FM batch of 65,536 rows
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
                if mode == "fm" and b == TRAIN_BATCHES[-1] and keys_name != "zipf_row_distinct":
                    k3_batches[keys_name] = pool[0]
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
    # K3 on the g one dense K2 launch leaves for a 65,536-row batch of
    # each key kind (FM: g_w for D = 1, g_v for D = 10), and on a g with
    # no zero group
    grads = {}
    for keys_name, (keys, _, labels, *_rest) in k3_batches.items():
        g_w, g_v = torch.zeros_like(w), torch.zeros_like(v)
        train_step(keys, None, labels, torch.ones_like(labels), float(keys.shape[0]),
                   w, v, g_w, g_v, torch.zeros(2, device=dev, dtype=torch.float64))
        grads[keys_name] = {1: g_w, D: g_v}
    del w, v, k3_batches
    torch.cuda.empty_cache()
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)  # 128 MiB > L2
    k3_rows = []
    for d in (1, D):
        grads["dense"] = {d: torch.randn((t, d), generator=g, device=dev) * 0.01}
        for opt in (FTRL(), SGD()):
            for keys_name, by_d in grads.items():
                table = {"param": torch.randn((t, d), generator=g, device=dev) * 0.01,
                         "g": torch.zeros((t, d), device=dev)}
                table.update(opt.init_aux(table["param"]))
                row = k3_timing_row(table, opt, by_d[d], prelude=flush.zero_,
                                    plain_runs=20, keys=keys_name,
                                    g="a g with no zero group" if keys_name == "dense"
                                    else f"one dense FM K2 launch on {keys_name} keys, "
                                    f"B={TRAIN_BATCHES[-1]}")
                k3_rows.append(row)
                log(json.dumps(dict(row, phase=9)))
                del table
        del grads["dense"]
        torch.cuda.empty_cache()
    del flush
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
                      windowend: str = "sparse", pooled: bool = False) -> dict:
    """Each kernel's launches over ``steps`` dispatches of ``mode``
    (xflow_tpu_torch/parallel/step.py's module docstring): K2 once per
    update (per slice in sequential mode, per batch otherwise: dense
    microbatch and cold_consolidate run the plain dense step); K4 with
    each K2 of the touched-rows form, and one K5 launch over every table
    after it; K3 per table per update of the dense form, and with a hot
    table per table per hybrid update (the head rows); K1 per eval
    batch; K6 per dispatch and eval batch on the dictionary wire.  The
    hot inner's window (``windowend`` resolved): K2 and K3 over the head
    per slice, then K4 and K5 once (sparse end) or K3 per table (dense
    end) per dispatch.  A pooled family (``pooled``) runs K7 where the
    others run K1 (and once per update) and K8 where they run K2."""
    update = mode.get("update_mode", "dense")
    s = mode.get("microbatch", 1) if update == "sequential" else 1
    inner = mode.get("sequential_inner", "dense") if update == "sequential" else None
    hot = mode.get("hot_size_log2", 0) > 0
    sparse = update == "sparse" or inner == "sparse"
    # the dictionary wire (the default) decodes every shipped batch: K6
    # per training dispatch and per eval batch
    decodes = 0 if mode.get("wire_dedup") == "off" else steps + eval_batches
    if pooled:
        out = {"score": 0, "train_step": 0, "dict_decode": decodes,
               "field_pool": steps * s + eval_batches, "field_pool_grad": steps * s}
    else:
        out = {"score": eval_batches, "train_step": steps * s, "dict_decode": decodes,
               "field_pool": 0, "field_pool_grad": 0}
    if inner == "hot" and s > 1:
        sparse_end = windowend == "sparse"
        return dict(out, optim_update=steps * tables * (s + (0 if sparse_end else 1)),
                    consolidate_keys=steps if sparse_end else 0,
                    touched_update=steps if sparse_end else 0)
    plans = steps * s if sparse else 0
    # the dense form steps every table per update; the hybrid steps the
    # head rows per update; the plain touched-rows form none
    passes = (plans if hot else 0) if sparse else steps * s
    return dict(out, optim_update=passes * tables, consolidate_keys=plans,
                touched_update=plans)


GUARD_SLEEP_CYCLES = 5 * SLEEP_CYCLES  # ~100 ms, 5x a sequential dispatch's host path
GUARD_SEGMENT_SLICES = 32  # at most 5 queued launches a slice: ~160 a segment


def guard_first_dispatch(trainer, segment: int = GUARD_SEGMENT_SLICES) -> dict:
    """Check that the trainer's first dispatch never waits for the card.
    It runs under ``torch.cuda.set_sync_debug_mode("error")``, in
    segments of ``segment`` sequential slices (one segment
    for an unsliced step), each queued behind a ``torch.cuda._sleep``.
    When a segment returns, its sleep must still hold the stream: any
    host synchronisation inside it (which the debug mode, a prototype,
    may not see) would have waited for the sleep to end.  Between
    segments the guard itself waits for the card, outside the check, so
    no segment queues more launches than the card holds pending (a
    hybrid fm dispatch queues about 645: 128 slices of K4's one launch,
    K2, one K5 over both tables and K3 per table, and K6; 1,030 when
    K4 made three operations a slice and K5 one a table).  Records the
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
            if hold["slices"] % segment == 0:
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
             lockstep: bool = False, replay_dispatches: int | None = None,
             guard_segment: int = GUARD_SEGMENT_SLICES) -> dict:
    """One update mode's training main path through ``Trainer``: on the
    card from ``init`` (launch counts zeroed just before, read just after,
    and held to ``expected_launches``), then the same steps on the CPU
    from the same state, held to TRAIN_BOUNDS.  With ``lockstep`` (the
    paths whose many passes meet FTRL's n' == 0 discontinuity) the CPU
    replay is ``lockstep_tables`` over the shipped batches, which holds
    each update's log-loss and the tables to TRAIN_BOUNDS, and the CPU
    then evaluates its replayed tables.  ``replay_dispatches`` cuts the
    lockstep replay to the first dispatches: then the card's replayed
    tables are evaluated too, and the CPU's eval is held to them at
    that depth (the main path's eval still meets the planted bars).
    ``guard_segment`` is the sync guard's slices a segment.
    Returns the row, the card's trainer and, with ``keep``, the batches
    it shipped."""
    import os

    import torch

    from xflow_tpu_torch.parallel.step import hot_windowend, uses_grad_buffer
    from xflow_tpu_torch.trainer import Trainer

    cfg = mode_config(model, t_log2, data, os.path.join(workdir, f"{model}-{label}.jsonl"),
                      **mode)
    zero_launches()
    # the main path starts here
    trainer = Trainer(cfg, device=dev, log=log)
    trainer.state = state_of(cfg, init, dev)
    shipped = keep_shipped_batches(trainer) if keep else None
    guard = guard_first_dispatch(trainer, guard_segment) if sync_check else None
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
                             hot_windowend(cfg), trainer.step.pooled)
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

    # the CPU trainer evaluates, and without lockstep trains too
    cpu = (Trainer(dataclasses.replace(cfg, metrics_out=""), device="cpu",
                   log=lambda _: None) if evaluate or not lockstep else None)
    cpu_history = None
    t0 = time.perf_counter()
    if lockstep:
        replay = {}
        depth = replay_dispatches or len(shipped)
        lock = lockstep_tables(trainer.step, cfg, init, shipped[:depth], keep=replay)
        lock["replayed_dispatches"] = depth
        if cpu is not None:
            cpu.state = replay["cpu"]
        if depth < len(shipped) and evaluate:  # the card's eval at the replay's depth
            trained, trainer.state = trainer.state, replay["card"]
            result_at_depth = trainer.evaluate()
            trainer.state = trained
            lock["card_eval_at_depth"] = {k: result_at_depth[k] for k in ("auc", "logloss")}
    else:
        cpu.state = state_of(cfg, init, "cpu")
        cpu_history = cpu.train()
    cpu_s = time.perf_counter() - t0
    cpu_result = cpu.evaluate() if evaluate else None
    if cpu is not None:
        cpu.close()
    if not lockstep and len(trainer.step_logloss) != len(cpu.step_logloss):
        raise AssertionError(f"{model} {label}: step counts differ")
    for a, b in zip(trainer.step_logloss, [] if lockstep else cpu.step_logloss):
        if abs(a - b) > TRAIN_BOUNDS["logloss_rtol"] * max(abs(b), 1.0):
            raise AssertionError(f"{model} {label}: step log-loss {a} on the card vs "
                                 f"{b} on the CPU")
    held = lock["card_eval_at_depth"] if lockstep and "card_eval_at_depth" in lock else result
    if evaluate and (abs(held["auc"] - cpu_result["auc"]) > TRAIN_BOUNDS["auc_atol"] or abs(
            held["logloss"] - cpu_result["logloss"]) > TRAIN_BOUNDS["logloss_rtol"] * abs(
            cpu_result["logloss"])):
        raise AssertionError(f"{model} {label}: eval on the card {held} vs CPU {cpu_result}")
    if lockstep:  # lockstep_tables held the tables
        state_cmp = {"lockstep": dict(lock, seconds=cpu_s)}
    else:
        occ = row_occurrences(shipped, cfg.table_size) if keep else None
        state_cmp = compare_states(trainer.state, cpu.state, occ)
    row = {
        "model": model, "mode": label, "config": mode, "steps": steps, "tables": tables,
        "launches": got, "train_seconds": train_s, "cpu_train_seconds": cpu_s,
        "examples_per_sec": [h["examples_per_sec"] for h in history],
        "step_time_p50": [h["step_time_p50"] for h in history],
        "phases": [{k: p.get(k, 0.0) for k in ("input_stall", "h2d", "dispatch",
                                                "device_block")}
                   for p in (h["phases"] for h in history)],
        "train_logloss": [h["train_logloss"] for h in history],
        "cpu_train_logloss": ([h["train_logloss"] for h in cpu_history] if cpu_history
                              else None),
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
    kern[1].fill_(-7)  # K4 must write the count, 0 included
    consolidate_keys(keys, t, *kern, slot_map)
    consolidate_keys_plain(keys, t, *plain)
    torch.cuda.synchronize()
    n, pn = int(kern[1]), int(plain[1])
    live = (keys >= 0) & (keys < t)
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


def check_k5(case: str, tables: list, opt, ukeys, count, n: int, gsums: list, slot_map,
             worst: dict) -> None:
    """K5 against its plain version on ``tables`` (copies the caller
    made: param plus aux, one dict a table, all stepped by ONE launch)
    with ``gsums`` beside them.  For FTRL it plants rows with g = 0 and
    n = 0 (never touched: w kept exactly) and rows with w = 0 and z =
    +-lambda1 - g (|z'| at lambda1); the touched rows are held to phase
    7's elementwise bounds (k3_tolerances); every other row must be
    bit-identical, gsum[:count] cleared, and the slot map (when given)
    back at -1."""
    import torch

    from xflow_tpu_torch.ops.sparse import touched_plain, touched_update
    from xflow_tpu_torch.optim import FTRL

    gsums = [g.clone() for g in gsums]
    rows = ukeys[:n].long()
    if isinstance(opt, FTRL):
        for tab, gsum in zip(tables, gsums):
            gsum[0:n:8] = 0.0
            tab["n"][rows[0::8]] = 0.0
            near = rows[4::8]
            sgn = torch.where(torch.arange(near.numel(), device=rows.device) % 2 == 0,
                              1.0, -1.0)
            tab["param"][near] = 0.0
            tab["z"][near] = sgn[:, None] * opt.lambda1 - gsum[4:n:8]
    g_in = [g[:n].clone() for g in gsums]
    before = [{k: a.clone() for k, a in tab.items()} for tab in tables]
    plain = [{k: a.clone() for k, a in tab.items()} for tab in tables]
    g_plain = [g.clone() for g in gsums]
    launched = touched_update.launches
    touched_update(tables, opt, ukeys, count, gsums, slot_map)
    touched_plain(plain, opt, ukeys, count, g_plain)
    torch.cuda.synchronize()
    if touched_update.launches - launched != 1:
        raise AssertionError(f"K5 {case}: {len(tables)} tables took "
                             f"{touched_update.launches - launched} launches")
    worst["tables_in_one_launch"] = max(worst.get("tables_in_one_launch", 0), len(tables))
    mask = torch.zeros(tables[0]["param"].shape[0], dtype=torch.bool, device=rows.device)
    mask[rows] = True
    for i, tab in enumerate(tables):
        for k in tab:
            if not torch.equal(tab[k][~mask], before[i][k][~mask]):
                raise AssertionError(f"K5 {case} table {i}: a row outside ukeys changed ({k})")
        if n:
            rows_before = {k: a[rows] for k, a in before[i].items()}
            rows_before["g"] = g_in[i]
            tols = k3_tolerances(rows_before,
                                 plain[i]["n"][rows] if "n" in plain[i] else None, opt)
            for k, tol in tols.items():
                diff = (tab[k][rows] - plain[i][k][rows]).abs()
                excess = float((diff - tol).max())
                if excess > 0:
                    raise AssertionError(f"K5 {case} table {i} {opt.name} {k}: excess "
                                         f"{excess}")
                worst["max_abs_err"] = max(worst["max_abs_err"], float(diff.max()))
                ratio = diff / torch.where(tol > 0, tol, 1.0)
                worst["max_err_over_tol"] = max(worst["max_err_over_tol"],
                                                float(ratio.max()))
            if isinstance(opt, FTRL):
                kept = rows[0::8]
                if not torch.equal(tab["param"][kept], before[i]["param"][kept]):
                    raise AssertionError(f"K5 {case}: w moved on a row with g = 0, n = 0")
                worst["never_touched_rows"] += int(kept.numel())
                zn = plain[i]["z"][rows].abs()
                worst["near_lambda1"] += int(((zn - opt.lambda1).abs() <= tols["z"]).sum())
        if bool(gsums[i][:n].any()):
            raise AssertionError(f"K5 {case} table {i}: gsum not cleared")
    if slot_map is not None and bool((slot_map != -1).any()):
        raise AssertionError(f"K5 {case}: the slot map was not restored")


def k4_device_ops(keys, t: int, slot_map) -> int:
    """Device operations (kernels and memsets) one K4 call on ``keys``
    queues, counted by torch.profiler over one call after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xflow_tpu_torch.ops.sparse import consolidate_keys

    plan = new_plan(keys, keys.device)
    consolidate_keys(keys, t, *plan, slot_map)
    slot_map.fill_(-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        consolidate_keys(keys, t, *plan, slot_map)
        torch.cuda.synchronize()
    slot_map.fill_(-1)
    torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def k4_k5_edge_checks(keys, t: int, worst: dict) -> dict:
    """Phase 10's edge cases on the sparse main path's first batch: K4
    at M = 0 and 1, keys -1, T - 1 and T (padding), M at the slice
    form's threshold and one past it (the batch form), each exactly as
    the plain version; K4's device
    operations at a 512-row slice (torch.profiler: 1) and at the batch
    (3); K5 over two tables in one launch at widths 1 + 10, 1 + 156 and
    1 + 8 (T = 2^20), with U = 0 and U = cap."""
    import torch

    from xflow_tpu_torch.ops.sparse import K4_SLICE_MAX, consolidate_keys
    from xflow_tpu_torch.optim import FTRL

    dev = keys.device
    flat = keys.reshape(-1)
    first = keys[:SLICE_ROWS]
    edge = first.clone()
    edge[:, 1], edge[:, 2], edge[:, 3] = -1, t - 1, t
    slot_map = torch.full((t,), -1, dtype=torch.int32, device=dev)
    cases = [("m0", flat[:0]), ("m1", torch.tensor([t - 1], dtype=torch.int32, device=dev)),
             ("keys -1, T-1 and T", edge), ("at the threshold", flat[:K4_SLICE_MAX]),
             ("one past the threshold", flat[:K4_SLICE_MAX + 1])]
    for case, kk in cases:
        check_k4(case, kk.contiguous(), t, slot_map, worst["k4"])
        slot_map.fill_(-1)
    ops = {"slice_512": k4_device_ops(first.contiguous(), t, slot_map),
           "batch": k4_device_ops(keys, t, slot_map)}
    if ops["slice_512"] != 1 or ops["batch"] != 3:
        raise AssertionError(f"K4's device operations per call: {ops} (profiler; want 1 at "
                             "a slice and 3 at the batch)")
    worst["k4"]["device_ops_per_call"] = ops
    del slot_map
    # K5: two tables in one launch at each width, on T = 2^20
    t5 = 1 << 20
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    opt = FTRL()
    small = torch.where(first >= 0, first.remainder(t5), -1).contiguous()
    m = small.numel()
    unique = torch.randperm(t5, generator=g, device=dev)[:m].to(torch.int32)
    out = []
    for label, kk, widths in (("1+10", small, (1, 10)), ("1+156", small, (1, 156)),
                              ("1+8", small, (1, 8)),
                              ("U = 0", torch.full_like(small, -1), (1, 10)),
                              ("U = cap", unique.view_as(small), (1, 10))):
        smap = torch.full((t5,), -1, dtype=torch.int32, device=dev)
        plan = new_plan(kk, dev)
        consolidate_keys(kk, t5, *plan, smap)
        torch.cuda.synchronize()
        n = int(plan[1])
        if label == "U = cap" and n != m:
            raise AssertionError(f"K5 U = cap: {n} unique keys of {m}")
        tables = [{k: (torch.randn((t5, d), generator=g, device=dev) * 0.1).abs()
                   if k == "n" else torch.randn((t5, d), generator=g, device=dev) * 0.1
                   for k in ("param", "n", "z")} for d in widths]
        gsums = [torch.randn((m, d), generator=g, device=dev) * 0.1 for d in widths]
        check_k5(f"edge {label}", tables, opt, plan[0], plan[1], n, gsums, smap, worst["k5"])
        out.append({"case": f"K5 {label}", "U": n, "widths": list(widths)})
        del tables, gsums, smap
        torch.cuda.empty_cache()
    return {"k4_device_ops": ops, "k5_cases": out}


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
        grads = {"w": gw, "v": gv}
        # every table in one launch (FTRL, the path's), then SGD on the widest
        forms = [(names, opt)] + ([([names[-1]], SGD())] if case == "main_path" else [])
        for i, (group, form) in enumerate(forms):
            keep = ("param", "n", "z") if isinstance(form, FTRL) else ("param",)
            copies = [{k: tables[name][k].clone() for k in keep} for name in group]
            check_k5(f"{label} {'+'.join(group)}", copies, form, kern[0], kern[1], n,
                     [grads[name] for name in group],
                     slot_map if i == len(forms) - 1 else None, worst["k5"])
            del copies
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


def k5_bounds_tables(ukeys, n: int, dims: list, form: str, hot_size: int = 0) -> dict:
    """K5's least time for one launch over tables of widths ``dims``:
    each table's k5_bounds, with the 4-byte key of a row read once."""
    parts = [k5_bounds(ukeys, n, d, form, hot_size) for d in dims]
    once = 4 * n * (len(dims) - 1)
    used = sum(p["bound_bytes"] for p in parts) - once
    sectors = sum(p["bound_sector_bytes"] for p in parts) - once
    ops = sum(p["bound_ops"] for p in parts)
    used_ms = used / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(used_ms, ops_ms),
            "bound_by": "bytes" if used_ms >= ops_ms else "operations",
            "bound_sector_ms": max(sectors / HBM_BYTES_PER_S * 1e3, ops_ms),
            "bound_bytes": used, "bound_sector_bytes": sectors, "bound_ops": ops}


def sparse_kernel_timings(model: str, trainer, keys, labels, weights, num_real,
                          label: str, form_kw: dict | None = None, k2: bool = True) -> list:
    """K4, K2 in index mode and K5 (FTRL, every table) on one key plane
    of a sparse main path, after its run, on copies of its trained
    tables: device ms behind ``_sleep`` (60 launches), the plain
    versions' ms, the bounds, and for K4 ``torch.unique(...,
    return_inverse=True)`` as the library call (timed on the host path:
    it synchronises to size its output).  K4's calls each start from a
    cleared slot map (the clear is outside the timed events); K2's and
    K5's each behind an L2 flush, as in the run.  ``form_kw`` are K2's
    field-form keywords (field_kw) for a model that reads field ids;
    without ``k2`` K2 is not timed here (FFM's is, by time_ffm_k2)."""
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

    form_kw = form_kw or {}

    def k2_index(slots):
        train_step(keys, None, labels, weights, num_real, w, v, gw, gv, acc, slots=slots,
                   **form_kw)

    def k2_index_plain(slots):
        train_plain(keys, None, labels, weights, num_real, w, v, gw, gv, acc, slots=slots,
                    **form_kw)

    dim = v.shape[1] if v is not None else 0
    b2 = k2_bounds(keys, None, labels, dim)
    stream = 4 * m  # the slot plane
    if k2:
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
    else:  # K5's gradients, from one K2 launch
        k2_index(plan[2])
    opt = trainer.step.optimizer
    names = [name for name, g in (("w", gw), ("v", gv)) if g is not None]
    gsums = [g for g in (gw, gv) if g is not None]
    copies = [{k: tables[name][k].clone() for k in ("param", "n", "z")} for name in names]
    args = [(copies, opt, plan[0], plan[1], gsums, None)] * TIMED_RUNS
    rows.append({
        "kernel": "touched_update", "model": model, "path": label, "table": "+".join(names),
        "optimizer": opt.name, "U": n, "D": [g.shape[1] for g in gsums],
        "ms": time_device_ms(touched_update, args, prelude=flush.zero_),
        # about 65 launches a table a call: 4 calls per sleep stay well
        # inside the card's queue of pending launches
        "plain_ms": time_device_ms(touched_plain, [a[:5] for a in args],
                                   prelude=flush.zero_, chunk_size=4),
        **k5_bounds_tables(plan[0], n, [g.shape[1] for g in gsums], opt.name),
        "library_ms": None,
        "library_why_null": "no single PyTorch call applies FTRL to gathered rows",
    })
    del copies
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
        if model == "fm":
            out["edges"] = k4_k5_edge_checks(arrays["ckeys"], 1 << t_log2, worst)
            log(json.dumps(dict(out["edges"], phase=10)))
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

    from xflow_tpu_torch.trainer import Trainer

    zero_launches()
    # the path starts here
    trainer = Trainer(cfg, device=dev, log=log)
    trainer.state = state_of(cfg, init, dev)
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
    # ffm_hot: the flagship ffm with fm's hot geometry (phase 29)
    "ffm": {"max_nnz": 12, "hot_size_log2": 14, "hot_nnz": 32},
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
    """K1's and K2's field-form keywords for a view that carries field
    planes (and its ``max_fields`` and ``form``: MVM's views name no
    form), else none."""
    if "fields" not in arrays:
        return {}
    return {"fields": arrays["fields"], "hot_fields": arrays.get("hot_fields"),
            "max_fields": arrays["max_fields"], "form": arrays.get("form", "mvm")}


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
    row = hot_timing_row(
        f"train_step (hot: {form})", kernel, plain, [()] * TIMED_RUNS, bound,
        prelude=flush.zero_, model=model, path=label, B=view["ckeys"].shape[0],
        Kc=view["ckeys"].shape[1], Kh=view["hot"].shape[1], H=h, D=dim,
        library_why_null="no single PyTorch call computes the gather, logit, residual, "
        "scatter-add and log-loss")
    return row


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
    copies = [{k: tables[name][k].clone() for k in ("param", "n", "z")} for name in names]
    plains = [{k: a.clone() for k, a in c.items()} for c in copies]
    befores = [{k: a.clone() for k, a in c.items()} for c in copies]
    g_ins = [gsum[name][:n].clone() for name in names]
    g_plains = [gsum[name].clone() for name in names]
    head = [heads[name].clone() for name in names]
    head_plain = [heads[name].clone() for name in names]
    launched = touched_update.launches
    touched_update(copies, opt, ukeys, count, [gsum[name] for name in names], slot_map,
                   head=head, hot_size=h)
    touched_plain(plains, opt, ukeys, count, g_plains, head=head_plain, hot_size=h)
    torch.cuda.synchronize()
    if touched_update.launches - launched != 1:
        raise AssertionError(f"K5 fold {case}: the tables took more than one launch")
    for i, name in enumerate(names):
        copy, plain, before = copies[i], plains[i], befores[i]
        if not torch.equal(head[i], head_plain[i]):
            raise AssertionError(f"K5 fold {case} {name}: head buffers differ")
        mask = torch.zeros(t, dtype=torch.bool, device=dev)
        mask[rows[~folded]] = True
        for k in copy:
            if not torch.equal(copy[k][~mask], before[k][~mask]):
                raise AssertionError(f"K5 fold {case} {name}: a folded or unplanned row "
                                     f"changed ({k})")
        stepped = rows[~folded]
        rb = {k: a[stepped] for k, a in before.items()}
        rb["g"] = g_ins[i][~folded]
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
    worst["tables_in_one_launch"] = max(worst.get("tables_in_one_launch", 0), len(names))
    if bool((slot_map != -1).any()):
        raise AssertionError(f"K5 fold {case}: the slot map was not restored")
    del copies, plains, befores
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

                names = list(tables)
                copies = [{k: tables[n_][k].clone() for k in ("param", "n", "z")}
                          for n_ in names]
                args = [(copies, trainer.step.optimizer, fold["ukeys"], fold["count"],
                         [fold["gsum"][n_] for n_ in names], None,
                         [fold["heads"][n_] for n_ in names], h)] * TIMED_RUNS

                def fold_plain(table, opt, ukeys, count, gsum, _slot_map, head, hot_size):
                    touched_plain(table, opt, ukeys, count, gsum, head, hot_size)

                bound = k5_bounds_tables(fold["ukeys"], fold["n"],
                                         [c["param"].shape[1] for c in copies], "ftrl", h)
                out["timings"].append(hot_timing_row(
                    "touched_update (fold)", touched_update, fold_plain, args, bound,
                    prelude=flush.zero_, model=model, path=label, table="+".join(names),
                    U=fold["n"], H=h, library_why_null="no single PyTorch call applies "
                    "FTRL to gathered rows"))
                name = "v" if "v" in tables else "w"
                del copies
                # K3 over the head rows, the hybrid's and the hot inner's
                # step: a head buffer has no zero group after a slice
                hd = {k: tables[name][k][:h].clone() for k in ("param", "n", "z")}
                hd["g"] = torch.zeros_like(hd["param"])
                g_head = torch.randn(hd["param"].shape, device=dev) * 0.01
                out["timings"].append(k3_timing_row(
                    hd, trainer.step.optimizer, g_head, prelude=flush.zero_,
                    plain_runs=20, kernel="optim_update (head rows)", model=model,
                    path=label, table=name, H=h, g="a head buffer with no zero group"))
                log(json.dumps(dict(out["timings"][-1], phase=20)))
                del fold, hd, g_head
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
    numpy (the paths of a cell start from it on the card and the CPU):
    its tables, and for a pooled family ``{"tables", "dense"}``
    (``state_of`` reads both)."""
    from xflow_tpu_torch.convert import dense_to_numpy, state_to_numpy
    from xflow_tpu_torch.trainer import Trainer

    trainer = Trainer(dataclasses.replace(cfg, metrics_out=""), device=dev,
                      log=lambda _: None)
    init = state_to_numpy(trainer.state, aux=True)
    if trainer.state["dense"]:
        init = {"tables": init, "dense": dense_to_numpy(trainer.state)}
    trainer.close()
    del trainer
    return init


def state_of(cfg, init: dict, device):
    """The state ``init`` (fresh_init's numpy tables, or ``{"tables",
    "dense"}`` for a pooled family) on ``device``."""
    from xflow_tpu_torch.convert import state_from_numpy

    if "dense" in init and "tables" in init:
        return state_from_numpy(cfg, init["tables"], device, dense=init["dense"])
    return state_from_numpy(cfg, init, device)


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
# FFM, B10 (phases 28-33)

FFM_T_LOG2 = 21  # scripts/bench_models.py:84-92 ffm: table_size_log2 21
# the flagship ``ffm`` (scripts/bench_models.py:84-92): max_nnz 40 (K, as
# fm_nohot_config), ffm_v_dim 4, max_fields 39, microbatch 4, FTRL
FFM = {"ffm_v_dim": 4, "max_fields": 39, "microbatch": 4}
# ``ffm_hot``: the flagship with fm's hot geometry (bench_models.py:66)
FFM_HOT = dict(FFM, max_nnz=12, hot_size_log2=14, hot_nnz=32)
FFM_DIM = FFM["ffm_v_dim"]
FFM_FIELDS = FFM["max_fields"]
FFM_WIDE = ((16, 39), (4, 64))  # (D, F) at which K1 and K2 run two D-tiles
FFM_WIDE_T_LOG2 = 20
B10_REPLACES = (
    "xflow_tpu/models/blocks.py:205 (B10 ffm_field_interaction) + "
    "xflow_tpu/models/blocks.py:56 (valid_fields) + xflow_tpu/models/ffm.py:74-92 "
    "(FFMModel.logit) + xflow_tpu/parallel/step.py:59-74 (its value_and_grad "
    "gradient, written out) + xflow_tpu/parallel/step.py:782-810 (B4s field planes); "
    "no pl.pallas_call in the reference"
)
FFM_LIBRARY_WHY_NULL = ("no single PyTorch call computes FFM's field-aware sums, cross "
                        "term and their gradient (with the gather, scatter and log-loss "
                        "in K2)")


def ffm_tolerances(keys, fields, x, labels, weights, num_real, w, v, f: int,
                   logit_only: bool = False, chunk: int = 4096, dw=None, dv=None) -> dict:
    """Bounds on K1's and K2's FFM form against their plain versions for
    one batch, in float64 from the inputs (``keys`` [B, N] index the rows
    of ``w`` and ``v``, the hot plane ahead of the cold one, -1 on
    padding; a field outside [0, f) drops the slot from the pair term).
    Per side: each S[f1, f2, d] within EPS32 (count + 1) of its slots'
    summed magnitudes; the cross term within the first-order error of
    its F^2 D products plus EPS32 (F^2 D + 2) of their magnitudes; the
    diagonal and the linear term within EPS32 (terms + 2) of theirs; the
    logit within the sum plus 3 EPS32 of its parts; the residual (the
    UNCLAMPED sigmoid's) within its slope times that; each occurrence's
    v gradient x (S - own x v) r within S's error, the subtraction's and
    the residual's, and the scatter (atomics in any order) within
    EPS32 (occurrences + 4) of each row's summed magnitudes; every side's
    bound taken twice.  ``dw``/``dv`` (shaped as w and v), when given,
    are how far the two sides' input tables lie apart (``lockstep_tables``
    holds them within TRAIN_BOUNDS): each S, the linear term and the
    own-field subtraction take their first-order effect too, since in
    FFM one element's exact 0 (FTRL's soft threshold) makes its partners'
    gradients exactly 0.  Returns {"logit" [B]} and, unless
    ``logit_only``, "w" [rows, 1], "v" [rows, F D] and "logloss"."""
    import torch

    b, n = keys.shape
    e = v.shape[1]
    d = e // f
    dev = keys.device
    live = keys >= 0
    valid = live & (fields >= 0) & (fields < f)
    kl = keys.clamp(min=0).long()
    xk = (torch.ones((b, n), dtype=torch.float64, device=dev) if x is None
          else x.double()) * live
    out = {"logit": torch.zeros(b, dtype=torch.float64, device=dev)}
    rows = v.shape[0]
    if not logit_only:
        tol = {"w": torch.zeros((rows, 1), dtype=torch.float64, device=dev),
               "v": torch.zeros((rows, e), dtype=torch.float64, device=dev)}
        mag = {k: torch.zeros_like(t) for k, t in tol.items()}
        ll_err, ll_abs = 0.0, 0.0
    for r0 in range(0, b, chunk):
        sl = slice(r0, min(b, r0 + chunk))
        c = sl.stop - sl.start
        xs, ok = xk[sl], valid[sl]
        xe = xs * ok
        vr = v[kl[sl]].double()  # [c, n, e]
        vx = vr * xe[..., None]
        fl = torch.where(ok, fields[sl].long(), torch.full_like(kl[sl], f))
        idx = (torch.arange(c, device=dev)[:, None] * (f + 1) + fl).reshape(-1)

        def per_field(vals):
            acc = torch.zeros((c * (f + 1), vals.shape[-1]), dtype=torch.float64,
                              device=dev)
            acc.index_add_(0, idx, vals.reshape(-1, vals.shape[-1]))
            return acc.view(c, f + 1, -1)[:, :f]

        s = per_field(vx).reshape(c, f, f, d)
        cnt = per_field(ok.double()[..., None])[..., None]  # [c, f, 1, 1]
        es = EPS32 * (cnt + 1) * per_field(vx.abs()).reshape(c, f, f, d)
        dvx = None
        if dv is not None:  # the sides' v apart: S moves by sum |x| dv
            dvx = dv[kl[sl]].double() * xe.abs()[..., None]
            es = es + per_field(dvx).reshape(c, f, f, d)
        st, est = s.transpose(1, 2), es.transpose(1, 2)
        prod = (s * st).abs().sum((1, 2, 3))
        cross = (s * st).sum((1, 2, 3))
        err_cross = ((es * st.abs() + s.abs() * est + es * est).sum((1, 2, 3))
                     + EPS32 * (f * f * d + 2) * prod)
        own_block = (torch.arange(e, device=dev) // d)[None, None, :] == fl[..., None]
        diag = torch.where(own_block, vx * vx, torch.zeros_like(vx)).sum((1, 2))
        err_diag = EPS32 * (n * d + 2) * diag
        if dvx is not None:
            err_diag = err_diag + torch.where(own_block, 2 * vx.abs() * dvx + dvx * dvx,
                                              torch.zeros_like(vx)).sum((1, 2))
        lin_terms = w[kl[sl], 0].double() * xs
        lin = lin_terms.sum(1)
        err_lin = EPS32 * (n + 2) * lin_terms.abs().sum(1)
        if dw is not None:
            err_lin = err_lin + (dw[kl[sl], 0].double() * xs.abs()).sum(1)
        logit = lin + 0.5 * (cross - diag)
        el = err_lin + 0.5 * (err_cross + err_diag) + 3 * EPS32 * (
            lin.abs() + 0.5 * cross.abs() + 0.5 * diag)
        out["logit"][sl] = 2 * el
        if logit_only:
            continue
        dl = 2 * el
        p = torch.sigmoid(logit)
        dp = p * (1 - p) * dl + 4 * EPS32 * p
        y, wt = labels[sl].double(), weights[sl].double()
        r = (p - y) * wt / num_real
        dr = dp * wt / num_real + 4 * EPS32 * r.abs()
        ar = torch.arange(c, device=dev)[:, None]
        fc = fl.clamp(max=f - 1)
        own = s.permute(0, 2, 1, 3)[ar, fc]  # S[f2, f_i, :] per slot: [c, n, f, d]
        eown = es.permute(0, 2, 1, 3)[ar, fc]
        same = (torch.arange(f, device=dev)[None, None, :] == fc[..., None])[..., None]
        v4 = vr.view(c, n, f, d)
        x4 = xe[..., None, None]
        inner = own - torch.where(same, v4 * x4, torch.zeros_like(v4))
        g = x4 * inner
        own_err = EPS32 * (v4 * x4).abs()
        if dvx is not None:
            own_err = own_err + dvx.view(c, n, f, d)
        eg = x4.abs() * (eown + torch.where(same, own_err, 0.0) + 2 * EPS32 * inner.abs())
        occ_v = (g * r[:, None, None, None]).reshape(c, n, e)
        err_v = (eg * r.abs()[:, None, None, None]
                 + g.abs() * dr[:, None, None, None]).reshape(c, n, e) + 2 * EPS32 * occ_v.abs()
        occ_w = xs * r[:, None]
        err_w = xs.abs() * dr[:, None] + 2 * EPS32 * occ_w.abs()
        lk = kl[sl][live[sl]]
        tol["v"].index_add_(0, kl[sl][ok], err_v[ok])
        mag["v"].index_add_(0, kl[sl][ok], occ_v[ok].abs())
        tol["w"].index_add_(0, lk, err_w[live[sl]][:, None])
        mag["w"].index_add_(0, lk, occ_w[live[sl]].abs()[:, None])
        pc = torch.where(logit < -30, torch.full_like(p, 1e-6), p)
        pc = torch.where(logit > 30, torch.ones_like(pc), pc).clamp(1e-6, 1 - 1e-6)
        dpc = p * (1 - p) * dl + 4 * EPS32 * pc + torch.where(
            (logit + 30).abs() <= dl, 1e-6, 0.0)
        ll = -(y * torch.log(pc) + (1 - y) * torch.log(1 - pc)) * wt
        ll_err += float((dpc / torch.minimum(pc, 1 - pc) * wt).sum())
        ll_abs += float(ll.abs().sum())
    if logit_only:
        return out
    count = {}
    flat_live = kl[live]
    count["w"] = torch.bincount(flat_live, minlength=rows).double()[:, None]
    count["v"] = torch.bincount(kl[valid], minlength=rows).double()[:, None]
    for k in ("w", "v"):
        out[k] = 2 * (tol[k] + EPS32 * (count[k] + 4) * mag[k])
    out["logloss"] = 2 * (ll_err + EPS32 * (b + 4) * ll_abs)
    return out


def ffm_bounds(view: dict, f: int, d: int, hot_size: int, train: bool,
               index: bool = False) -> dict:
    """K1's (``train`` False: w and v rows read, pctr written) or K2's
    (w and v rows read, their gradient rows read and written; K4's slot
    plane in ``index`` mode) least time on this card for THIS batch:
    each byte once, or the float32 operations (per live slot 2 F D for
    the sums and, in K2, 5 F D for the backward; per example 2 F^2 D for
    the cross term), whichever is longer."""
    import torch

    keys, hot = view["ckeys"], view.get("hot")
    live_keys, hot_bytes = hot_stream(keys, hot, hot_size)
    b, k = keys.shape
    kh = hot.shape[1] if hot is not None else 0
    e = f * d
    stream = (4 * b * k + hot_bytes + b * (k + kh) * view["fields"].element_size()
              + (4 * b * k if view.get("x") is not None else 0)
              + (2 * b * view["labels_u8"].element_size() if train else 4 * b))
    rows = int(torch.unique(live_keys).numel())
    live = int(live_keys.numel())
    used = stream + rows * (3 if train else 1) * (4 + 4 * e) + (4 * b * k if index else 0)
    ops = live * e * (7 if train else 2) + b * 2 * f * f * d
    used_ms = used / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(used_ms, ops_ms),
            "bound_by": "bytes" if used_ms >= ops_ms else "operations",
            "bound_bytes": used, "bound_ops": ops, "distinct_rows": rows,
            "live_slots": live}


def ffm_planes(b: int, kc: int, kh: int, h: int, t: int, f: int, g, dev,
               full: bool = False) -> dict:
    """K1's FFM inputs at a serving shape: make_keys' cold plane cut to
    ``kc`` slots (x values on the full wire), a hot plane of ``kh``
    slots (hot_keys: u16, or int32 on the full wire), and field planes
    over ``f`` fields with about 5 % outside it (the u8 clamp's 255, or
    on the full wire's int32 planes negative ids and ids past f)."""
    import torch

    def fields(shape):
        fl = torch.randint(0, f, shape, generator=g, device=dev)
        r = torch.rand(shape, generator=g, device=dev)
        if full:
            fl[r < 0.03] = -2
            fl[(r >= 0.03) & (r < 0.05)] = f + 3
            return fl.to(torch.int32).contiguous()
        fl[r < 0.05] = 255
        return fl.to(torch.uint8).contiguous()

    keys, x = make_keys(b, t, g, dev, full)
    keys = keys[:, :kc].contiguous()
    out = {"ckeys": keys, "fields": fields((b, kc)), "max_fields": f, "form": "ffm"}
    if full:
        out["x"] = x[:, :kc].contiguous()
    if kh:
        out.update(hot=hot_keys(b, kh, h, g, dev, not full), hot_fields=fields((b, kh)))
        if full:
            hk = out["hot"]
            out["hot_x"] = torch.where(hk >= 0, torch.rand(hk.shape, generator=g, device=dev)
                                       + 0.5, 0.0).contiguous()
    return out


def ffm_k1_case(pl: dict, w, v, h: int, bf16: bool, worst: dict, case: str) -> None:
    """K1's FFM form against score_plain on one batch of planes: the
    logit within ffm_tolerances' bound (over w with its head rounded to
    bfloat16 under the flag, v as it is) and pctr within PCTR_ATOL plus
    that bound through the sigmoid's slope."""
    import torch

    from xflow_tpu_torch.ops.hot import to_bf16_f32
    from xflow_tpu_torch.ops.score import hot_plane_keys, score, score_plain

    kh = pl["hot"].shape[1] if "hot" in pl else 0
    kw = dict(hot=pl.get("hot"), hot_x=pl.get("hot_x"), hot_size=h if kh else 0,
              hot_bf16=bf16, **field_kw(pl))
    got_p, got_l = score(pl["ckeys"], pl.get("x"), w, v, True, **kw)
    want_p, want_l = score_plain(pl["ckeys"], pl.get("x"), w, v, True, **kw)
    torch.cuda.synchronize()
    keys, x = pl["ckeys"].long(), pl.get("x")
    if kh:
        keys = torch.cat([hot_plane_keys(pl["hot"], h), keys], dim=1)
        if x is not None:
            x = torch.cat([pl["hot_x"], x], dim=1)
    wb = w
    if bf16:  # the bound over the rounded head both sides read (w alone)
        wb = w.clone()
        wb[:h] = to_bf16_f32(w[:h])
    ltol = 1.01 * ffm_tolerances(keys, view_fields(pl), x, None, None, 1.0, wb, v,
                                 pl["max_fields"], logit_only=True)["logit"] + 1e-7
    ptol = PCTR_ATOL + want_p * (1 - want_p) * ltol
    if (float(((got_l - want_l).abs() - ltol).max()) > 0
            or float(((got_p - want_p).abs() - ptol).max()) > 0
            or not bool(torch.isfinite(got_p).all())):
        raise AssertionError(f"K1 FFM form disagrees with score_plain: {case}")
    worst["max_abs_err"] = max(worst["max_abs_err"], float((got_p - want_p).abs().max()))
    worst["max_abs_err_logit"] = max(worst["max_abs_err_logit"],
                                     float((got_l - want_l).abs().max()))
    worst["clamped"] += int((want_l.abs() > 30).sum())
    worst["cases"] += 1


def phase_ffm_k1(dev) -> dict:
    """Phase 28: K1's FFM form against score_plain at T = 2^21: the
    flagship ``ffm`` planes (40 cold slots, u8 fields, F = 39, D = 4) on
    the compact wire and on the full wire (values, int32 fields with
    negative ids and ids past F), the ``ffm_hot`` planes (12 cold + 32
    hot slots, u16 ids at H = 2^14) with and without the bf16 flag (w's
    head alone rounds), every serving bucket; rows [0, 64) of w hold 12
    and rows [64, 128) -12, so steered rows reach the clamps.  K1 timed
    at B = 512 on the flagship planes.  Then (phase 33) the same checks
    at D = 16 (F = 39) and F = 64 (D = 4), where K1 runs two D-tiles,
    and K1 timed there."""
    import torch

    from xflow_tpu_torch.ops.score import ffm_tile, score, score_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    t, h = 1 << FFM_T_LOG2, 1 << FFM_HOT["hot_size_log2"]
    w = torch.randn((t, 1), generator=g, device=dev) * 0.3
    w[:64] = 12.0
    w[64:128] = -12.0
    v = torch.randn((t, FFM_FIELDS * FFM_DIM), generator=g, device=dev) * 0.1
    worst = {"max_abs_err": 0.0, "max_abs_err_logit": 0.0, "cases": 0, "clamped": 0}
    for case, kc, kh, bf16, full in (("ffm K=40", K, 0, False, False),
                                     ("ffm K=40 full wire", K, 0, False, True),
                                     ("ffm_hot u16 H=2^14", 12, 32, False, False),
                                     ("ffm_hot u16 H=2^14 bf16", 12, 32, True, False),
                                     ("ffm_hot int32 full wire", 12, 32, False, True)):
        for b in BUCKETS:
            pl = ffm_planes(b, kc, kh, h, t, FFM_FIELDS, g, dev, full=full)
            ffm_k1_case(pl, w, v, h, bf16, worst, f"{case} B={b}")
    if not worst["clamped"]:
        raise AssertionError("phase 28 did not reach the sigmoid's clamps")
    b = BUCKETS[-1]
    pool = [ffm_planes(b, K, 0, h, t, FFM_FIELDS, g, dev) for _ in range(KEY_POOL)]
    args = [(pool[i % KEY_POOL],) for i in range(TIMED_RUNS)]

    def kernel(pl):
        return score(pl["ckeys"], None, w, v, **field_kw(pl))

    def plain(pl):
        return score_plain(pl["ckeys"], None, w, v, **field_kw(pl))

    worst["timing"] = {"kernel": "score (ffm)", "model": "ffm", "B": b, "K": K,
                       "F": FFM_FIELDS, "D": FFM_DIM, "plane": "int32 keys, u8 fields",
                       "ms": time_device_ms(kernel, args),
                       "host_path_ms": time_host_path_ms(kernel, args),
                       "plain_ms": time_device_ms(plain, args),
                       **ffm_bounds(pool[0], FFM_FIELDS, FFM_DIM, 0, train=False),
                       "library_ms": None, "library_why_null": FFM_LIBRARY_WHY_NULL}
    log(json.dumps({"phase": 28, "k1_ffm": worst}))
    del v, pool
    torch.cuda.empty_cache()
    # phase 33: two D-tiles
    tw = 1 << FFM_WIDE_T_LOG2
    wide = {"max_abs_err": 0.0, "max_abs_err_logit": 0.0, "cases": 0, "clamped": 0,
            "shapes": []}
    for d, f in FFM_WIDE:
        vw = (torch.randn((tw, f * d), generator=g, device=dev) * (0.1 * math.sqrt(4 / d)))
        ww = w[:tw].contiguous()
        tiles = math.ceil(d / ffm_tile(f, d, K))
        if tiles < 2:
            raise AssertionError(f"D={d} F={f} runs {tiles} tile")
        for b in BUCKETS:
            for full in (False, True):
                pl = ffm_planes(b, K, 0, h, tw, f, g, dev, full=full)
                ffm_k1_case(pl, ww, vw, h, False, wide, f"D={d} F={f} B={b}")
        pool = [ffm_planes(BUCKETS[-1], K, 0, h, tw, f, g, dev) for _ in range(KEY_POOL)]
        args = [(pool[i % KEY_POOL],) for i in range(TIMED_RUNS)]

        def kernel_w(pl, ww=ww, vw=vw):
            return score(pl["ckeys"], None, ww, vw, **field_kw(pl))

        def plain_w(pl, ww=ww, vw=vw):
            return score_plain(pl["ckeys"], None, ww, vw, **field_kw(pl))

        wide["shapes"].append({
            "kernel": "score (ffm, D tiled)", "B": BUCKETS[-1], "K": K, "F": f, "D": d,
            "tiles": tiles, "ms": time_device_ms(kernel_w, args),
            "plain_ms": time_device_ms(plain_w, args),
            **ffm_bounds(pool[0], f, d, 0, train=False), "library_ms": None,
            "library_why_null": FFM_LIBRARY_WHY_NULL})
        del vw, pool
        torch.cuda.empty_cache()
    log(json.dumps({"phase": 33, "k1_ffm_d_tiled": wide}))
    del w
    return {"k1": worst, "k1_wide": wide}


def ffm_view(arrays: dict, rows: int | None = None, num_real: float | None = None) -> dict:
    """A shipped batch (or its first ``rows`` rows: a sequential slice
    at ``num_real``) as the FFM checks read it."""
    import torch

    if rows is None:
        view = dict(arrays)
    else:
        view = {k: a[:rows] for k, a in arrays.items() if isinstance(a, torch.Tensor)}
        view["num_real"] = num_real
    view.update(max_fields=FFM_FIELDS, form="ffm")
    return view


def check_ffm_k2(case: str, form: str, view: dict, tables: dict, h: int, worst: dict,
                 unclamped: bool = False) -> None:
    """K2's FFM form against train_plain on one batch or slice
    (``k2_hot_call``'s forms: "dense" — hot gradients in g's first H
    rows — and "hybrid": index mode, with a head buffer when the view
    has a hot plane), compared in table-row space at the batch's
    distinct rows within ffm_tolerances' per-row bound over the hot and
    cold planes together (every other row 0 on both sides); the log-loss
    sum within its bound, the count exact.  With ``unclamped`` the
    tables' w is -1 everywhere and every label 0, so each row of the
    synth traffic (39 live slots) has a logit near -39, below -30 and
    above float32's underflow: the kernel's gradients must match the
    plain version's unclamped residual, and lie 1,000 times under what
    the clamped sigmoid's 1e-6 would give."""
    import torch

    from xflow_tpu_torch.ops.score import hot_plane_keys
    from xflow_tpu_torch.ops.train import train_plain, train_step

    if unclamped:
        tables = {"w": {"param": torch.full_like(tables["w"]["param"], -1.0)},
                  "v": tables["v"]}
        view = dict(view, labels_u8=torch.zeros_like(view["labels_u8"]))
    w, v = tables["w"]["param"], tables["v"]["param"]
    outs = []
    for fn in (train_step, train_plain):
        args, kw, rows = k2_hot_call(form, view, tables, h)
        fn(*args, **kw)
        outs.append(rows())
    torch.cuda.synchronize()
    keys = view["ckeys"].long()
    if "hot" in view:
        keys = torch.cat([hot_plane_keys(view["hot"], h), keys], dim=1)
    uk = torch.unique(keys[keys >= 0])
    local = torch.where(keys >= 0, torch.searchsorted(uk, keys.clamp(min=0)),
                        torch.full_like(keys, -1))
    tols = ffm_tolerances(local, view_fields(view), None, view["labels_u8"],
                          view["weights_u8"], view["num_real"], w[uk], v[uk],
                          view["max_fields"])
    (gk, acc), (gp, pacc) = outs
    for name in ("w", "v"):
        a, b = gk[name][uk].double(), gp[name][uk].double()
        diff = (a - b).abs()
        excess = float((diff - tols[name]).max())
        elsewhere = (int((gk[name] != 0).sum()) - int((gk[name][uk] != 0).sum()),
                     int((gp[name] != 0).sum()) - int((gp[name][uk] != 0).sum()))
        if excess > 0 or elsewhere != (0, 0) or not bool(torch.isfinite(gk[name]).all()):
            raise AssertionError(f"K2 FFM {form} form disagrees with train_plain: {case} "
                                 f"{name} excess {excess}, rows outside the batch {elsewhere}")
        worst["max_abs_err_g"] = max(worst["max_abs_err_g"], float(diff.max()))
        ratio = diff / torch.where(tols[name] > 0, tols[name], 1.0)
        worst["max_err_over_tol"] = max(worst["max_err_over_tol"], float(ratio.max()))
        if unclamped:
            clamp_scale = 1e-6 / view["num_real"]
            top = float(gk[name].abs().max())
            if not 0 < top < 1e-3 * clamp_scale:
                raise AssertionError(f"K2 FFM below -30: {name} gradients up to {top}, "
                                     f"the clamped residual's would be ~{clamp_scale}")
            worst["unclamped"] = {"max_abs_g": top, "clamped_residual_scale": clamp_scale}
    if abs(float(acc[0]) - float(pacc[0])) > tols["logloss"] or float(acc[1]) != float(pacc[1]):
        raise AssertionError(f"K2 FFM {form} form log-loss/count {acc.tolist()} vs plain "
                             f"{pacc.tolist()} ({case})")
    worst["cases"] += 1
    del outs, gk, gp
    torch.cuda.empty_cache()


def time_ffm_k2(label: str, form: str, view: dict, tables: dict, h: int, flush,
                name: str, phase: int = 32) -> dict:
    """K2's FFM form timed alone on one batch (or slice) of its path,
    beside its plain version (k2_hot_call's buffers, the plan made once
    before; each call behind an L2 flush), with ffm_bounds."""
    import torch

    from xflow_tpu_torch.ops.train import train_plain, train_step

    torch.cuda.empty_cache()
    args, kw, _ = k2_hot_call(form, view, tables, h)

    def kernel():
        train_step(*args, **kw)

    def plain():
        train_plain(*args, **kw)

    f = view["max_fields"]
    d = tables["v"]["param"].shape[1] // f
    row = {"kernel": name, "model": "ffm", "path": label, "B": view["ckeys"].shape[0],
           "Kc": view["ckeys"].shape[1], "Kh": view["hot"].shape[1] if "hot" in view else 0,
           "H": h if "hot" in view else 0, "F": f, "D": d,
           "ms": time_device_ms(kernel, [()] * TIMED_RUNS, prelude=flush.zero_),
           "plain_ms": time_device_ms(plain, [()] * 10, prelude=flush.zero_, chunk_size=2),
           **ffm_bounds(view, f, d, h, train=True, index=form == "hybrid"),
           "library_ms": None, "library_why_null": FFM_LIBRARY_WHY_NULL}
    del args, kw
    log(json.dumps(dict(row, phase=phase)))
    return row


def ffm_wide_k2(dev, worst: dict, flush) -> list:
    """Phase 33's K2 half: K2's FFM form at D = 16 (F = 39) and F = 64
    (D = 4), two D-tiles each, against train_plain on a 65,536-row
    compact batch of 40 slots (u8 fields, 5 % at 255) at T = 2^20, and
    timed there."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    tw = 1 << FFM_WIDE_T_LOG2
    rows = []
    for d, f in FFM_WIDE:
        b = TRAIN_BATCHES[-1]
        tables = {"w": {"param": torch.randn((tw, 1), generator=g, device=dev) * 0.3},
                  "v": {"param": torch.randn((tw, f * d), generator=g, device=dev)
                        * (0.1 * math.sqrt(4 / d))}}
        pl = ffm_planes(b, K, 0, 0, tw, f, g, dev)
        labels = (torch.rand(b, generator=g, device=dev) < 0.3).to(torch.uint8)
        weights = torch.ones(b, dtype=torch.uint8, device=dev)
        weights[-5:] = 0
        view = dict(pl, labels_u8=labels, weights_u8=weights,
                    num_real=max(float(weights.sum()), 1.0))
        check_ffm_k2(f"D={d} F={f} B={b}", "dense", view, tables, 0, worst)
        rows.append(time_ffm_k2(f"synthetic D={d} F={f}", "dense", view, tables, 0, flush,
                                "train_step (ffm, D tiled)", phase=33))
        del tables, view, pl
        torch.cuda.empty_cache()
    return rows


# Phase 33's edges of K2's FFM form at B = 2,048, T = 2^20: (label, D,
# F, cold slots, hot slots, form, edit).  Its vector reductions run
# where one tile holds D and D % 4 == 0 (D = 4 at F = 39); D = 3 and the
# two-tile shapes (D = 16, F = 64) keep one atomic a column.  A key in
# every example takes a reduction of every row on the same 16-byte
# groups; a key twice in one example (in one field, and in two) sums
# two slots' rows into one destination; index mode and the head buffer
# are the sparse and hybrid paths' destinations
FFM_EDGE_ROWS = 2048
FFM_EDGE = (
    ("D=4", 4, 39, K, 0, "dense", None),
    ("D=4 index mode", 4, 39, K, 0, "hybrid", None),
    ("D=4 hot plane into g's first H rows", 4, 39, 12, 32, "dense", None),
    ("D=4 hot plane, index mode and head buffer", 4, 39, 12, 32, "hybrid", None),
    ("D=3", 3, 39, K, 0, "dense", None),
    ("D=3 index mode", 3, 39, K, 0, "hybrid", None),
    ("D=16 index mode", 16, 39, K, 0, "hybrid", None),
    ("F=64 index mode", 4, 64, K, 0, "hybrid", None),
    ("one key in every example", 4, 39, K, 0, "dense", "one key"),
    ("one key in every example, index mode", 4, 39, K, 0, "hybrid", "one key"),
    ("one key twice in one example", 4, 39, K, 0, "dense", "twice"),
    ("one key twice in one example, index mode", 4, 39, K, 0, "hybrid", "twice"),
)


def ffm_edge_k2(dev, worst: dict) -> list:
    """Phase 33's FFM_EDGE cases: K2's FFM form against train_plain
    (check_ffm_k2's per-row bound) on seed-made compact planes (u8
    fields, 5 % at 255; the hot plane u16 at H = 2^14)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    tw, h, b = 1 << FFM_WIDE_T_LOG2, 1 << FFM_HOT["hot_size_log2"], FFM_EDGE_ROWS
    cases = []
    for label, d, f, kc, kh, form, edit in FFM_EDGE:
        tables = {"w": {"param": torch.randn((tw, 1), generator=g, device=dev) * 0.3},
                  "v": {"param": torch.randn((tw, f * d), generator=g, device=dev)
                        * (0.1 * math.sqrt(4 / d))}}
        pl = ffm_planes(b, kc, kh, h, tw, f, g, dev)
        if edit == "one key":
            pl["ckeys"][:, 0] = 5
            pl["fields"][:, 0] = 3
        elif edit == "twice":
            pl["ckeys"][0, :2] = 77
            pl["fields"][0, :2] = 4
            pl["ckeys"][1, :2] = 78
            pl["fields"][1, 0], pl["fields"][1, 1] = 4, 9
        labels = (torch.rand(b, generator=g, device=dev) < 0.3).to(torch.uint8)
        weights = torch.ones(b, dtype=torch.uint8, device=dev)
        view = dict(pl, labels_u8=labels, weights_u8=weights, num_real=float(b))
        check_ffm_k2(f"{label} B={b}", form, view, tables, h, worst)
        cases.append(label)
        del tables, view, pl
    torch.cuda.empty_cache()
    return cases


def ffm_dict_decode(cfg, trainer, dev) -> dict:
    """K6 with the field streams on the ``ffm`` path's first batch, as
    its loader builds it: exactly its plain version, and timed (device
    ms behind _sleep, plain ms, the byte bound over every plane read
    and written)."""
    import torch

    from xflow_tpu_torch.io.compact import compact_batch
    from xflow_tpu_torch.ops.wire import dict_decode, dict_decode_plain, to_device

    loader = trainer._loader(f"{cfg.train_path}-00000")
    batch = next(iter(loader.iter_batches()))[0]
    wire = compact_batch(batch, cfg.table_size, cfg.hot_size).wire(ship_slots=True)
    planes = to_device(wire, dev)
    kc, kh = batch.max_nnz, 0
    got = dict_decode(planes, kc, kh)
    want = dict_decode_plain(planes, kc, kh)
    torch.cuda.synchronize()
    if len(got) != len(want) or any(not torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("K6 with the field streams differs from its plain version on "
                             "the ffm batch")
    in_bytes = sum(int(a.nbytes) for k, a in wire.items() if k != "cw_cun")
    out_bytes = batch.batch_size * (5 * kc + 2)
    return hot_timing_row(
        "dict_decode (field streams)", dict_decode, dict_decode_plain,
        [(planes, kc, kh)] * TIMED_RUNS,
        {"bound_ms": (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "bytes": in_bytes + out_bytes}, phase=32,
        model="ffm", B=batch.batch_size, K=kc, Kh=kh, max_abs_err=0.0,
        library_why_null=K6_LIBRARY_WHY_NULL)


def ffm_k3_timings(trainer, flush, grads: dict, head: int = 0) -> list:
    """K3 over copies of the trained ``ffm`` tables ([2^21, 1] and
    [2^21, 156], FTRL), or over their first ``head`` rows (the hybrid's
    head step), with g restored before every call to ``grads`` (what one
    K2 launch leaves for the path's batch 0) and an L2 flush: the dense
    paths' per-table pass."""
    import torch

    rows = []
    opt = trainer.step.optimizer
    for name, table in trainer.state["tables"].items():
        copy = {k: (a[:head] if head else a).clone() for k, a in table.items()}
        g_src = grads[name][:head] if head else grads[name]
        copy["g"] = torch.zeros_like(copy["param"])
        rows.append(k3_timing_row(copy, opt, g_src, prelude=flush.zero_, plain_runs=10,
                                  kernel="optim_update" + (" (head rows)" if head else ""),
                                  model="ffm", table=name,
                                  g="one FFM K2 launch on the path's batch 0"))
        log(json.dumps(dict(rows[-1], phase=32)))
        del copy
        torch.cuda.empty_cache()
    return rows


def ffm_path_grads(view: dict, tables: dict, h: int) -> dict:
    """The g one dense K2 launch leaves for ``view`` (FFM form; the hot
    gradients in the first ``h`` rows), by table name."""
    args, kw, rows = k2_hot_call("dense", view, tables, h)
    from xflow_tpu_torch.ops.train import train_step

    train_step(*args, **kw)
    g, _ = rows()
    del args, kw
    return g


FFM_MODES = (
    # (label, geometry, mode, one dispatch): the flagship's dense
    # microbatch 4, the sparse mode, the sequential sparse inner at
    # microbatch 128 (B_eff = 512), one dispatch each of dense
    # microbatch 1 and the sequential dense inner (microbatch 2); then
    # ffm_hot dense and the hybrid (sequential + sparse inner, 128).
    # The sequential paths train one epoch (2 dispatches): their AUC
    # clears the planted floor in one, and the time limit wants it
    ("dense_mb4", FFM, {}, False),
    ("sparse", FFM, {"update_mode": "sparse", "microbatch": 1}, False),
    ("sequential_sparse_mb128", FFM, {"update_mode": "sequential",
                                      "microbatch": SEQ_MICROBATCH,
                                      "sequential_inner": "sparse", "epochs": 1}, False),
    ("dense_mb1", FFM, {"microbatch": 1}, True),
    ("sequential_dense_mb2", FFM, {"update_mode": "sequential", "microbatch": 2}, True),
    ("hot_dense", FFM_HOT, {}, False),
    ("hot_hybrid_mb128", FFM_HOT, {"update_mode": "sequential",
                                   "microbatch": SEQ_MICROBATCH,
                                   "sequential_inner": "sparse", "epochs": 1}, False),
)


def phase_ffm(dev, workdir: str, dense: dict) -> dict:
    """Phases 28-33 at the flagship ``ffm`` (scripts/bench_models.py:84-92:
    T = 2^21, 40 slots, ffm_v_dim 4, max_fields 39, microbatch 4, FTRL,
    batch 65,536; phase 8's shards) and ``ffm_hot`` (12 cold + 32 hot
    slots, H = 2^14): 28 K1's FFM form against its plain version; 29
    serving a full-width ``ffm`` and a hot ``ffm`` artifact; 30 training
    ``ffm`` on the default input path (native text, dictionary wire with
    the field streams) in FFM_MODES' first five modes and 31 ``ffm_hot``
    dense and hybrid (2 epochs dense, 1 sequential, one dispatch for the
    one-dispatch modes) from one seeded initial state: exact launches, the card
    against the CPU within TRAIN_BOUNDS (every path's tables through
    ``lockstep_tables``), the sync guard on the sequential paths' first
    dispatch, the eval AUC inside the planted bars; and the hot inner
    refused with the reference's message; 32 K2's FFM form against its
    plain version on the paths' own batches (dense 65,536 rows with and
    without the hot plane, index mode on the sparse path's batch and the
    sequential slice 0, the hybrid's slice 0, and the dense batch with
    every logit below -30), K6 with the field streams and K3 on the
    path's tables, each timed; 33 K1 and K2 at two D-tiles."""
    import torch

    from xflow_tpu_torch.models import make_model
    from xflow_tpu_torch.optim import make_optimizer
    from xflow_tpu_torch.parallel.step import TrainStep

    data, bars = dense["data"], dense["bars"]
    one = single_shard(data, workdir)
    out = {"rows": [], "timings": [], "launches_by_path": {}}
    k2w = {"max_abs_err_g": 0.0, "max_err_over_tol": 0.0, "cases": 0}
    out["checks"] = phase_ffm_k1(dev)
    torch.cuda.empty_cache()
    out["serve"] = phase_main_path(dev, FFM_T_LOG2, workdir, model="ffm", phase=(29, 29))
    torch.cuda.empty_cache()
    out["serve_hot"] = phase_main_path(dev, FFM_T_LOG2, workdir, hot=True, model="ffm",
                                       phase=(29, 29))
    torch.cuda.empty_cache()
    init = fresh_init(dev, mode_config("ffm", FFM_T_LOG2, data, "", **FFM))
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
    h = 1 << FFM_HOT["hot_size_log2"]
    for label, geom, mode, single in FFM_MODES:
        seq = mode.get("update_mode") == "sequential"
        hot = "hot_size_log2" in geom
        full_mode = dict(geom, **mode, **({"epochs": 1} if single else {}))
        # every FFM path through lockstep_tables: FTRL zeroes most v
        # elements it touches (|z| <= lambda1), and a gradient that
        # multiplies such an element is exactly 0 on a side where it is
        # 0 and a rounding's size where the soft threshold left it a
        # rounding's size, so FTRL's n' == 0 rule splits dense paths too.
        # The replay holds the first dispatch (the time limit); the
        # card's later dispatches are there for the eval AUC's bars
        run = run_mode(dev, "ffm", FFM_T_LOG2, one if single else data, init, full_mode,
                       label, workdir, evaluate=not single, keep=True,
                       bars=None if single else bars, lockstep=True,
                       sync_check=seq and not single, replay_dispatches=1)
        log(f"phase {31 if hot else 30}: ffm {label} done at "
            f"{time.perf_counter() - T_START:.1f} s")
        row = dict(run["row"], phase=31 if hot else 30)
        trainer = run["trainer"]
        tables = trainer.state["tables"]
        if not single:
            arrays = run["shipped"][0]
            if seq:
                rows = arrays["ckeys"].shape[0] // SEQ_MICROBATCH
                view = ffm_view(arrays, rows, arrays["slice_num_real"][0])
            else:
                view = ffm_view(arrays)
            hh = h if hot else 0
            form = "hybrid" if (seq or mode.get("update_mode") == "sparse") else "dense"
            what = f"ffm{'_hot' if hot else ''} {label} {'slice 0' if seq else 'batch 0'}"
            check_ffm_k2(what, form, view, tables, hh, k2w)
            name = {("dense", False): "train_step (ffm: dense)",
                    ("dense", True): "train_step (ffm: hot dense)",
                    ("hybrid", False): "train_step (ffm: index)",
                    ("hybrid", True): "train_step (ffm: hybrid)"}[(form, hot)]
            if seq and not hot:
                name = "train_step (ffm: index, slice 0)"
            out["timings"].append(time_ffm_k2(label, form, view, tables, hh, flush, name))
            if label == "dense_mb4":
                check_ffm_k2("ffm dense batch 0, logits below -30", "dense", view, tables, 0,
                             k2w, unclamped=True)
                out["timings"].append(ffm_dict_decode(trainer.cfg, trainer, dev))
                out["timings"] += ffm_k3_timings(trainer, flush,
                                                 ffm_path_grads(view, tables, 0))
            elif label == "hot_dense":
                out["timings"] += ffm_k3_timings(trainer, flush,
                                                 ffm_path_grads(view, tables, h), head=h)
            elif form == "hybrid" and not hot:  # K4 and K5 at FFM's width
                path = ("sparse main path" if not seq
                        else "sequential main path, slice 0")
                out["timings"] += sparse_kernel_timings(
                    "ffm", trainer, view["ckeys"], view["labels_u8"], view["weights_u8"],
                    view["num_real"], path, form_kw=field_kw(view), k2=False)
            del view, arrays
        out["rows"].append(row)
        out["launches_by_path"][f"ffm {label}"] = row["launches"]
        log(json.dumps(row))
        del run, trainer, tables
        torch.cuda.empty_cache()
    # the hot inner: refused with the reference's message
    cfg = mode_config("ffm", FFM_T_LOG2, data, "", **dict(
        FFM_HOT, update_mode="sequential", microbatch=SEQ_MICROBATCH,
        sequential_inner="hot"))
    try:
        TrainStep(make_model(cfg), make_optimizer(cfg), cfg, dev)
    except ValueError as e:
        if "opts table(s) ['v'] out of the MXU hot path" not in str(e):
            raise
        out["hot_inner_refused"] = str(e)
    else:
        raise AssertionError("ffm_hot with the hot inner was not refused")
    out["timings"] += ffm_wide_k2(dev, k2w, flush)
    k2w["edges"] = ffm_edge_k2(dev, k2w)
    out["checks"]["k2"] = k2w
    log(json.dumps({"phase": 32, "k2_ffm": k2w, "hot_inner_refused": out["hot_inner_refused"]}))
    del flush, init
    torch.cuda.empty_cache()
    return out


def ffm_train_rows(ffm: dict, card: str) -> list:
    """The ``train`` line's rows for the FFM paths (phases 30-31): device
    busy from the launches times each kernel's device ms at FFM's
    widths, measured on the path's own batch or slice 0 or its trained
    tables (phase 32: K2 by form, K6 with the field streams, K3 per
    table over the whole table or the head rows, K4 and one K5 over both
    tables on the sparse and sequential paths).  The hybrid's K5 with the fold is
    not timed at FFM's width: its busy share leaves it out."""
    ms = {(r["kernel"], r.get("table"), r.get("path")): r["ms"] for r in ffm["timings"]}

    def total(kernel, path=None):
        return sum(t for (k, _, p), t in ms.items() if k == kernel and (path is None
                                                                           or p == path))

    k2 = {"dense_mb4": "train_step (ffm: dense)", "sparse": "train_step (ffm: index)",
          "sequential_sparse_mb128": "train_step (ffm: index, slice 0)",
          "hot_dense": "train_step (ffm: hot dense)",
          "hot_hybrid_mb128": "train_step (ffm: hybrid)"}
    rows = []
    for row in ffm["rows"]:
        if "eval" not in row:
            continue
        n, label = row["launches"], row["mode"]
        tables = row["tables"]
        busy_ms = (n["train_step"] * total(k2[label])
                   + n["dict_decode"] * total("dict_decode (field streams)"))
        excluded = None
        if label in ("dense_mb4", "hot_dense"):
            busy_ms += row["steps"] * total("optim_update")
        elif label == "hot_hybrid_mb128":
            busy_ms += n["optim_update"] / tables * total("optim_update (head rows)")
            excluded = "K4 and K5 with the fold (not timed at FFM's width on this path)"
        else:
            path = "sparse main path" if label == "sparse" else "sequential main path, slice 0"
            busy_ms += (n["consolidate_keys"] * total("consolidate_keys", path)
                        + n["touched_update"] * total("touched_update", path))
        busy = busy_ms / 1e3
        rows.append({
            "model": "ffm" if not label.startswith("hot") else "ffm_hot", "mode": label,
            "card": card, "examples_per_sec": row["examples_per_sec"],
            "step_time_p50": row["step_time_p50"], "phases": row["phases"],
            "put_batch_ms_per_dispatch": [p["h2d"] / (row["steps"] / len(row["phases"])) * 1e3
                                          for p in row["phases"]],
            "train_seconds": row["train_seconds"],
            "device_busy_s_from_kernel_times": busy, "device_busy_excludes": excluded,
            "device_idle_share_from_kernel_times": 1.0 - busy / row["train_seconds"],
            "eval_auc": row["eval"]["auc"], "eval_logloss": row["eval"]["logloss"],
        })
    return rows


def launches_by_shape(rows: list, kernel: str, labels=None) -> dict:
    """``kernel``'s launches on the training paths ``rows`` (those of
    ``labels``, by default all) by the rows each launch covers: a
    sequential path's slices (the batch over its microbatch), the other
    paths' whole batches, and past those (K7 alone) the eval batches."""
    split: dict = {}
    batch = TRAIN_BATCHES[-1]
    for row in rows:
        if labels is not None and row["mode"] not in labels:
            continue
        mode = row["config"]
        s = mode.get("microbatch", 1) if mode.get("update_mode") == "sequential" else 1
        n, train = row["launches"][kernel], row["steps"] * s
        name = f"training, {batch // s}-row {'slices' if s > 1 else 'batches'}"
        split[name] = split.get(name, 0) + min(n, train)
        if n > train:
            name = f"eval, {min(TEST_LINES, batch)}-row batches"
            split[name] = split.get(name, 0) + n - train
    return split


def ffm_kernel_entries(ffm: dict) -> list:
    """The ``kernels`` line's entries for K1's and K2's FFM form (phases
    28-33): launches counted on their paths (each from 0 just before
    it), times on the paths' own batches, the second shape's (two
    D-tiles) beside them."""
    by_path = ffm["launches_by_path"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_why_null")

    def timing(kernel):
        return next(r for r in ffm["timings"] if r["kernel"] == kernel)

    def launches(kernel, labels):
        return sum(n[kernel] for path, n in by_path.items() if path.split(" ", 1)[1] in labels)

    k1 = ffm["checks"]["k1"]["timing"]
    k2 = ffm["checks"]["k2"]
    wide_k2 = [r for r in ffm["timings"] if r["kernel"] == "train_step (ffm, D tiled)"]
    every = tuple(p.split(" ", 1)[1] for p in by_path)
    entries = [{
        "name": "score (ffm)", "route": "cuda", "source": "xflow_tpu_torch/csrc/score.cu",
        "replaces": B10_REPLACES,
        "launches": (ffm["serve"]["launches"] + ffm["serve_hot"]["launches"]
                     + launches("score", every)),
        "launches_of": "the served ffm and ffm_hot artifacts (phase 29) and the FFM "
        "training paths' eval batches (phases 30-31)",
        "max_abs_err": max(ffm["checks"]["k1"]["max_abs_err"],
                           ffm["checks"]["k1_wide"]["max_abs_err"]),
        "host_path_ms": k1["host_path_ms"], **{k: k1[k] for k in keys},
        "shape": {k: k1[k] for k in ("model", "B", "K", "F", "D", "plane")},
        "second_shape": ffm["checks"]["k1_wide"]["shapes"]}]
    for name, labels in (("train_step (ffm: dense)", ("dense_mb4", "dense_mb1",
                                                      "sequential_dense_mb2", "hot_dense")),
                         ("train_step (ffm: index)", ("sparse", "sequential_sparse_mb128")),
                         ("train_step (ffm: hybrid)", ("hot_hybrid_mb128",))):
        t = timing(name)
        entry = {"name": name, "route": "cuda", "source": "xflow_tpu_torch/csrc/train.cu",
                 "replaces": B10_REPLACES + "; " + K2_REPLACES,
                 "launches": launches("train_step", labels),
                 "launches_of": ", ".join(f"ffm {x}" for x in labels),
                 "launches_by_shape": launches_by_shape(ffm["rows"], "train_step", labels),
                 "max_abs_err": k2["max_abs_err_g"], "max_err_over_tol": k2["max_err_over_tol"],
                 **{k: t[k] for k in keys},
                 "shape": {k: t[k] for k in ("path", "B", "Kc", "Kh", "H", "F", "D")}}
        if name.endswith("dense)"):
            entry["with_hot_plane"] = {k: timing("train_step (ffm: hot dense)")[k]
                                       for k in keys}
            entry["unclamped_residual_checked"] = k2.get("unclamped")
            entry["second_shape"] = wide_k2
        if name.endswith("index)"):
            entry["sequential_slice_0"] = {k: timing("train_step (ffm: index, slice 0)")[k]
                                           for k in keys}
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# B11: wide_deep, dcn and two_tower (phases 34-38)

# scripts/bench_models.py:93-108 at its accelerator size: T = 2^24, batch
# 65,536, max_fields 39, FTRL; wide_deep at the hot flagship (12 cold + 32
# hot slots, H = 2^14), dcn and two_tower at 40 cold slots
POOLED_FIELDS = 39
POOLED = {
    "wide_deep": {"emb_dim": 8, "hidden_dim": 64, "max_nnz": 12, "hot_size_log2": 14,
                  "hot_nnz": 32},
    "dcn": {"emb_dim": 8, "hidden_dim": 64, "max_nnz": K, "cross_layers": 2},
    "two_tower": {"emb_dim": 8, "hidden_dim": 64, "max_nnz": K, "tower_dim": 16,
                  "tower_split_field": 20},
}
POOLED_SEQ_SPARSE = {"update_mode": "sequential", "microbatch": SEQ_MICROBATCH,
                     "sequential_inner": "sparse"}
POOLED_MODES = (
    # (family, label, mode, one dispatch, AUC bar): wide_deep dense (2
    # epochs), the hybrid (1 epoch) and one dispatch of the hot inner;
    # dcn dense and one dispatch each of sparse and the sequential dense
    # inner (microbatch 2); two_tower's sequential sparse inner at the
    # tower rate of docs/CONVERGENCE.md (sgd_lr 0.02, 1 epoch) and one
    # dense dispatch.  Four updates at B = 65,536 cannot move a pure-dot
    # model off chance, and the one-dispatch paths hold no AUC: those
    # are held by lockstep_tables alone
    ("wide_deep", "dense", {}, False, True),
    ("wide_deep", "hot_hybrid_mb128", dict(POOLED_SEQ_SPARSE, epochs=1), False, True),
    ("wide_deep", "hot_inner_mb128", {"update_mode": "sequential",
                                      "microbatch": SEQ_MICROBATCH,
                                      "sequential_inner": "hot"}, True, False),
    ("dcn", "dense", {}, False, True),
    ("dcn", "sparse", {"update_mode": "sparse"}, True, False),
    ("dcn", "sequential_dense_mb2", {"update_mode": "sequential", "microbatch": 2}, True,
     False),
    ("two_tower", "sequential_sparse_mb128", dict(POOLED_SEQ_SPARSE, epochs=1, sgd_lr=0.02),
     False, True),
    ("two_tower", "dense", {}, True, False),
)
# a pooled slice queues about 40 launches (K4, K7, the head and its
# backward, K8, K5 and K3 per table, the dense SGD): 8 slices a segment
# stay well inside the card's ~1,000 pending launches.  (Run alone,
# without phases 10-14, the hybrid's first dispatch would be the first
# launch of K4 and K5, whose module load synchronises.)
POOLED_GUARD_SEGMENT = 8
B11_REPLACES = (
    "xflow_tpu/models/blocks.py:69 (B11 field_sum_tower: one_hot + einsum "
    "bkf,bke->bfe) + xflow_tpu/models/blocks.py:41 (masked_x / linear_term, the wide "
    "term); no pl.pallas_call in the reference"
)
B11_GRAD_REPLACES = (
    "xflow_tpu/parallel/step.py:49 (grads_from_rows: value_and_grad of the tower, "
    "the unclamped residual) + xflow_tpu/parallel/step.py:923 (B2 drop-mode scatter) + "
    "xflow_tpu/ops/sparse.py:110 (B5 index mode) + xflow_tpu/ops/hot.py:122 (B7 "
    "hot_scatter) + xflow_tpu/utils/metrics.py:49 (logloss_sum); no pl.pallas_call in "
    "the reference"
)
K8_LIBRARY_WHY_NULL = ("no single PyTorch call computes the tower's backward: the "
                       "gather of dP at each slot's field times x, the scatter-add of "
                       "those rows and of x * r into two tables' buffers, and the "
                       "log-loss (index_add_ is only the last of those steps)")


def pooled_config(family: str, data: dict, metrics_out: str, **mode):
    """A pooled family's flagship (POOLED) training on ``data``'s shards."""
    return mode_config(family, T_LOG2, data, metrics_out, **POOLED[family], **mode)


def shipped_view(arrays: dict, rows: int | None = None, num_real: float | None = None) -> dict:
    """The first ``rows`` rows of a shipped dispatch (the whole dispatch
    by default) as K7 and K8 read them."""
    n = arrays["ckeys"].shape[0] if rows is None else rows
    view = {k: a[:n] for k, a in arrays.items()
            if k in ("ckeys", "fields", "hot", "hot_fields", "labels_u8", "weights_u8")}
    view["num_real"] = arrays["num_real"] if num_real is None else num_real
    return view


def pool_args(view: dict, tables: dict, h: int) -> tuple:
    """field_pool's arguments for ``view`` over ``tables``."""
    kw = {"w": tables["w"]["param"] if "w" in tables else None, "hot": view.get("hot"),
          "hot_fields": view.get("hot_fields"), "hot_size": h if "hot" in view else 0}
    return (view["ckeys"], None, view["fields"], tables["emb"]["param"], POOLED_FIELDS), kw


def pool_magnitudes(view: dict, tables: dict, h: int):
    """K7's per-element bound on ``view``: twice n 2^-23 times the sum
    of the magnitudes the output sums (the plain version over |emb| and
    |w|), n the row's slots (hot + cold)."""
    from xflow_tpu_torch.ops.pool import field_pool_plain

    mags = {n: {"param": t["param"].abs()} for n, t in tables.items()}
    margs, mkw = pool_args(view, mags, h)
    pooled, wide = field_pool_plain(*margs, **mkw)
    n = view["ckeys"].shape[1] + (view["hot"].shape[1] if "hot" in view else 0)
    scale = 2.0 * n * 2.0 ** -23
    return scale * pooled, (scale * wide if wide is not None else None)


def head_grads(model, dense: dict, pooled, wide, view: dict):
    """The step's head on the card: (dP, r, logit) for the pooled tower,
    as TrainStep._pooled_grads forms them."""
    import torch

    leaf = pooled.detach().clone().requires_grad_(True)
    params = {k: p.detach().requires_grad_(True) for k, p in dense.items()}
    with torch.enable_grad():
        logit = model.head(params, leaf, wide)
    r = ((torch.sigmoid(logit) - view["labels_u8"].float()) * view["weights_u8"].float()
         / view["num_real"]).detach()
    dp = torch.autograd.grad(logit, leaf, grad_outputs=r)[0].contiguous()
    return dp, r, logit.detach()


def k8_call(view: dict, tables: dict, h: int, dp, r, logit, index: bool, head_buffer: bool):
    """K8's arguments and zeroed destinations on ``view``: the [T, D]
    buffers (dense; the hot plane in their first H rows), or index mode
    over K4's plain plan ([M, D] sums) with the hot plane in [H, D] head
    buffers (the hybrid)."""
    import torch

    from xflow_tpu_torch.ops.sparse import consolidate_keys_plain

    keys = view["ckeys"]
    dev = keys.device
    rows = keys.numel() if index else tables["emb"]["param"].shape[0]
    bufs = {n: torch.zeros(rows, t["param"].shape[1], device=dev) for n, t in tables.items()}
    hot = "hot" in view
    heads = {}
    if hot:
        heads = ({n: torch.zeros(h, t["param"].shape[1], device=dev)
                  for n, t in tables.items()} if head_buffer or index
                 else {n: b[:h] for n, b in bufs.items()})
    slots = None
    if index:
        plan = torch.empty_like(keys.cpu())
        consolidate_keys_plain(keys.cpu(), tables["emb"]["param"].shape[0],
                               torch.empty(keys.numel(), dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32), plan)
        slots = plan.to(dev)
    acc = torch.zeros(2, dtype=torch.float64, device=dev)
    args = (keys, None, view["fields"], dp, r, logit, view["labels_u8"], view["weights_u8"],
            POOLED_FIELDS, bufs["emb"], acc)
    kw = {"g_w": bufs.get("w"), "slots": slots, "hot": view.get("hot"),
          "hot_fields": view.get("hot_fields"), "hot_size": h if hot else 0,
          "hg_w": heads.get("w"), "hg_emb": heads.get("emb")}
    return args, kw, (bufs, heads, acc)


def check_pool_kernels(case: str, model, view: dict, tables: dict, dense: dict, h: int,
                       worst: dict, forms=("dense", "index")) -> dict:
    """K7 and K8 against their plain versions on ``view`` (on the card):
    K7's pooled tower and wide term within pool_magnitudes' bound; K8's
    sums (each destination row: twice its occurrences times 2^-23 times
    the sum of its terms' magnitudes) in each of ``forms``, its log-loss
    within B 2^-23 of the sum and its weight sum exactly.  Records the
    worst ratios in ``worst``; returns (pooled, dP) for the caller."""
    import torch

    from xflow_tpu_torch.ops.pool import (
        field_pool,
        field_pool_grad,
        field_pool_grad_plain,
        field_pool_plain,
    )

    args, kw = pool_args(view, tables, h)
    pooled, wide = field_pool(*args, **kw)
    want_p, want_w = field_pool_plain(*args, **kw)
    bound_p, bound_w = pool_magnitudes(view, tables, h)
    for name, got, want, bound in (("pooled", pooled, want_p, bound_p),
                                   ("wide", wide, want_w, bound_w)):
        if got is None:
            continue
        diff = (got - want).abs()
        excess = float((diff - bound).max())
        if excess > 0 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K7 disagrees with field_pool_plain: {case} {name} "
                                 f"excess {excess}")
        worst["k7_max_abs_err"] = max(worst["k7_max_abs_err"], float(diff.max()))
        worst["k7_max_err_over_tol"] = max(
            worst["k7_max_err_over_tol"],
            float((diff / torch.where(bound > 0, bound, 1.0)).max()))
    dp, r, logit = head_grads(model, dense, pooled, wide, view)
    check_k8(case, view, tables, h, dp, r, logit, worst, forms)
    return pooled, dp


def check_k8(case: str, view: dict, tables: dict, h: int, dp, r, logit, worst: dict,
             forms=("dense", "index")) -> None:
    """K8 against field_pool_grad_plain on ``view`` with the head's
    (dP, r, logit), in each of ``forms`` (dense, index, hybrid): each
    destination row within twice its occurrences times 2^-23 times the
    sum of its terms' magnitudes, the log-loss within B 2^-23 of the
    sum, the weight sum exactly.  Records the worst ratios in
    ``worst``."""
    import torch

    from xflow_tpu_torch.ops.pool import field_pool_grad, field_pool_grad_plain

    for form in forms:
        index = form != "dense"
        outs = []
        for fn in (field_pool_grad, field_pool_grad_plain):
            a, k, dst = k8_call(view, tables, h, dp, r, logit, index, form == "hybrid")
            fn(*a, **k)
            outs.append(dst)
        # the magnitudes and the occurrence counts each destination sums
        a, k, mag = k8_call(view, tables, h, dp.abs(), r.abs(), logit, index,
                            form == "hybrid")
        field_pool_grad_plain(*a, **k)
        a, k, cnt = k8_call(view, tables, h, torch.ones_like(dp), torch.ones_like(r), logit,
                            index, form == "hybrid")
        field_pool_grad_plain(*a, **k)
        (gk, hk, acc_k), (gp, hp, acc_p) = outs
        for part, (k_, p_, m_, c_) in (("cold", (gk, gp, mag[0], cnt[0])),
                                       ("head", (hk, hp, mag[1], cnt[1]))):
            for name in k_:
                if part == "head" and not index and form != "hybrid":
                    continue  # the dense form's head is g's first H rows, held above
                diff = (k_[name] - p_[name]).abs()
                bound = 2.0 * c_[name] * 2.0 ** -23 * m_[name]
                excess = float((diff - bound).max())
                if excess > 0 or not bool(torch.isfinite(k_[name]).all()):
                    raise AssertionError(f"K8 disagrees with field_pool_grad_plain: {case} "
                                         f"{form} {part} {name} excess {excess}")
                worst["k8_max_abs_err"] = max(worst["k8_max_abs_err"], float(diff.max()))
                worst["k8_max_err_over_tol"] = max(
                    worst["k8_max_err_over_tol"],
                    float((diff / torch.where(bound > 0, bound, 1.0)).max()))
        ll_bound = view["ckeys"].shape[0] * 2.0 ** -23 * abs(float(acc_p[0]))
        if abs(float(acc_k[0]) - float(acc_p[0])) > ll_bound or float(acc_k[1]) != float(
                acc_p[1]):
            raise AssertionError(f"K8 log-loss/count {acc_k.tolist()} vs plain "
                                 f"{acc_p.tolist()} ({case} {form})")
        worst["cases"] += 1
        del outs, mag, cnt
    torch.cuda.empty_cache()


def pool_bounds(view: dict, tables: dict, h: int, grad: bool) -> dict:
    """K7's (or with ``grad`` K8's) least time on ``view``: each input
    read once and each output written once, with the tables' rows read
    (and K8's destination rows read and written) once per distinct live
    key; the flops (2 per slot and factor) are far below the card's
    rate, so bytes bound it."""
    import torch

    keys = view_keys(view, h)
    live = keys >= 0
    distinct = int(torch.unique(keys[live]).numel())
    b, n = keys.shape
    e = tables["emb"]["param"].shape[1]
    width = e + (1 if "w" in tables else 0)
    planes = sum(t.numel() * t.element_size() for k, t in view.items()
                 if k in ("ckeys", "fields", "hot", "hot_fields"))
    tower = 4 * b * POOLED_FIELDS * e
    if grad:
        moved = (planes + tower + 4 * b * 2 + 2 * b * view["labels_u8"].element_size()
                 + 2 * 4 * width * distinct + 16)
    else:
        moved = planes + 4 * width * distinct + tower + (4 * b if "w" in tables else 0)
    ops = 2 * int(live.sum()) * e
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms
            else "operations", "bound_bytes": moved, "bound_ops": ops,
            "distinct_rows": distinct, "live_slots": int(live.sum())}


def embedding_bag_args(view: dict, tables: dict, h: int) -> tuple:
    """K7's library yardstick: one ``F.embedding_bag(mode="sum",
    per_sample_weights=x)`` over (row, field) bags, its inputs grouped
    by bag here (the sort is not timed).  The wide term is not in it."""
    import torch

    keys = view_keys(view, h)
    fields = view_fields(view)
    ok = (keys >= 0) & (fields >= 0) & (fields < POOLED_FIELDS)
    b = keys.shape[0]
    bag = torch.arange(b, device=keys.device)[:, None] * POOLED_FIELDS + fields.clamp(
        0, POOLED_FIELDS - 1)
    bag = torch.where(ok, bag, torch.full_like(bag, b * POOLED_FIELDS))
    order = torch.argsort(bag.reshape(-1), stable=True)
    flat_bag = bag.reshape(-1)[order]
    take = flat_bag < b * POOLED_FIELDS
    idx = keys.reshape(-1)[order][take]
    counts = torch.bincount(flat_bag[take], minlength=b * POOLED_FIELDS)
    offsets = torch.cumsum(counts, 0) - counts
    weights = torch.ones(idx.numel(), device=keys.device)
    return idx, tables["emb"]["param"], offsets, weights


def time_pool_kernels(label: str, view: dict, tables: dict, dense: dict, model, h: int,
                      flush, phase=38, index: bool = False) -> list:
    """K7 and K8 timed on ``view`` (device ms behind ``_sleep``, an L2
    flush before each call), beside their plain versions, their bounds
    and K7's embedding_bag yardstick (its result checked against K7's
    pooled tower first); with ``index`` K8 in index mode too (K4's plain
    plan, the hot plane into head buffers)."""
    import torch
    import torch.nn.functional as F

    from xflow_tpu_torch.ops.pool import (
        field_pool,
        field_pool_grad,
        field_pool_grad_plain,
        field_pool_plain,
    )

    args, kw = pool_args(view, tables, h)
    pooled, wide = field_pool(*args, **kw)
    dp, r, logit = head_grads(model, dense, pooled, wide, view)
    bag = embedding_bag_args(view, tables, h)
    lib = F.embedding_bag(bag[0], bag[1], bag[2], mode="sum", per_sample_weights=bag[3])
    lib_err = float((lib.reshape(pooled.shape) - pooled).abs().max())
    if lib_err > 1e-4 * max(float(pooled.abs().max()), 1.0):
        raise AssertionError(f"embedding_bag's yardstick computes another tower: {lib_err}")
    b = view["ckeys"].shape[0]
    common = {"path": label, "B": b, "Kc": view["ckeys"].shape[1],
              "Kh": view["hot"].shape[1] if "hot" in view else 0,
              "H": h if "hot" in view else 0, "F": POOLED_FIELDS,
              "E": tables["emb"]["param"].shape[1], "with_w": "w" in tables}
    k8_args, k8_kw, _ = k8_call(view, tables, h, dp, r, logit, False, False)
    rows = [{
        "kernel": "field_pool", **common,
        "ms": time_device_ms(lambda: field_pool(*args, **kw), [()] * TIMED_RUNS,
                             prelude=flush.zero_),
        "plain_ms": time_device_ms(lambda: field_pool_plain(*args, **kw), [()] * 10,
                                   prelude=flush.zero_, chunk_size=2),
        "library_ms": time_device_ms(
            lambda: F.embedding_bag(bag[0], bag[1], bag[2], mode="sum",
                                    per_sample_weights=bag[3]),
            [()] * TIMED_RUNS, prelude=flush.zero_),
        "library_call": "F.embedding_bag(mode='sum', per_sample_weights=x) over (row, "
        "field) bags; the grouping sort untimed; no wide term",
        **pool_bounds(view, tables, h, grad=False)}, {
        "kernel": "field_pool_grad", **common,
        "ms": time_device_ms(lambda: field_pool_grad(*k8_args, **k8_kw), [()] * TIMED_RUNS,
                             prelude=flush.zero_),
        "plain_ms": time_device_ms(lambda: field_pool_grad_plain(*k8_args, **k8_kw),
                                   [()] * 10, prelude=flush.zero_, chunk_size=2),
        "library_ms": None, "library_why_null": K8_LIBRARY_WHY_NULL,
        **pool_bounds(view, tables, h, grad=True)}]
    if index:
        i_args, i_kw, _ = k8_call(view, tables, h, dp, r, logit, True, False)
        rows.append({
            "kernel": "field_pool_grad (index)", **common,
            "ms": time_device_ms(lambda: field_pool_grad(*i_args, **i_kw), [()] * TIMED_RUNS,
                                 prelude=flush.zero_),
            "plain_ms": time_device_ms(lambda: field_pool_grad_plain(*i_args, **i_kw),
                                       [()] * 10, prelude=flush.zero_, chunk_size=2),
            "library_ms": None, "library_why_null": K8_LIBRARY_WHY_NULL,
            **pool_bounds(view, tables, h, grad=True)})
        del i_args, i_kw
    for row in rows:
        log(json.dumps(dict(row, phase=phase)))
    del k8_args, k8_kw
    torch.cuda.empty_cache()
    return rows


def pool_synthetic_planes(dev, b: int, k: int, kh: int, h: int, t: int, full: bool,
                          seed: int) -> dict:
    """Seed-made planes on the card as the wires ship them: sentinel keys
    (20 % padding, two all-padding rows), u8 fields with the clamp's 255
    (compact) or int32 fields with negative ids and ids past F (full,
    with values), a hot plane with keys past H (u16, or int32 on the
    full wire), u8 labels and weights."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randint(0, t, (b, k), generator=g, device=dev, dtype=torch.int32)
    keys = torch.where(torch.rand(b, k, generator=g, device=dev) < 0.2,
                       torch.full_like(keys, -1), keys)
    keys[:2] = -1
    if full:
        fields = torch.randint(-3, POOLED_FIELDS + 3, (b, k), generator=g, device=dev,
                               dtype=torch.int32)
    else:
        fields = torch.randint(0, POOLED_FIELDS + 2, (b, k), generator=g, device=dev,
                               dtype=torch.int32).to(torch.uint8)
        fields = torch.where(torch.rand(b, k, generator=g, device=dev) < 0.1,
                             torch.full_like(fields, 255), fields)
    view = {"ckeys": keys, "fields": fields,
            "labels_u8": (torch.rand(b, generator=g, device=dev) < 0.4).to(torch.uint8),
            "weights_u8": torch.ones(b, dtype=torch.uint8, device=dev), "num_real": float(b)}
    if kh:
        hk = torch.randint(0, h + 64, (b, kh), generator=g, device=dev, dtype=torch.int32)
        hk = torch.where(torch.rand(b, kh, generator=g, device=dev) < 0.3,
                         torch.full_like(hk, -1), hk)
        view["hot"] = hk if full else torch.where(hk >= 0, hk, 0xFFFF).to(torch.int16)
        view["hot_fields"] = torch.randint(0, POOLED_FIELDS, (b, kh), generator=g,
                                           device=dev, dtype=torch.int32).to(fields.dtype)
    return view


# Phase 34's cases: (family, B, cold slots, hot slots, full wire, edit).
# The edits put K7's per-field slot lists at their edges: every slot of
# every row in one field (44 slots: more than one warp's 32), a field
# of 34 slots beside the others, fields outside [0, F) both negative
# and 255 on the int32 plane, B = 1 (a live row), and B = 513, not a
# multiple of the examples a block pools
POOL_SYNTHETIC_CASES = (
    ("wide_deep", 65536, 12, 32, False, None),
    ("wide_deep", 512, 12, 32, True, None),
    ("dcn", 65536, K, 0, True, None),
    ("two_tower", 512, K, 0, False, None),
    ("two_tower", 65536, 12, 32, True, None),
    ("wide_deep", 512, 12, 32, False, "every slot in one field"),
    ("dcn", 512, K, 0, True, "a field of 34 slots"),
    ("dcn", 512, K, 0, True, "fields -5 and 255"),
    ("wide_deep", 1, 12, 32, False, "B = 1"),
    ("two_tower", 513, K, 0, False, None),
)


def pool_edge(view: dict, edit: str | None) -> dict:
    """``view`` with POOL_SYNTHETIC_CASES' ``edit`` applied."""
    if edit == "every slot in one field":
        for name in ("fields", "hot_fields"):
            if name in view:
                view[name].fill_(7)
    elif edit == "a field of 34 slots":
        view["fields"][:, :34] = 3
    elif edit == "fields -5 and 255":
        view["fields"][:, 0::3] = -5
        view["fields"][:, 1::3] = 255
    elif edit == "B = 1":  # row 2: rows 0 and 1 are all padding
        view = {n: (a[2:3] if hasattr(a, "shape") else a) for n, a in view.items()}
        view["num_real"] = 1.0
    return view


def phase_pool_synthetic(dev, worst: dict) -> list:
    """Phase 34: K7 and K8 against their plain versions on seed-made
    planes at T = 2^20: with w (wide_deep, dcn) and without (two_tower),
    compact (u8 fields) and full wire (int32 fields, negative ids), the
    hot plane (u16 and int32 keys, keys past H) and the bf16 flag on
    both tables, dense and index mode, B in {512, 65,536}, and
    POOL_SYNTHETIC_CASES' edges of K7's per-field lists."""
    import torch

    from xflow_tpu_torch.config import Config
    from xflow_tpu_torch.models import make_model
    from xflow_tpu_torch.ops.pool import field_pool, field_pool_plain

    t = 1 << 20
    cases = []
    for family, b, k, kh, full, edit in POOL_SYNTHETIC_CASES:
        cfg = Config(model=family, table_size_log2=20, max_fields=POOLED_FIELDS,
                     **{k_: v for k_, v in POOLED[family].items()
                        if k_ not in ("max_nnz", "hot_size_log2", "hot_nnz")})
        model = make_model(cfg)
        g = torch.Generator().manual_seed(len(cases))
        tables = {spec.name: {"param": (torch.randn(t, spec.dim, generator=g) * 0.3).to(dev)}
                  for spec in model.tables()}
        dense = {n: p.to(dev) for n, p in model.dense_init(g).items()}
        h = 1 << 14
        view = pool_edge(pool_synthetic_planes(dev, max(b, 3), k, kh, h, t, full,
                                               seed=len(cases)), edit)
        case = (f"{family} B={b} {'full' if full else 'compact'}{' hot' if kh else ''}"
                + (f" ({edit})" if edit else ""))
        forms = ("dense", "index") + (("hybrid",) if kh else ())
        check_pool_kernels(case, model, view, tables, dense, h, worst, forms)
        if kh:  # the bf16 flag rounds the hot rows of every table (K7) ...
            args, kw = pool_args(view, tables, h)
            got = field_pool(*args, **kw, hot_bf16=True)[0]
            want = field_pool_plain(*args, **kw, hot_bf16=True)[0]
            unflagged = field_pool_plain(*args, **kw)[0]
            bound = pool_magnitudes(view, tables, h)[0]
            if float(((got - want).abs() - bound).max()) > 0:
                raise AssertionError(f"K7 with the bf16 flag disagrees: {case}")
            if float((unflagged - want).abs().max()) == 0.0:
                raise AssertionError(f"the bf16 flag changed nothing: {case}")
        cases.append(case)
    log(json.dumps({"phase": 34, "cases": cases, **worst}))
    return cases


def pooled_reference_logit(family: str, cfg, dense: dict, tables: dict, keys, fields):
    """The float64 numpy reference of one example: the field-sum pool of
    its live slots with a field in [0, F), the wide term over every live
    slot, and the family's head."""
    d = {k: v.astype(np.float64) for k, v in dense.items()}
    f, e = cfg.max_fields, cfg.emb_dim
    emb = tables["emb"][keys].astype(np.float64)
    ok = (fields >= 0) & (fields < f)
    pooled = np.zeros((f, e))
    np.add.at(pooled, fields[ok], emb[ok])
    x0 = pooled.reshape(1, -1)
    wide = float(tables["w"][keys, 0].astype(np.float64).sum()) if "w" in tables else 0.0

    def relu(a):
        return np.maximum(a, 0.0)

    if family == "wide_deep":
        return wide + float((relu(x0 @ d["w1"] + d["b1"]) @ d["w2"] + d["b2"])[0, 0])
    if family == "dcn":
        x = x0
        for layer in range(d["cross_w"].shape[0]):
            x = x0 * (x * d["cross_w"][layer]).sum(-1, keepdims=True) + d["cross_b"][layer] + x
        hh = relu(x0 @ d["w1"] + d["b1"])
        return wide + float((np.concatenate([x, hh], -1) @ d["w_out"] + d["b_out"])[0, 0])
    split, td = cfg.tower_split_field, cfg.tower_dim
    user, item = pooled[:split].reshape(1, -1), pooled[split:].reshape(1, -1)
    m_u = relu(user @ d["u_w1"] + d["u_b1"]) @ d["u_w2"] + d["u_b2"]
    m_i = relu(item @ d["i_w1"] + d["i_b1"]) @ d["i_w2"] + d["i_b2"]
    u = np.concatenate([m_u, [[1.0]]], -1)
    i = np.concatenate([m_i[:, :td], [[1.0]], m_i[:, td:]], -1)
    return float((u * i).sum())


def serve_pooled(dev, trainer, family: str, workdir: str, test_lines: list,
                 requests: int = 1024, concurrency: int = 16) -> dict:
    """Phases 35-37's serving: the trained card model exported, then
    ``PredictEngine.load`` on the card, ``score_text`` of the test
    shard's first 2,048 lines against the plain version on the same
    planes (1e-6) and a float64 numpy reference (1e-5, first 64 lines),
    and the ``MicroBatcher`` bench (``compile_count`` = len(buckets));
    K7's launches counted from 0 just before and read just after."""
    import os

    import torch

    from xflow_tpu_torch.io.batch import pack_batch, remap_batch
    from xflow_tpu_torch.io.libffm import parse_block
    from xflow_tpu_torch.ops.pool import field_pool, field_pool_plain
    from xflow_tpu_torch.parallel.step import compact_wire_np, to_device_planes
    from xflow_tpu_torch.serve.__main__ import run_bench
    from xflow_tpu_torch.serve.artifact import export_artifact
    from xflow_tpu_torch.serve.engine import PredictEngine
    from xflow_tpu_torch.utils.metrics import sigmoid_ref

    art = export_artifact(trainer, os.path.join(workdir, f"{family}_artifact"))
    lines = test_lines[:2048]
    field_pool.launches = 0  # the serving path starts here
    engine = PredictEngine.load(art, device=dev)
    pctr = engine.score_text(lines)
    calls = len(engine.buckets) + math.ceil(len(lines) / engine.buckets[-1])
    if field_pool.launches != calls:
        raise AssertionError(f"{family}: {calls} device calls, K7 launched "
                             f"{field_pool.launches} times")
    if not np.all((pctr > 0) & (pctr <= 1)):
        raise AssertionError(f"{family}: pctr outside (0, 1]")
    cfg = engine.cfg
    block = parse_block("\n".join(lines).encode() + b"\n", cfg.table_size, cfg.hash_mode,
                        cfg.seed)
    batch = remap_batch(pack_batch(block, 0, len(lines), len(lines), cfg.max_nnz),
                        engine.remap, cfg.hot_size, cfg.hot_nnz)
    planes = to_device_planes(compact_wire_np(batch, hot_u16=True, ship_slots=True), dev)
    tables = engine.state["tables"]
    with torch.no_grad():
        pooled, wide = field_pool_plain(
            planes["ckeys"], None, planes["fields"], tables["emb"]["param"], cfg.max_fields,
            tables["w"]["param"] if "w" in tables else None, hot=planes.get("hot"),
            hot_fields=planes.get("hot_fields"), hot_size=cfg.hot_size)
        want = sigmoid_ref(engine.model.head(engine.state["dense"], pooled, wide))
    err = float(np.abs(pctr - want.cpu().numpy()).max())
    if err > PCTR_ATOL:
        raise AssertionError(f"{family}: engine vs plain on the card: max err {err}")
    host = {n: t["param"].cpu().numpy() for n, t in tables.items()}
    dense = {k: t.cpu().numpy() for k, t in engine.state["dense"].items()}
    ref_err = 0.0
    for i in range(64):
        live, hlive = batch.mask[i] > 0, batch.hot_mask[i] > 0
        keys = np.concatenate([batch.hot_keys[i][hlive], batch.keys[i][live]])
        fields = np.concatenate([batch.hot_slots[i][hlive], batch.slots[i][live]])
        logit = pooled_reference_logit(family, cfg, dense, host, keys, fields)
        p = 1e-6 if logit < -30 else 1.0 if logit > 30 else 1 / (1 + math.exp(-logit))
        ref_err = max(ref_err, abs(p - float(pctr[i])))
    if ref_err > 1e-5:
        raise AssertionError(f"{family}: engine vs float64 reference: max err {ref_err}")
    before = field_pool.launches
    summary = run_bench(engine, requests, concurrency, K, SEED)
    if engine.compile_count != len(engine.buckets):
        raise AssertionError(f"{family}: compile_count {engine.compile_count} != "
                             f"{len(engine.buckets)} buckets")
    if field_pool.launches - before != summary["batches"]:
        raise AssertionError(f"{family}: {summary['batches']} batches but "
                             f"{field_pool.launches - before} K7 launches")
    out = {"family": family, "launches": field_pool.launches,  # the path ends here
           "lines": len(lines), "max_abs_err_vs_plain": err,
           "max_abs_err_vs_float64": ref_err, "bench": summary,
           "compile_count": engine.compile_count, "artifact": art}
    del engine
    return out


def phase_topk(dev, art: str, test_prefix: str, requests: int = 1024) -> dict:
    """Phase 37's retrieval: the two_tower artifact's item index built on
    the card from the test shard's item-side features
    (``item_catalog_from_block``: fields >= tower_split_field, one item
    per distinct key set), then ``topk`` of the first 512 test lines'
    user-side features against a float64 numpy full scan of the same
    user embeddings over the same index (ids equal up to near-ties: an
    id only one side keeps must score within the tolerance of the last
    kept score); ``compile_count`` = len(buckets) per leg after warm,
    flat under mixed batch sizes and ``k``; requests/s and latency of
    single-row requests from one client, closed loop."""
    import torch

    from xflow_tpu_torch.io.loader import make_parse_fn
    from xflow_tpu_torch.ops.pool import field_pool
    from xflow_tpu_torch.serve.artifact import export_item_index, item_catalog_from_block
    from xflow_tpu_torch.serve.engine import PredictEngine

    engine = PredictEngine.load(art, device=dev, warm=False)
    cfg = engine.cfg
    with open(f"{test_prefix}-00000", "rb") as f:
        block = make_parse_fn(cfg.table_size, cfg.hash_mode, cfg.seed)(f.read())
    items = item_catalog_from_block(block, cfg.tower_split_field)
    t0 = time.perf_counter()
    field_pool.launches = 0  # the index build starts here
    meta = export_item_index(engine, art, items)
    build = {"items": meta["count"], "dim": meta["dim"],
             "seconds": time.perf_counter() - t0, "k7_launches": field_pool.launches}
    if field_pool.launches != math.ceil(len(items) / engine.buckets[-1]):
        raise AssertionError(f"index build: K7 launched {field_pool.launches} times")
    field_pool.launches = 0  # the top-k path starts here
    engine = PredictEngine.load(art, device=dev, topk_k=16)
    legs = engine.compile_count
    if legs != 2 * len(engine.buckets):
        raise AssertionError(f"top-k engine warmed {legs} shapes, want 2 x "
                             f"{len(engine.buckets)}")
    users = []
    for i in range(512):
        lo, hi = int(block.row_ptr[i]), int(block.row_ptr[i + 1])
        sel = block.slots[lo:hi] < cfg.tower_split_field
        users.append((block.keys[lo:hi][sel].astype(np.int64),
                      block.slots[lo:hi][sel].astype(np.int32), None))
    batch = engine.featurize(users)
    ids, scores, u = engine.topk_prepared(batch)
    index = engine.item_index["item_index"].astype(np.float64)
    full = u.astype(np.float64) @ index.T
    order = np.argsort(-full, axis=1, kind="stable")[:, :engine.topk_k]
    want_ids = engine.item_index["item_ids"][order]
    want_scores = np.take_along_axis(full, order, 1)
    tol = 1e-5 * np.abs(want_scores).max() + 1e-6
    worst = float(np.abs(scores - want_scores).max())
    if worst > tol:
        raise AssertionError(f"top-k scores vs the numpy scan: {worst} > {tol}")
    swaps = 0
    for gi, wi, ws in zip(ids, want_ids, want_scores):
        kept = set(wi.tolist())
        swaps += len(kept - set(gi.tolist()))
        for j in kept - set(gi.tolist()):  # the scan's alone: tied with its last
            if abs(float(ws[list(wi).index(j)]) - float(ws[-1])) > tol:
                raise AssertionError(f"top-k dropped item {j}, which scores above its last")
    # mixed traffic: batch sizes and k within topk_k, no new shape
    rng = np.random.default_rng(SEED)
    for n, k in ((1, 1), (7, 16), (64, 5), (300, 9), (512, 16), (33, 2)):
        got_ids, got_scores = engine.topk(engine.featurize_raw(users[:n]), k=k)
        if got_ids.shape != (n, k) or not np.all(np.diff(got_scores, axis=1) <= 0):
            raise AssertionError(f"top-k of {n} rows at k={k}: {got_ids.shape}")
    if engine.compile_count != legs:
        raise AssertionError(f"compile_count moved under mixed top-k traffic: "
                             f"{engine.compile_count} != {legs}")
    lat = []
    t0 = time.perf_counter()
    for i in range(requests):
        t1 = time.perf_counter()
        engine.topk(engine.featurize_raw([users[int(rng.integers(0, len(users)))]]), k=10)
        lat.append(time.perf_counter() - t1)
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    out = {"phase": 37, "index": build, "k": engine.topk_k, "users_checked": len(users),
           "max_abs_score_err_vs_numpy": worst, "near_tie_swaps": swaps,
           "compile_count": engine.compile_count, "legs": legs,
           "requests": requests, "requests_per_sec": requests / seconds,
           "e2e_p50": float(np.percentile(lat, 50)), "e2e_p99": float(np.percentile(lat, 99)),
           "k7_launches": field_pool.launches}  # the top-k path ends here
    log(json.dumps(out))
    return out


def phase_pooled(dev, workdir: str, dense: dict) -> dict:
    """Phases 34-38 at the flagship ``wide_deep`` (hot), ``dcn`` and
    ``two_tower`` (POOLED): 34 K7 and K8 against their plain versions on
    seed-made planes; 35-37 each family trained on the default input
    path (native text, the dictionary wire with the field streams) in
    its POOLED_MODES from one seeded state, each path's launches exact
    (K7 = forward calls, K8 = updates), its first dispatch held through
    ``lockstep_tables`` (tables and dense parameters, n' == 0 splits
    verified as rounding), the sync guard on the sequential paths, the
    eval AUC inside the planted bars where the table says; the family's
    trained model exported and served; two_tower's item index built and
    top-k served; 38 K7 and K8 against their plain versions on each
    path's own first batch or slice, and timed on the dense paths'
    batches and at B = 512."""
    import torch

    data, bars = dense["data"], dense["bars"]
    one = single_shard(data, workdir)
    with open(f"{data['test']}-00000") as f:
        test_lines = f.read().splitlines()
    out = {"rows": [], "timings": [], "launches_by_path": {}, "serve": {}}
    worst = {"k7_max_abs_err": 0.0, "k7_max_err_over_tol": 0.0, "k8_max_abs_err": 0.0,
             "k8_max_err_over_tol": 0.0, "cases": 0}
    out["synthetic"] = phase_pool_synthetic(dev, worst)
    torch.cuda.empty_cache()
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
    inits = {}
    for family, label, mode, single, bar in POOLED_MODES:
        geom = POOLED[family]
        if family not in inits:
            inits[family] = fresh_init(dev, pooled_config(family, data, ""))
        seq = mode.get("update_mode") == "sequential"
        full_mode = dict(geom, **mode, **({"epochs": 1} if single else {}))
        run = run_mode(dev, family, T_LOG2, one if single else data, inits[family],
                       full_mode, label, workdir, evaluate=not single, keep=True,
                       bars=bars if bar else None, lockstep=True,
                       sync_check=seq and not single, replay_dispatches=1,
                       guard_segment=POOLED_GUARD_SEGMENT)
        phase = {"wide_deep": 35, "dcn": 36, "two_tower": 37}[family]
        log(f"phase {phase}: {family} {label} done at {time.perf_counter() - T_START:.1f} s")
        row = dict(run["row"], phase=phase, family=family)
        trainer = run["trainer"]
        tables, dense_p = trainer.state["tables"], trainer.state["dense"]
        h = trainer.cfg.hot_size
        arrays = run["shipped"][0]
        if seq:
            rows = arrays["ckeys"].shape[0] // trainer.cfg.microbatch
            view = shipped_view(arrays, rows, arrays["slice_num_real"][0])
            forms = ("index", "hybrid") if "hot" in view else ("index",)
        else:
            view = shipped_view(arrays)
            forms = ("dense", "index")
        check_pool_kernels(f"{family} {label} {'slice 0' if seq else 'batch 0'}",
                           trainer.model, view, tables, dense_p, h, worst, forms)
        if label == "dense":
            out["timings"] += time_pool_kernels(f"{family} dense", view, tables, dense_p,
                                                trainer.model, h, flush)
            out["timings"] += time_pool_kernels(f"{family} dense, first 512 rows",
                                                shipped_view(arrays, SLICE_ROWS), tables,
                                                dense_p, trainer.model, h, flush)
        if label == POOLED_MODES_SERVED[family]:
            out["serve"][family] = serve_pooled(dev, trainer, family, workdir, test_lines)
            log(json.dumps({"phase": phase, "serve": {
                k: v for k, v in out["serve"][family].items() if k != "artifact"}}))
            if family == "two_tower":
                out["topk"] = phase_topk(dev, out["serve"][family]["artifact"], data["test"])
        out["rows"].append(row)
        out["launches_by_path"][f"{family} {label}"] = row["launches"]
        log(json.dumps(row))
        del run, trainer, tables, dense_p, view, arrays
        torch.cuda.empty_cache()
    out["checks"] = worst
    log(json.dumps({"phase": 38, **worst}))
    del flush
    torch.cuda.empty_cache()
    return out


# the path whose trained model each family serves (phases 35-37)
POOLED_MODES_SERVED = {"wide_deep": "dense", "dcn": "dense",
                       "two_tower": "sequential_sparse_mb128"}


def pooled_train_rows(pooled: dict, card: str) -> list:
    """The ``train`` line's rows for the pooled paths (phases 35-37):
    device busy from K7's and K8's launches times their device ms on the
    family's 65,536-row dense batch (the head, K3-K6 left out, and said
    so).  A sequential path's launches run 512-row slices, which take a
    fiftieth of that time (phase 38), so its busy share is overstated
    and its idle share a lower bound.  With the examples/s,
    ``put_batch`` ms and the eval AUC."""
    ms = {}
    for r in pooled["timings"]:
        if r["path"].endswith("dense"):
            ms[(r["kernel"], r["path"].split(" ")[0])] = r["ms"]
    rows = []
    for row in pooled["rows"]:
        if "eval" not in row:
            continue
        n, family = row["launches"], row["family"]
        busy_ms = sum(n[k] * ms.get((k, family), 0.0) for k in ("field_pool",
                                                                "field_pool_grad"))
        busy = busy_ms / 1e3
        rows.append({
            "model": family, "mode": row["mode"], "card": card,
            "examples_per_sec": row["examples_per_sec"],
            "step_time_p50": row["step_time_p50"], "phases": row["phases"],
            "put_batch_ms_per_dispatch": [p["h2d"] / (row["steps"] / len(row["phases"])) * 1e3
                                          for p in row["phases"]],
            "train_seconds": row["train_seconds"],
            "device_busy_s_from_kernel_times": busy,
            "device_busy_counts": "K7 and K8 at their dense-batch times; the head, K3-K6 "
            "left out",
            "device_idle_share_from_kernel_times": 1.0 - busy / row["train_seconds"],
            "eval_auc": row["eval"]["auc"], "eval_logloss": row["eval"]["logloss"],
        })
    return rows


def pooled_kernel_entries(pooled: dict) -> list:
    """The ``kernels`` line's entries for K7 and K8 (phases 34-38):
    launches counted on the pooled paths (each from 0 just before it)
    and the serving and top-k paths, times on wide_deep's dense batch
    with every other shape beside them."""
    by_path = pooled["launches_by_path"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    serve = sum(s["launches"] for s in pooled["serve"].values())
    entries = []
    for name, replaces, err, ratio in (
            ("field_pool", B11_REPLACES, "k7_max_abs_err", "k7_max_err_over_tol"),
            ("field_pool_grad", B11_GRAD_REPLACES, "k8_max_abs_err", "k8_max_err_over_tol")):
        head = next(r for r in pooled["timings"]
                    if r["kernel"] == name and r["path"] == "wide_deep dense")
        launches = sum(n[name] for n in by_path.values())
        entry = {"name": name, "route": "cuda", "source": "xflow_tpu_torch/csrc/pool.cu",
                 "replaces": replaces,
                 "launches": launches + (serve + pooled["topk"]["k7_launches"]
                                         + pooled["topk"]["index"]["k7_launches"]
                                         if name == "field_pool" else 0),
                 "launches_by_path": {p: n[name] for p, n in by_path.items()},
                 "launches_by_shape": launches_by_shape(pooled["rows"], name),
                 "max_abs_err": pooled["checks"][err],
                 "max_err_over_tol": pooled["checks"][ratio],
                 **{k: head[k] for k in keys},
                 "shape": {k: head[k] for k in ("path", "B", "Kc", "Kh", "H", "F", "E")},
                 "per_shape": [r for r in pooled["timings"] if r["kernel"] == name]}
        if name == "field_pool":
            entry["library_call"] = head["library_call"]
            entry["launches_serving"] = serve
            entry["launches_topk_and_index"] = (pooled["topk"]["k7_launches"]
                                                + pooled["topk"]["index"]["k7_launches"])
            entry["launches_by_shape"].update({
                "serving, MicroBatcher buckets of up to 512 rows": serve,
                "top-k requests and the index build, up to 512 rows":
                    entry["launches_topk_and_index"]})
        else:
            entry["library_why_null"] = K8_LIBRARY_WHY_NULL
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# K2's FFM form and K7 alone on path-like batches (``--kernel-times``)

def path_like_ranks(b: int, seed: int) -> np.ndarray:
    """[b, 39] per-field id ranks as the repo's traffic draws them
    (io/synth.py: zipf(1.2) over 100,000 ids a field)."""
    from xflow_tpu_torch.io.synth import FIELDS, _zipf_draw

    return _zipf_draw(np.random.default_rng(seed), (b, FIELDS), 1.2)


def path_like_key(ranks: np.ndarray, t: int) -> np.ndarray:
    """Each (field, id) hashed over a table of ``t`` rows."""
    glob = np.arange(ranks.shape[1], dtype=np.int64)[None, :] * 100_000 + ranks
    return ((glob * 2654435761) % t).astype(np.int32)


def path_like_ffm(dev, b: int, hot: bool, seed: int) -> dict:
    """An ``ffm`` (40 slots: a field each, the last padding) or
    ``ffm_hot`` batch of the repo's traffic, compact wire, u8 fields.
    The hot plane takes a row's ids of rank below H / 39 in their field
    (about 80 % of them, the share the remap captures), at most 32, the
    rest go cold, at most 12."""
    import torch

    ranks = path_like_ranks(b, seed)
    t = 1 << FFM_T_LOG2
    view = {"max_fields": FFM_FIELDS, "form": "ffm", "num_real": float(b),
            "labels_u8": torch.tensor(np.random.default_rng(seed + 1).random(b) < 0.3,
                                      dtype=torch.uint8, device=dev),
            "weights_u8": torch.ones(b, dtype=torch.uint8, device=dev)}
    if not hot:
        keys = np.full((b, K), -1, np.int32)
        keys[:, :ranks.shape[1]] = path_like_key(ranks, t)
        fields = np.zeros((b, K), np.uint8)
        fields[:, :ranks.shape[1]] = np.arange(ranks.shape[1])
        view.update(ckeys=torch.tensor(keys, device=dev),
                    fields=torch.tensor(fields, device=dev))
        return view
    return dict(view, **steered_planes(dev, ranks, t, 1 << FFM_HOT["hot_size_log2"],
                                       FFM_HOT["max_nnz"], FFM_HOT["hot_nnz"]))


def steered_planes(dev, ranks: np.ndarray, t: int, h: int, kc: int, kh: int,
                   remap_order: bool = False) -> dict:
    """The cold and hot planes of ``ranks``: ids of rank below h / 39 in
    their field take head row field * (h / 39) + rank, or with
    ``remap_order`` rank * 39 + field, the remap's order by frequency
    (every field's hottest id in rows [0, 39): io/freq.py); u16, 0xFFFF
    padding; at most ``kh``, the first in field order; the others their
    hashed key (at most ``kc``)."""
    import torch

    b, nf = ranks.shape
    per = h // nf
    is_hot = ranks < per
    keys = path_like_key(ranks, t)
    hot = np.full((b, kh), 0xFFFF, np.uint16)
    hot_f = np.zeros((b, kh), np.uint8)
    cold = np.full((b, kc), -1, np.int32)
    cold_f = np.zeros((b, kc), np.uint8)
    for i in range(b):
        fh = np.flatnonzero(is_hot[i])[:kh]
        fc = np.flatnonzero(~is_hot[i])[:kc]
        hot[i, :fh.size] = ranks[i, fh] * nf + fh if remap_order else fh * per + ranks[i, fh]
        hot_f[i, :fh.size] = fh
        cold[i, :fc.size] = keys[i, fc]
        cold_f[i, :fc.size] = fc
    return {"ckeys": torch.tensor(cold, device=dev), "fields": torch.tensor(cold_f, device=dev),
            "hot": torch.tensor(hot.view(np.int16), device=dev),
            "hot_fields": torch.tensor(hot_f, device=dev)}


def k4_k5_times(dev, flush) -> list:
    """K4 and K5 (FTRL on w and v) on path-like planes of the repo's
    traffic: fm_nohot's 65,536-row sparse batch (39 fields and a padding
    slot over T = 2^24), its first 512-row slice, and a hybrid fm
    512-row slice (12 cold slots beside 32 hot ones, H = 2^14) with the
    fold into both head buffers.  K5 steps w and v in one call: one
    launch in a tree whose K5 takes every table, two (one a table,
    timed together) in a parent whose K5 takes one.  K4 starts each
    call from a cleared slot map, K5 behind an L2 flush."""
    import torch

    from xflow_tpu_torch.ops import sparse as sp
    from xflow_tpu_torch.optim import FTRL

    multi = hasattr(sp, "K5_MAX_TABLES")
    t = 1 << T_LOG2
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    ranks = path_like_ranks(TRAIN_BATCHES[-1], SEED + 5)
    keys = np.full((ranks.shape[0], K), -1, np.int32)
    keys[:, :ranks.shape[1]] = path_like_key(ranks, t)
    keys = torch.tensor(keys, device=dev)
    hot = steered_planes(dev, path_like_ranks(SLICE_ROWS, SEED + 6), t, 1 << 14,
                         HOT_GEOMETRY["fm"]["max_nnz"], HOT_GEOMETRY["fm"]["hot_nnz"])
    tables = [{"param": torch.randn((t, d), generator=g, device=dev) * 0.1,
               "n": torch.rand((t, d), generator=g, device=dev) * 0.1,
               "z": torch.randn((t, d), generator=g, device=dev) * 0.1} for d in (1, D)]
    opt = FTRL()
    slot_map = torch.full((t,), -1, dtype=torch.int32, device=dev)
    rows = []
    for label, kk, h in (("fm_nohot path-like sparse batch", keys, 0),
                         ("fm_nohot path-like first 512-row slice",
                          keys[:SLICE_ROWS].contiguous(), 0),
                         ("fm path-like hybrid 512-row slice, fold", hot["ckeys"], 1 << 14)):
        m = kk.numel()
        plan = new_plan(kk, dev)
        k4_ms = time_device_ms(sp.consolidate_keys, [(kk, t, *plan, slot_map)] * TIMED_RUNS,
                               prelude=lambda: slot_map.fill_(-1))
        slot_map.fill_(-1)
        sp.consolidate_keys(kk, t, *plan, slot_map)
        torch.cuda.synchronize()
        n = int(plan[1])
        slot_map.fill_(-1)
        rows.append({"kernel": "consolidate_keys", "path": label, "M": m, "U": n,
                     "ms": k4_ms, **k4_bounds(m, n)})
        gsums = [torch.randn((m, d), generator=g, device=dev) * 0.01 for d in (1, D)]
        heads = [torch.zeros((h, d), device=dev) for d in (1, D)] if h else None

        def k5(gsums=gsums, heads=heads, h=h, plan=plan):
            if multi:
                sp.touched_update(tables, opt, plan[0], plan[1], gsums, None, head=heads,
                                  hot_size=h)
                return
            for i, table in enumerate(tables):
                sp.touched_update(table, opt, plan[0], plan[1], gsums[i], None,
                                  head=heads[i] if heads else None, hot_size=h)

        rows.append({"kernel": "touched_update", "path": label, "tables": "w+v", "U": n,
                     "H": h, "launches_per_call": 1 if multi else 2,
                     "ms": time_device_ms(k5, [()] * TIMED_RUNS, prelude=flush.zero_),
                     **k5_bounds_tables(plan[0], n, [1, D], "ftrl", h)})
        for i, name in enumerate(("w", "v")):  # each table alone: one launch in both
            rows.append({"kernel": f"touched_update ({name} alone)", "path": label, "U": n,
                         "H": h, "ms": time_device_ms(
                             lambda i=i, gsums=gsums, heads=heads, h=h, plan=plan:
                             sp.touched_update(tables[i], opt, plan[0], plan[1], gsums[i],
                                               None, head=heads[i] if heads else None,
                                               hot_size=h), [()] * TIMED_RUNS,
                             prelude=flush.zero_),
                         **k5_bounds(plan[0], n, (1, D)[i], "ftrl", h)})
        del gsums, heads, plan
    for row in rows:
        log(json.dumps(dict(row, phase="kernel-times")))
    del tables, slot_map, keys
    torch.cuda.empty_cache()
    return rows


def flagship_field_times(dev, flush) -> list:
    """The field forms' flagship shapes, which C5's device-memory stage
    must leave as they were: K1's MVM form at 512 rows and K2's at a
    65,536-row dense batch of the flagship ``mvm`` (12 + 32 slots, H =
    2^14, 39 fields, D = 10, T = 2^24), and K1's FFM form at 512 rows of
    the flagship ``ffm`` (40 slots, F = 39, D = 4, T = 2^21); K2's FFM
    form and K7/K8 are timed beside them (kernel_times)."""
    import torch

    from xflow_tpu_torch.ops.score import score
    from xflow_tpu_torch.ops.train import train_step

    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    rows = []
    t = 1 << T_LOG2
    h = 1 << HOT_GEOMETRY["mvm"]["hot_size_log2"]
    v = torch.randn((t, D), generator=g, device=dev) * 0.1
    gv = torch.zeros_like(v)
    planes = steered_planes(dev, path_like_ranks(TRAIN_BATCHES[-1], SEED + 7), t, h,
                            HOT_GEOMETRY["mvm"]["max_nnz"], HOT_GEOMETRY["mvm"]["hot_nnz"])
    fk = {"hot_size": h, "max_fields": MVM_FIELDS, "form": "mvm"}
    b = TRAIN_BATCHES[-1]
    labels = torch.tensor(np.random.default_rng(SEED).random(b) < 0.3, dtype=torch.uint8,
                          device=dev)
    weights = torch.ones(b, dtype=torch.uint8, device=dev)
    acc = torch.zeros(2, dtype=torch.float64, device=dev)
    small = {k: a[:SLICE_ROWS].contiguous() for k, a in planes.items()}
    rows.append({"kernel": "score (mvm, flagship)", "B": SLICE_ROWS,
                 "ms": time_device_ms(lambda: score(
                     small["ckeys"], None, None, v, hot=small["hot"], fields=small["fields"],
                     hot_fields=small["hot_fields"], **fk), [()] * TIMED_RUNS,
                     prelude=flush.zero_)})
    rows.append({"kernel": "train_step (mvm: dense, flagship)", "B": b,
                 "ms": time_device_ms(lambda: train_step(
                     planes["ckeys"], None, labels, weights, float(b), None, v, None, gv, acc,
                     hot=planes["hot"], hg_v=gv[:h], fields=planes["fields"],
                     hot_fields=planes["hot_fields"], **fk), [()] * TIMED_RUNS,
                     prelude=flush.zero_)})
    del v, gv, planes, small
    torch.cuda.empty_cache()
    t = 1 << FFM_T_LOG2
    w = torch.randn((t, 1), generator=g, device=dev) * 0.3
    v = torch.randn((t, FFM_FIELDS * FFM_DIM), generator=g, device=dev) * 0.1
    view = path_like_ffm(dev, SLICE_ROWS, False, SEED + 8)
    rows.append({"kernel": "score (ffm, flagship)", "B": SLICE_ROWS,
                 "ms": time_device_ms(lambda: score(
                     view["ckeys"], None, w, v, fields=view["fields"], max_fields=FFM_FIELDS,
                     form="ffm"), [()] * TIMED_RUNS, prelude=flush.zero_)})
    for row in rows:
        log(json.dumps(dict(row, phase="kernel-times")))
    del w, v, view
    torch.cuda.empty_cache()
    return rows


def path_like_batch(b: int, seed: int, hot: bool):
    """A numpy Batch of the repo's traffic (39 fields, a padding slot
    for fm_nohot's K = 40), its field ids in the slots: ``hot`` steers
    ids of rank below H / 39 in their field to head rows (the fm / mvm
    geometry: 12 cold + 32 hot slots, H = 2^14) with ``make_batch``,
    in the remap's order (by frequency: rank * 39 + field, so every
    field's hottest id sits in rows [0, 39), as io/freq.py's remap puts
    them), the rest hashed over rows [H, T)."""
    from xflow_tpu_torch.io.batch import make_batch

    ranks = path_like_ranks(b, seed)
    nf = ranks.shape[1]
    t = 1 << T_LOG2
    geom = HOT_GEOMETRY["mvm"]
    h = 1 << geom["hot_size_log2"] if hot else 0
    ktot = geom["max_nnz"] + geom["hot_nnz"] if hot else K
    keys = np.zeros((b, ktot), np.int32)
    slots = np.zeros((b, ktot), np.int32)
    mask = np.zeros((b, ktot), np.float32)
    cold = path_like_key(ranks, t)
    if hot:
        per = h // nf
        cold = (h + cold % (t - h)).astype(np.int32)
        cold = np.where(ranks < per, ranks * nf + np.arange(nf)[None, :], cold)
    keys[:, :nf] = cold
    slots[:, :nf] = np.arange(nf)[None, :]
    mask[:, :nf] = 1.0
    rng = np.random.default_rng(seed + 1)
    labels = (rng.random(b) < 0.3).astype(np.float32)
    weights = np.ones(b, np.float32)
    return make_batch(keys, slots, mask.copy(), mask, labels, weights, h,
                      geom["hot_nnz"] if hot else 0), h


def kernel_ops_by_name(fn, calls: int = 5) -> dict:
    """torch.profiler over ``calls`` calls of ``fn`` after a warm-up:
    each device operation's name with its calls and device microseconds
    a call, and the device operations a call in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        row = names.setdefault(e.name, {"per_call": 0.0, "us_per_call": 0.0})
        row["per_call"] += 1 / calls
        row["us_per_call"] += e.time_range.elapsed_us() / calls
    return {"ops_per_call": sum(r["per_call"] for r in names.values()),
            "by_name": names}


K6_FORMS = (("cold tiers", False, False), ("hot tiers", True, False),
            ("field streams", True, True))


def k6_times(dev) -> list:
    """K6 on path-like dictionary-wire planes of the repo's traffic: the
    cold tiers (fm_nohot, 40 slots), the hot tiers (fm, 12 + 32 slots,
    H = 2^14) and the field streams (mvm, the same geometry with
    ``cw_cs`` / ``cw_hs``), each at a training batch of 65,536 rows and
    the 16,384-row eval batch: exactly against the plain version, timed
    beside it, with the byte bound and torch.profiler's split of the
    call by kernel name."""
    import torch

    from xflow_tpu_torch.io.compact import compact_batch
    from xflow_tpu_torch.ops.wire import dict_decode, dict_decode_plain, to_device

    rows = []
    geom = HOT_GEOMETRY["mvm"]
    for form, hot, fields in K6_FORMS:
        for b in (TRAIN_BATCHES[-1], TEST_LINES):
            batch, h = path_like_batch(b, SEED + 20, hot)
            cb = compact_batch(batch, 1 << T_LOG2, h)
            wire = cb.wire(ship_slots=fields)
            planes = to_device(wire, dev)
            k, kh = (geom["max_nnz"], geom["hot_nnz"]) if hot else (K, 0)
            got = dict_decode(planes, k, kh)
            want = dict_decode_plain(planes, k, kh)
            torch.cuda.synchronize()
            if len(got) != len(want) or not all(
                    g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"K6 {form} B={b}: differs from the plain version")
            in_bytes = sum(int(a.nbytes) for n, a in wire.items() if n != "cw_cun")
            out_bytes = sum(int(o.numel() * o.element_size()) for o in got)
            args = [(planes, k, kh)] * TIMED_RUNS
            ops = kernel_ops_by_name(lambda: dict_decode(planes, k, kh))
            rows.append({"kernel": "dict_decode", "form": form, "B": b, "K": k, "Kh": kh,
                         "ms": time_device_ms(dict_decode, args),
                         "plain_ms": time_device_ms(dict_decode_plain, args, chunk_size=5),
                         "bound_ms": (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
                         "bound_by": "bytes", "bytes": in_bytes + out_bytes,
                         "device_ops_per_call": ops["ops_per_call"],
                         "by_kernel_name": ops["by_name"], "exact": True})
            log(json.dumps(dict(rows[-1], phase="kernel-times")))
            del planes, got, want
    torch.cuda.empty_cache()
    return rows


def mvm_times(dev, flush) -> list:
    """K2's MVM form on path-like planes of the repo's traffic (the
    flagship ``mvm``: 12 + 32 slots, H = 2^14, 39 fields, D = 10,
    T = 2^24): the 65,536-row dense batch, its cold plane alone in index
    mode, a 512-row hybrid slice (index mode, head buffer) and a
    512-row hot-inner slice (window-start mode), and ``mvm_nohot``'s
    65,536-row batch (40 cold slots); each beside its plain version,
    with mvm_bounds."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    t = 1 << T_LOG2
    h = 1 << HOT_GEOMETRY["mvm"]["hot_size_log2"]
    tables = {"v": {"param": torch.randn((t, D), generator=g, device=dev) * 0.1}}
    rows = []
    for label, b, hot, form in (("mvm path-like dense batch", TRAIN_BATCHES[-1], True, "dense"),
                                ("mvm path-like batch, cold plane, index mode",
                                 TRAIN_BATCHES[-1], True, "index"),
                                ("mvm path-like hybrid 512-row slice", SLICE_ROWS, True,
                                 "hybrid"),
                                ("mvm path-like hot-inner 512-row slice", SLICE_ROWS, True,
                                 "window"),
                                ("mvm_nohot path-like dense batch", TRAIN_BATCHES[-1], False,
                                 "dense")):
        batch, _ = path_like_batch(b, SEED + 22, hot)
        view = {"ckeys": torch.tensor(np.where(batch.mask > 0, batch.keys, -1).astype(np.int32),
                                      device=dev),
                "fields": torch.tensor(np.where(batch.mask > 0, batch.slots, 0).astype(np.uint8),
                                       device=dev),
                "labels_u8": torch.tensor(batch.labels, dtype=torch.uint8, device=dev),
                "weights_u8": torch.tensor(batch.weights, dtype=torch.uint8, device=dev),
                "num_real": float(b), "max_fields": MVM_FIELDS, "form": "mvm"}
        if hot:
            view["hot"] = torch.tensor(np.where(batch.hot_mask > 0, batch.hot_keys, 0xFFFF)
                                       .astype(np.uint16).view(np.int16), device=dev)
            view["hot_fields"] = torch.tensor(np.where(batch.hot_mask > 0, batch.hot_slots, 0)
                                              .astype(np.uint8), device=dev)
        if form == "index":  # phase 24's index row: no head destination
            view = {k: a for k, a in view.items() if k not in ("hot", "hot_fields")}
            rows.append(time_mvm_k2(label, "hybrid", view, tables, h, flush,
                                    phase="kernel-times", name="train_step (mvm: index)"))
            continue
        rows.append(time_mvm_k2(label, form, view, tables, h if hot else 0, flush,
                                phase="kernel-times"))
    del tables
    torch.cuda.empty_cache()
    return rows


K1_FORMS = ("lr", "fm", "hot", "fm64", "mvm", "ffm")


def k1_view(dev, form: str, b: int, seed: int) -> dict:
    """K1's planes of the repo's traffic (path_like_ranks) for ``form``:
    fm_nohot's 40 slots (39 fields and a padding slot) hashed over
    T = 2^24 (``lr``, ``fm``) or 2^22 (``fm64``, the served v_dim = 64
    FM); fm's 12 cold + 32 hot slots at H = 2^14 with the hot rows in
    the remap's order (``hot``; ``mvm`` with its u8 field planes); the
    flagship ``ffm``'s 40 slots over T = 2^21."""
    import torch

    if form == "ffm":
        return path_like_ffm(dev, b, False, seed)
    hot = form in ("hot", "mvm")
    batch, h = path_like_batch(b, seed, hot)
    keys = np.where(batch.mask > 0, batch.keys, -1).astype(np.int32)
    if form == "fm64":
        keys = np.where(keys >= 0, keys % (1 << FM64_T_LOG2), -1).astype(np.int32)
    view = {"ckeys": torch.tensor(keys, device=dev)}
    if hot:
        view["hot"] = torch.tensor(np.where(batch.hot_mask > 0, batch.hot_keys, 0xFFFF)
                                   .astype(np.uint16).view(np.int16), device=dev)
        view["hot_size"] = h
    if form == "mvm":
        view["fields"] = torch.tensor(np.where(batch.mask > 0, batch.slots, 0)
                                      .astype(np.uint8), device=dev)
        view["hot_fields"] = torch.tensor(np.where(batch.hot_mask > 0, batch.hot_slots, 0)
                                          .astype(np.uint8), device=dev)
    return view


def k1_tables(dev, form: str, g):
    """(w, v) for k1_view's planes of ``form``, seed-made on the card:
    T = 2^24 and D = 10 (``lr`` without v, ``mvm`` without w), 2^22 and
    64 (``fm64``), the flagship ``ffm``'s 2^21 and 39 x 4."""
    import torch

    t = 1 << (FM64_T_LOG2 if form == "fm64" else FFM_T_LOG2 if form == "ffm" else T_LOG2)
    d = 64 if form == "fm64" else FFM_FIELDS * FFM_DIM if form == "ffm" else D
    w = torch.randn((t, 1), generator=g, device=dev) * 0.3 if form != "mvm" else None
    v = (torch.randn((t, d), generator=g, device=dev) * (0.05 if form == "fm64" else 0.1)
         if form != "lr" else None)
    return w, v


def k1_kw(form: str, view: dict) -> dict:
    """score's keywords for k1_view's planes of ``form``."""
    kw = {"hot": view.get("hot"), "hot_size": view.get("hot_size", 0),
          "form": "fm" if form in ("hot", "fm64") else form}
    if form in ("mvm", "ffm"):
        kw.update(fields=view["fields"], hot_fields=view.get("hot_fields"),
                  max_fields=MVM_FIELDS if form == "mvm" else FFM_FIELDS)
    return kw


def check_k1(case: str, form: str, view: dict, w, v, kw: dict) -> float:
    """K1 against score_plain on ``view`` (k1_view's planes, ``kw`` the
    score keywords): the logit within phase 2's tolerance plus phase
    6's bound for the LR/FM forms, mvm_tolerances' and ffm_tolerances'
    for the field forms; pctr within PCTR_ATOL plus that through the
    sigmoid's slope.  Returns pctr's largest difference."""
    import torch

    from xflow_tpu_torch.ops.score import hot_plane_keys, score, score_plain

    args = (view["ckeys"], None, w, v)
    got_p, got_l = score(*args, return_logit=True, **kw)
    want_p, want_l = score_plain(*args, return_logit=True, **kw)
    keys = view["ckeys"].long()
    h = kw.get("hot_size", 0)
    if view.get("hot") is not None:
        keys = torch.cat([hot_plane_keys(view["hot"], h), keys], dim=1)
    if form == "mvm":
        ltol = 1.01 * mvm_tolerances(keys, view_fields(view), None, None, None, 1.0, v,
                                     kw["max_fields"], logit_only=True)["logit"] + 1e-7
    elif form == "ffm":
        ltol = 1.01 * ffm_tolerances(keys, view_fields(view), None, None, None, 1.0, w, v,
                                     kw["max_fields"], logit_only=True)["logit"] + 1e-7
    else:
        ltol = LOGIT_ATOL + LOGIT_RTOL * want_l.abs()
        if v is not None:
            ltol = ltol + fm_logit_bound(keys, None, w, v)
    ptol = PCTR_ATOL + want_p * (1 - want_p) * ltol
    if (float(((got_l - want_l).abs() - ltol).max()) > 0
            or float(((got_p - want_p).abs() - ptol).max()) > 0
            or not bool(torch.isfinite(got_p).all())):
        raise AssertionError(f"K1 {case} disagrees with score_plain")
    return float((got_p - want_p).abs().max())


def k1_times(dev, flush) -> list:
    """K1's forms on path-like planes (k1_view) at a serving bucket of
    512 rows and the 16,384-row eval batch: LR, FM (D = 10), the hot
    plane, FM at D = 64 (T = 2^22), MVM and FFM; each held against
    score_plain first (the logit within phase 2's tolerance plus phase
    6's bound for the LR/FM forms, mvm_tolerances' and ffm_tolerances'
    for the field forms; pctr within PCTR_ATOL plus that through the
    sigmoid's slope), then timed behind an L2 flush beside its plain
    version and its bound."""
    import torch

    from xflow_tpu_torch.ops.score import score, score_plain

    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    rows = []
    for form in K1_FORMS:
        ww, vv = k1_tables(dev, form, g)
        for b in (SLICE_ROWS, TEST_LINES):
            view = k1_view(dev, form, b, SEED + 24)
            h = view.get("hot_size", 0)
            kw = k1_kw(form, view)
            args = (view["ckeys"], None, ww, vv)
            err = check_k1(f"{form} B={b}", form, view, ww, vv, kw)
            d = vv.shape[1] if vv is not None else 0
            if form == "mvm":
                bound = mvm_bounds(view, D, h, train=False)
            elif form == "ffm":
                bound = ffm_bounds(view, FFM_FIELDS, FFM_DIM, 0, train=False)
            else:
                bound = bounds(view["ckeys"], None, d, view.get("hot"), h)
            rows.append({
                "kernel": f"score ({form})", "B": b, "K": view["ckeys"].shape[1],
                "Kh": view["hot"].shape[1] if h else 0, "D": d,
                "max_abs_err": err,
                "ms": time_device_ms(lambda: score(*args, **kw), [()] * TIMED_RUNS,
                                     prelude=flush.zero_),
                "plain_ms": time_device_ms(lambda: score_plain(*args, **kw), [()] * 10,
                                           prelude=flush.zero_, chunk_size=2),
                **bound})
            log(json.dumps(dict(rows[-1], phase="kernel-times")))
            del view
        del ww, vv
        torch.cuda.empty_cache()
    return rows


KERNEL_TIME_GROUPS = ("k1", "k8", "ffm", "k6", "mvm", "k4k5", "flagship", "c5")


def kernel_times(dev, groups=KERNEL_TIME_GROUPS) -> list:
    """The kernels timed alone on path-like batches of the repo's
    traffic, by group: ``k1`` K1's forms at 512 and 16,384 rows
    (k1_times); ``k8`` K7 and K8 on ``wide_deep`` (12 + 32 slots, H =
    2^14, the hot rows in the remap's order), ``dcn`` and ``two_tower``
    (40 slots) at 65,536 rows and their first 512, K8 in dense and index
    mode; ``ffm`` K2's FFM form (the flagship ``ffm`` dense batch of
    65,536 rows, a 512-row index-mode slice, an ``ffm_hot`` 512-row
    hybrid slice); ``k6`` (k6_times); ``mvm`` K2's MVM form (mvm_times);
    ``k4k5`` (k4_k5_times); ``flagship`` the field forms' flagship
    shapes (flagship_field_times); ``c5`` C5's device-memory stages
    (phase_c5).  Run from two checkouts in one call to compare them on
    one card."""
    import torch

    from xflow_tpu_torch.config import Config
    from xflow_tpu_torch.models import make_model

    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
    rows = []
    if "k1" in groups:
        rows += k1_times(dev, flush)
    if "k6" in groups:
        rows += k6_times(dev)
    if "mvm" in groups:
        rows += mvm_times(dev, flush)
    if "k4k5" in groups:
        rows += k4_k5_times(dev, flush)
    if "flagship" in groups:
        rows += flagship_field_times(dev, flush)
    if "c5" in groups:
        rows += phase_c5(dev)["timings"]
    if "ffm" in groups:
        t = 1 << FFM_T_LOG2
        tables = {"w": {"param": torch.randn((t, 1), generator=g, device=dev) * 0.3},
                  "v": {"param": torch.randn((t, FFM_FIELDS * FFM_DIM), generator=g,
                                             device=dev) * 0.1}}
        h = 1 << FFM_HOT["hot_size_log2"]
        full = path_like_ffm(dev, TRAIN_BATCHES[-1], False, SEED)
        rows.append(time_ffm_k2("path-like dense batch", "dense", full, tables, 0, flush,
                                "train_step (ffm: dense)", phase="kernel-times"))
        rows.append(time_ffm_k2("path-like 512-row slice", "hybrid",
                                ffm_view(full, SLICE_ROWS, float(SLICE_ROWS)), tables, 0,
                                flush, "train_step (ffm: index, slice)",
                                phase="kernel-times"))
        hot = path_like_ffm(dev, SLICE_ROWS, True, SEED + 2)
        rows.append(time_ffm_k2("path-like ffm_hot 512-row slice", "hybrid", hot, tables, h,
                                flush, "train_step (ffm: hybrid)", phase="kernel-times"))
        del tables, full, hot
        torch.cuda.empty_cache()
    if "k8" not in groups:
        return rows
    t = 1 << T_LOG2
    for family in ("wide_deep", "dcn", "two_tower"):
        geom = POOLED[family]
        cfg = Config(model=family, table_size_log2=T_LOG2, max_fields=POOLED_FIELDS,
                     **{k: v for k, v in geom.items()
                        if k not in ("max_nnz", "hot_size_log2", "hot_nnz")})
        model = make_model(cfg)
        cg = torch.Generator().manual_seed(SEED + 11)
        tables = {spec.name: {"param": torch.randn((t, spec.dim), generator=g, device=dev)
                              * 0.3} for spec in model.tables()}
        dense = {n: p.to(dev) for n, p in model.dense_init(cg).items()}
        ranks = path_like_ranks(TRAIN_BATCHES[-1], SEED + 3)
        hh = 1 << geom["hot_size_log2"] if "hot_size_log2" in geom else 0
        if hh:
            view = steered_planes(dev, ranks, t, hh, geom["max_nnz"], geom["hot_nnz"],
                                  remap_order=True)
        else:
            keys = np.full((ranks.shape[0], K), -1, np.int32)
            keys[:, :ranks.shape[1]] = path_like_key(ranks, t)
            fields = np.zeros(keys.shape, np.uint8)
            fields[:, :ranks.shape[1]] = np.arange(ranks.shape[1])
            view = {"ckeys": torch.tensor(keys, device=dev),
                    "fields": torch.tensor(fields, device=dev)}
        view.update(labels_u8=torch.tensor(np.random.default_rng(SEED).random(
            ranks.shape[0]) < 0.3, dtype=torch.uint8, device=dev),
            weights_u8=torch.ones(ranks.shape[0], dtype=torch.uint8, device=dev),
            num_real=float(ranks.shape[0]))
        worst = {"k7_max_abs_err": 0.0, "k7_max_err_over_tol": 0.0, "k8_max_abs_err": 0.0,
                 "k8_max_err_over_tol": 0.0, "cases": 0}
        for label, v in ((f"{family} path-like batch", view),
                         (f"{family} path-like first 512 rows",
                          shipped_view(view, SLICE_ROWS, float(SLICE_ROWS)))):
            check_pool_kernels(label, model, v, tables, dense, hh, worst)
            rows += time_pool_kernels(label, v, tables, dense, model, hh, flush,
                                      phase="kernel-times", index=True)
        log(json.dumps({"phase": "kernel-times", "family": family, "checked": worst}))
        del tables, view
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# C5: the field forms past their shared-memory caps (phase 39)

C5_ROWS = 64
C5_T_LOG2 = 16
C5_GEOMETRY = {  # (form, slots, max_fields, factors): one past each cap
    "mvm": ("mvm", 1600, MVM_FIELDS, D),
    "ffm": ("ffm", 40, 256, 4),
    "pooled": ("pooled", 4200, POOLED_FIELDS, 8),
}
C5_RTOL = 1e-5  # with an atol of C5_RTOL of the largest magnitude compared:
# the kernels sum in another order than the plain versions (atomics in any)


def c5_close(case: str, got, want, worst: dict) -> None:
    import torch

    scale = float(want.abs().max()) if want.numel() else 0.0
    diff = (got.double() - want.double()).abs()
    tol = C5_RTOL * want.double().abs() + C5_RTOL * scale
    if not bool(torch.isfinite(got).all()) or float((diff - tol).max()) > 0:
        raise AssertionError(f"C5 {case}: kernel and plain version differ by "
                             f"{float(diff.max())} (scale {scale})")
    worst["max_abs_err"] = max(worst["max_abs_err"], float(diff.max()))
    worst["cases"] += 1


def phase_c5(dev) -> dict:
    """Phase 39: each field form's device-memory stage past its shared-
    memory cap (C5) against its plain version at B = 64 on seed-made
    planes (T = 2^16, 20 % padding, u8 fields with some at the clamp's
    255): MVM at 1,600 slots, FFM at max_fields 256 with 40 slots, a
    pooled row (w and emb, E = 8) of 4,200 slots; K1 and K2 (K7, and K8
    on its chunked stage), dense and index mode, each timed beside its
    plain version."""
    import torch

    from xflow_tpu_torch.ops.pool import (
        POOL_MAX_SLOTS,
        field_pool,
        field_pool_grad,
        field_pool_grad_plain,
        field_pool_plain,
    )
    from xflow_tpu_torch.ops.score import field_stage_global, score, score_plain
    from xflow_tpu_torch.ops.sparse import consolidate_keys_plain
    from xflow_tpu_torch.ops.train import train_plain, train_step

    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    t = 1 << C5_T_LOG2
    b = C5_ROWS
    worst = {"max_abs_err": 0.0, "cases": 0}
    rows = []
    for name, (form, k, f, d) in C5_GEOMETRY.items():
        if form == "pooled":
            assert k > POOL_MAX_SLOTS
        else:
            assert field_stage_global(form, f, k)
        keys = torch.randint(0, t, (b, k), generator=g, device=dev, dtype=torch.int32)
        keys = torch.where(torch.rand((b, k), generator=g, device=dev) < 0.2, -1, keys)
        fields = torch.randint(0, f, (b, k), generator=g, device=dev).to(torch.uint8)
        fields = torch.where(torch.rand((b, k), generator=g, device=dev) < 0.03, 255, fields)
        labels = (torch.rand(b, generator=g, device=dev) < 0.3).to(torch.uint8)
        weights = torch.ones(b, dtype=torch.uint8, device=dev)
        view = {"ckeys": keys, "fields": fields, "labels_u8": labels}
        slots = torch.empty_like(keys)
        consolidate_keys_plain(keys, t, torch.empty(keys.numel(), dtype=torch.int32,
                                                    device=dev),
                               torch.zeros(1, dtype=torch.int32, device=dev), slots)
        common = {"phase": 39, "geometry": name, "B": b, "slots": k, "max_fields": f, "D": d}
        if form != "pooled":
            width = f * d if form == "ffm" else d
            scale = 0.1 if form == "ffm" else 0.01  # MVM: 39 factors of 1 + a field's sum
            v = torch.randn((t, width), generator=g, device=dev) * scale
            w = torch.randn((t, 1), generator=g, device=dev) * 0.1 if form == "ffm" else None
            fk = {"fields": fields, "max_fields": f, "form": form}
            got = score(keys, None, w, v, return_logit=True, **fk)
            want = score_plain(keys, None, w, v, True, **fk)
            c5_close(f"{name} K1 logit", got[1], want[1], worst)
            k1 = lambda: score(keys, None, w, v, **fk)  # noqa: E731
            k1p = lambda: score_plain(keys, None, w, v, **fk)  # noqa: E731
            bound = (mvm_bounds(view, d, 0, False) if form == "mvm"
                     else ffm_bounds(view, f, d, 0, False))
            rows.append(dict(common, kernel=f"score ({form}, device-memory stage)",
                             ms=time_device_ms(k1, [()] * 20),
                             plain_ms=time_device_ms(k1p, [()] * 4, chunk_size=1), **bound))
            for index in (False, True):
                m = keys.numel() if index else t
                outs = []
                for fn in (train_step, train_plain):
                    g_w = torch.zeros((m, 1), device=dev) if w is not None else None
                    g_v = torch.zeros((m, width), device=dev)
                    acc = torch.zeros(2, dtype=torch.float64, device=dev)
                    fn(keys, None, labels, weights, float(b), w, v, g_w, g_v, acc,
                       slots=slots if index else None, **fk)
                    outs.append((g_w, g_v, acc))
                mode = "index" if index else "dense"
                for i, what in enumerate(("g_w", "g_v", "acc")):
                    if outs[0][i] is not None:
                        c5_close(f"{name} K2 {mode} {what}", outs[0][i], outs[1][i], worst)

                def k2(fn=train_step, index=index, outs=outs):
                    fn(keys, None, labels, weights, float(b), w, v, outs[0][0], outs[0][1],
                       outs[0][2], slots=slots if index else None, **fk)

                bound = (mvm_bounds(view, d, 0, True, index) if form == "mvm"
                         else ffm_bounds(view, f, d, 0, True, index))
                rows.append(dict(common, kernel=f"train_step ({form}, device-memory stage, "
                                 f"{mode})", ms=time_device_ms(k2, [()] * 20),
                                 plain_ms=time_device_ms(lambda: k2(train_plain), [()] * 4,
                                                         chunk_size=1), **bound))
                del outs
            del v, w
        else:
            emb = torch.randn((t, d), generator=g, device=dev) * 0.3
            w = torch.randn((t, 1), generator=g, device=dev) * 0.3
            tables = {"emb": {"param": emb}, "w": {"param": w}}
            pooled, wide = field_pool(keys, None, fields, emb, f, w=w)
            want_p, want_w = field_pool_plain(keys, None, fields, emb, f, w=w)
            c5_close(f"{name} K7 pooled", pooled, want_p, worst)
            c5_close(f"{name} K7 wide", wide, want_w, worst)
            rows.append(dict(common, kernel="field_pool (device-memory stage)",
                             ms=time_device_ms(lambda: field_pool(keys, None, fields, emb, f,
                                                                  w=w), [()] * 20),
                             plain_ms=time_device_ms(lambda: field_pool_plain(
                                 keys, None, fields, emb, f, w=w), [()] * 4, chunk_size=1),
                             **pool_bounds(view, tables, 0, grad=False)))
            dp = torch.randn((b, f, d), generator=g, device=dev) * 1e-3
            r = torch.randn(b, generator=g, device=dev) * 1e-3
            logit = torch.randn(b, generator=g, device=dev) * 4
            for index in (False, True):
                m = keys.numel() if index else t
                outs = []
                for fn in (field_pool_grad, field_pool_grad_plain):
                    g_emb, g_w = torch.zeros((m, d), device=dev), torch.zeros((m, 1), device=dev)
                    acc = torch.zeros(2, dtype=torch.float64, device=dev)
                    fn(keys, None, fields, dp, r, logit, labels, weights, f, g_emb, acc,
                       g_w=g_w, slots=slots if index else None)
                    outs.append((g_emb, g_w, acc))
                mode = "index" if index else "dense"
                for i, what in enumerate(("g_emb", "g_w", "acc")):
                    c5_close(f"{name} K8 {mode} {what}", outs[0][i], outs[1][i], worst)

                def k8(fn=field_pool_grad, index=index, outs=outs):
                    fn(keys, None, fields, dp, r, logit, labels, weights, f, outs[0][0],
                       outs[0][2], g_w=outs[0][1], slots=slots if index else None)

                rows.append(dict(common, kernel=f"field_pool_grad (device-memory stage, "
                                 f"{mode})", ms=time_device_ms(k8, [()] * 20),
                                 plain_ms=time_device_ms(lambda: k8(field_pool_grad_plain),
                                                         [()] * 4, chunk_size=1),
                                 **pool_bounds(view, tables, 0, grad=True)))
                del outs
            del emb, w, tables
        for row in rows[-3:]:
            log(json.dumps(row))
        torch.cuda.empty_cache()
    return {"timings": rows, "worst": worst}


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


def split_tolerance(view: dict, num_real: float, uk, before: dict, hot_size: int = 0,
                    max_fields: int = 0, form: str = "", other: dict | None = None) -> dict:
    """Phase 6's per-row bound on K2's summed gradients (k2_tolerances;
    for MVM, mvm_tolerances; for FFM, ffm_tolerances), for the slice
    ``view`` (hot plane and cold plane) over the tables as they were
    before it, gathered at the sorted unique keys ``uk``, which hold
    every live key of the view: {table: [U, width] tolerances}.  For
    FFM, ``other`` (the card's rows before the slice) adds how far the
    two sides' inputs lie apart, and the bound is computed on the card
    where there is one (float64 over a 65,536-row batch)."""
    import torch

    local = local_keys(view, uk, hot_size)
    if form == "ffm":
        dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
        rows = {n: before[n]["param"].to(dev) for n in ("w", "v")}
        apart = ({n: (rows[n] - other[n]["param"].to(dev)).abs() for n in ("w", "v")}
                 if other is not None else {})
        tol = ffm_tolerances(local.to(dev), view_fields(view).to(dev),
                             view["x"].to(dev) if "x" in view else None,
                             view["labels_u8"].to(dev), view["weights_u8"].to(dev), num_real,
                             rows["w"], rows["v"], max_fields, dw=apart.get("w"),
                             dv=apart.get("v"))
        return {n: tol[n].cpu() for n in ("w", "v")}
    if "fields" in view:
        return {"v": mvm_tolerances(local, view_fields(view), None, view["labels_u8"],
                                    view["weights_u8"], num_real, before["v"]["param"],
                                    max_fields)["v"]}
    v = before["v"]["param"] if "v" in before else None
    tol_w, tol_v, _ = k2_tolerances(local, None, view["labels_u8"], view["weights_u8"],
                                    num_real, before["w"]["param"], v)
    return {"w": tol_w, "v": tol_v}


def pool_tolerances(model, view: dict, num_real: float, uk, before: dict, other: dict,
                    dense: dict, other_dense: dict, max_fields: int, hot_size: int) -> dict:
    """The pooled families' per-row bound on how far the two sides' K8
    sums may lie apart over the slice ``view`` where no ReLU unit kinks
    (the n' == 0 split's test, as split_tolerance's for K2;
    relu_kinks' jumps add to it): both sides' dloss/dpooled and
    residuals recomputed on the host from their own rows ``before`` /
    ``other`` (at the sorted unique keys ``uk``) and dense parameters,
    then per occurrence |x| times their gap plus twice each side's
    float32 rounding (the side's own run and this recomputation each
    round within it), and per row the float32 summation bound of its n
    occurrences (n 2^-23 times the sum of |x dP|).  A side's dP rounds
    by at most gamma (|r| + dr) times the head's derivative taken on
    absolute values (tower magnitudes sum |x emb|, |dense|, sum |x w|),
    which bounds the magnitudes of all its terms, and r by dr = gamma /
    4 times that head's logit, weighted, over num_real, plus 2^-23 |r|.
    gamma = 2^-23 (P + H + k + 32): the longest chain of float32 sums
    from an emb row to dP (k slots, the P tower inputs, the H units,
    and at most 32 cross layers or tower lanes at these geometries).
    Returns {table: [U, width]}."""
    import torch

    from xflow_tpu_torch.ops.pool import field_pool_plain

    local = local_keys(view, uk, hot_size)
    fields = view_fields(view)
    x = None
    if "x" in view:
        x = torch.cat([view["hot_x"], view["x"]], 1) if "hot_x" in view else view["x"]
    labels = view["labels_u8"].float() if "labels_u8" in view else view["labels"]
    weights = view["weights_u8"].float() if "weights_u8" in view else view["weights"]
    grads = []
    for rows, dn in ((before, dense), (other, other_dense)):
        w = rows["w"]["param"] if "w" in rows else None
        emb = rows["emb"]["param"]
        pooled, wide = field_pool_plain(local, x, fields, emb, max_fields, w)
        mag, wide_mag = field_pool_plain(local, None if x is None else x.abs(), fields,
                                         emb.abs(), max_fields,
                                         None if w is None else w.abs())
        params = {k: t.detach().cpu().clone().requires_grad_(True) for k, t in dn.items()}
        hidden = next(t.shape[1] for k, t in params.items() if k.endswith("w1"))
        gamma = EPS32 * (pooled[0].numel() + hidden + local.shape[1] + 32)
        leaf, mag_leaf = pooled.requires_grad_(True), mag.requires_grad_(True)
        with torch.enable_grad():
            logit = model.head(params, leaf, wide)
            mag_logit = model.head({k: t.detach().abs() for k, t in params.items()},
                                   mag_leaf, wide_mag)
        r = ((torch.sigmoid(logit) - labels) * weights / num_real).detach()
        dp = torch.autograd.grad(logit, leaf, grad_outputs=r)[0]
        dp_mag = torch.autograd.grad(mag_logit, mag_leaf,
                                     grad_outputs=torch.ones_like(mag_logit))[0]
        dr = gamma / 4 * mag_logit.detach() * weights / num_real + EPS32 * r.abs()
        grads.append((dp, r, (gamma * r.abs() + dr)[:, None, None] * dp_mag, dr))
    (dpa, ra, ea, dra), (dpb, rb, eb, drb) = grads
    local = local.long()
    live = local >= 0
    xm = torch.where(live, torch.ones_like(local, dtype=torch.float32) if x is None else x.abs(),
                     torch.zeros(local.shape))
    ok = live & (fields >= 0) & (fields < max_fields)
    f = fields.clamp(0, max_fields - 1)
    b = torch.arange(local.shape[0])[:, None]
    gap_e = ((dpa - dpb).abs() + 2 * (ea + eb))[b, f]  # [B, n, E]
    mag_e = dpa.abs()[b, f]
    gap_w = (ra - rb).abs() + 2 * (dra + drb)
    idx = local.clamp(min=0).reshape(-1)
    u = uk.numel()
    count = torch.zeros(u).index_add_(0, idx, live.reshape(-1).float())
    out = {}
    terms = {"emb": (torch.where(ok[..., None], xm[..., None] * gap_e, 0.0),
                     torch.where(ok[..., None], xm[..., None] * mag_e, 0.0)),
             "w": ((xm * gap_w[:, None])[..., None], (xm * ra.abs()[:, None])[..., None])}
    for name in before:
        gap, mag = terms[name]
        d = gap.shape[-1]
        tol = torch.zeros(u, d).index_add_(0, idx, gap.reshape(-1, d))
        tol += count[:, None] * 2.0 ** -23 * torch.zeros(u, d).index_add_(
            0, idx, mag.reshape(-1, d))
        out[name] = tol
    return out


def relu_layers(model, dense: dict, pooled) -> list:
    """The pooled family's ReLU layers on ``pooled`` [B, F, E], each as
    (its dense-parameter prefix, its input h [B, P], w1 [P, H], b1 [H],
    dlogit/d(its output) [B, H]): wide_deep's and dcn's deep layer
    (whose output weights, w2 or w_out's last H rows, are the same for
    every example) and two_tower's two towers (logit = u . i + b_u +
    b_i, so a tower's output takes the other's lanes [i, 1] or [u, 1]
    through its w2)."""
    import torch

    from xflow_tpu_torch.models.blocks import mlp_tower

    b = pooled.shape[0]
    if model.name == "two_tower":
        s, td = model.split_field, model.tower_dim
        hu, hi = pooled[:, :s].reshape(b, -1), pooled[:, s:].reshape(b, -1)
        mu, mi = mlp_tower(dense, hu, "u_"), mlp_tower(dense, hi, "i_")
        ones = torch.ones_like(mu[:, :1])
        return [("u_", hu, dense["u_w1"], dense["u_b1"],
                 torch.cat([mi[:, :td], ones], 1) @ dense["u_w2"].T),
                ("i_", hi, dense["i_w1"], dense["i_b1"],
                 torch.cat([mu[:, :td], ones], 1) @ dense["i_w2"].T)]
    h = pooled.reshape(b, -1)
    out = dense["w2"][:, 0] if model.name == "wide_deep" else dense["w_out"][h.shape[1]:, 0]
    return [("", h, dense["w1"], dense["b1"], out.expand(b, -1))]


def relu_kinks(model, views: dict, tables: dict, dense: dict, snaps: dict,
               max_fields: int, hot_size: int, num_real: float) -> dict:
    """ReLU's kink, where a unit's derivative jumps: the units of a
    slice the two sides may put on different sides of it.  Each side's
    pre-activations a = h w1 + b1 are recomputed from its own ``views``,
    ``tables``, ``dense`` parameters and (a hot window's) head ``snaps``
    ({"cpu": ..., "card": ...}) before the update, as K7 and the head
    read them.  They lie apart by at most

        bound = D + R_cpu + R_card,
        D = |h_cpu - h_card| |w1_cpu| + |h_card| |w1_cpu - w1_card|
            + |b1_cpu - b1_card|        (the two sides' inputs apart),
        R = 2^-23 (P + 1 + k) (|h| |w1| + |b1|)
                                        (float32 rounding of either
                                        side's sum, and of the card's
                                        pooled input, over P + 1 terms
                                        and a row's k slots),

    so a unit is kinked where both sides' a lie within ``bound`` of 0.
    A unit whose sides' signs differ and which is not kinked raises.

    A kinked unit u of example b moves the example's dloss/dpooled by
    at most |r_b| |dlogit/dout_bu| |w1[:, u]| (r the residual): each
    occurrence's emb gradient by |x| times that at its field, and the
    gradients of w1[:, u] and b1[u] by that times |h_b| and 1.  The
    wide term's gradient x r does not jump.  Returns {"units": {prefix:
    [B, H] bool}, "examples": [B] bool, "occurrences": [B, Kh + K, E]
    the emb jump of each occurrence (view_keys' order), "dense": {name:
    its gradient's jump}}, jumps the larger of the two sides', raised by
    2^-23 (P + 1 + k) of themselves for their own float32 rounding."""
    import torch

    from xflow_tpu_torch.ops.pool import field_pool_plain

    sides = {}
    for side in ("cpu", "card"):
        view, tbl, snap = views[side], tables[side], snaps.get(side) or {}
        labels = view["labels_u8"] if "labels_u8" in view else view["labels"]
        weights = view["weights_u8"] if "weights_u8" in view else view["weights"]
        with torch.no_grad():
            w = tbl["w"]["param"] if "w" in tbl else None
            pooled, wide = field_pool_plain(
                view["ckeys"], view.get("x"), view["fields"], tbl["emb"]["param"],
                max_fields, w, hot=view.get("hot"), hot_x=view.get("hot_x"),
                hot_fields=view.get("hot_fields"), hot_size=hot_size if "hot" in view else 0,
                snap_w=snap.get("w") if w is not None else None, snap_emb=snap.get("emb"))
            dn = {k: t.detach() for k, t in dense[side].items()}
            logit = model.head(dn, pooled, wide)
            r = ((torch.sigmoid(logit) - labels.float()) * weights.float() / num_real).abs()
            sides[side] = (r.cpu(), [(pre, h.cpu(), w1.cpu(), b1.cpu(), (h @ w1 + b1).cpu(),
                                      (h.abs() @ w1.abs() + b1.abs()).cpu(), dout.abs().cpu())
                                     for pre, h, w1, b1, dout in relu_layers(model, dn, pooled)])
    view = views["cpu"]
    slots = view["ckeys"].shape[1] + (view["hot"].shape[1] if "hot" in view else 0)
    b = view["ckeys"].shape[0]
    units, kinked, dense_jump, jumps = {}, torch.zeros(b, dtype=torch.bool), {}, []
    (rc, lc), (rk, lk) = sides["cpu"], sides["card"]
    for (pre, hc, w1c, b1c, ac, magc, dc), (_, hk, w1k, b1k, ak, magk, dk) in zip(lc, lk):
        n = hc.shape[1] + 1 + slots
        apart = ((hc - hk).abs() @ w1c.abs() + hk.abs() @ (w1c - w1k).abs()
                 + (b1c - b1k).abs())
        # float32 sums of nonnegative terms: 2^-23 n of their own size
        bound = (apart + EPS32 * n * (magc + magk)) * (1 + EPS32 * n)
        unit = (ac.abs() <= bound) & (ak.abs() <= bound)
        flips = (torch.sign(ac) != torch.sign(ak)) & ~unit
        if bool(flips.any()):
            i, u = (int(v) for v in flips.nonzero()[0])
            raise AssertionError(
                f"ReLU unit {pre}{u} of example {i}: pre-activation {float(ac[i, u])} on the "
                f"CPU, {float(ak[i, u])} on the card, beyond their bound "
                f"{float(bound[i, u])} of each other")
        units[pre] = unit
        kinked |= unit.any(dim=1)
        margin = 1 + EPS32 * n
        parts, dj = [], {}
        for r, h, w1, d in ((rc, hc, w1c, dc), (rk, hk, w1k, dk)):
            c = torch.where(unit, margin * r[:, None] * d, 0.0)  # [B, H]
            parts.append(c @ w1.abs().T)  # [B, P]
            for name, jump in ((pre + "w1", h.abs().T @ c), (pre + "b1", c.sum(dim=0))):
                dj[name] = jump if name not in dj else torch.maximum(dj[name], jump)
        jumps.append(torch.maximum(*parts))
        dense_jump.update(dj)
    per_field = torch.cat(jumps, dim=1).reshape(b, max_fields, -1)  # [B, F, E]
    keys, fields = view_keys(view, hot_size), view_fields(view)
    x = torch.ones(keys.shape)
    if "x" in view:
        x = torch.cat([view["hot_x"], view["x"]], 1) if "hot_x" in view else view["x"]
    ok = (keys >= 0) & (fields >= 0) & (fields < max_fields)
    occ = per_field[torch.arange(b)[:, None], fields.clamp(0, max_fields - 1)]
    occ = torch.where(ok[..., None], x.abs()[..., None] * occ, 0.0)
    return {"units": units, "examples": kinked, "occurrences": occ, "dense": dense_jump}


def kink_row_jumps(view: dict, uk, kinks: dict, hot_size: int) -> dict:
    """relu_kinks' occurrence jumps summed per row of the sorted unique
    keys ``uk``: {"emb": [U, E], "w": zeros [U, 1]}."""
    import torch

    local = local_keys(view, uk, hot_size).long()
    occ = kinks["occurrences"]
    e = occ.shape[-1]
    emb = torch.zeros(uk.numel(), e).index_add_(0, local.clamp(min=0).reshape(-1),
                                                occ.reshape(-1, e))
    return {"emb": emb, "w": torch.zeros(uk.numel(), 1)}


def recovered_grads(before: dict, after: dict, opt) -> tuple:
    """The summed gradient an FTRL step (``opt``; lockstep_tables
    replays FTRL tables) applied to each element of a table's rows, read
    back from the rows ``before`` and ``after`` it in float64: g = z' -
    z + (sqrt(n') - sqrt(n)) / alpha * w, n' as stored, as K3 and K5
    wrote it and used it.  Its error is K3's float32 rounding of z'
    (k3_tolerances).  Returns (g, err)."""
    import torch

    w = before["param"].double()
    n, n_new = before["n"].double(), after["n"].double()
    z, z_new = before["z"].double(), after["z"].double()
    g = z_new - z + (torch.sqrt(n_new) - torch.sqrt(n)) / opt.alpha * w
    return g, k3_tolerances({"param": w, "g": g, "n": n, "z": z}, n_new, opt)["z"]


# The largest share of a dispatch's examples that may hold a kinked
# ReLU unit: about twice the most the phases' paths showed on an H100
# (4.7 % on the 65,536-row dense dispatches, 1.2-2.6 % on the sequential
# ones; 0.07 % of the units).  A fault that moves pre-activations by
# more than rounding shows as a sign flip beyond relu_kinks' bound
# (raised), and one that moves many by a little, as more kinks than this.
KINK_SHARE_CAP = 0.10


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
                    records: int = 6, keep: dict | None = None,
                    kink_sync: bool = True) -> dict:
    """Replay the sequential batches ``shipped`` from ``init`` on the
    card (``card_step``, the main path's TrainStep) and on the CPU in
    lockstep, slice by slice (an unsliced dispatch as one update), each
    side through the per-slice update the
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
    the window's start; for the pooled families, ``pool_tolerances``
    plus the kinks' jumps below).
    MVM's gradient has a second discontinuity, its
    guard: a slot whose own-field factor lies within rounding of 1e-12
    takes a zero gradient on one side and prod / own on the other.  An
    element whose z jumps apart in a slice is such a guard split when
    its row holds a slot that straddles the guard (``guard_rows``); it
    is recorded and, with ``synchronize``, synchronised like an n' == 0
    split.  The pooled families' head has a third, ReLU's kink: a unit
    whose pre-activation lies within its bound of 0 on both sides
    (``relu_kinks``, which raises on a sign flip beyond that bound) may
    take dP's jump of its contribution on one side only.  After each
    update, every emb element of a row such a unit reaches is held
    (``hold_kinks``): the gradient each side applied, read back from its
    rows (``recovered_grads``), lies within ``pool_tolerances`` plus the
    read-back's error of the other side's, plus the element's jump
    (``kink_row_jumps``; at a hot window's close, summed over the
    window's slices); an element beyond raises.  With ``kink_sync`` the
    CPU then takes the card's state at the held elements, as at a
    verified n' == 0 split.  After such a slice the dense parameters are
    held to TRAIN_BOUNDS' terms plus sgd_lr times the jump of the kinked
    units' w1 columns and b1 entries, and the CPU takes the card's.  A
    dispatch whose kinked examples pass KINK_SHARE_CAP raises.  Without
    ``kink_sync`` (the diagnostic) nothing is synchronised for a kink,
    the dense parameters are not held, and the final comparison does
    not gate: the emb elements held, and those whose gap went beyond
    the bound without the jump (which took one), are returned
    (``kink_elements``: {"held", "beyond_rounding"} -> [T, E] bool).  With
    ``synchronize``
    the CPU then takes the card's state at that element, and the final
    tables are held to TRAIN_BOUNDS (``compare_states``); a split that
    fails the verification raises.  Without it the run goes on unsynced
    and nothing is held (the diagnostic).  Records the first ``records``
    splits, and elements whose z moved apart by more than half of
    TRAIN_BOUNDS' terms in one slice.  Each update's log-loss is held
    to TRAIN_BOUNDS' (with ``synchronize``) and its largest relative gap
    recorded; ``keep`` receives both sides' final states ("card",
    "cpu")."""
    import torch

    from xflow_tpu_torch.parallel.step import TrainStep

    dev = card_step.device
    h = cfg.hot_size
    s_fields = cfg.max_fields if card_step.predict_step.ship_slots else 0
    form = card_step.predict_step.form
    pooled = card_step.pooled
    opt = card_step.optimizer
    # MVM's guard is the second discontinuity (FFM has none)
    guard = s_fields if form == "mvm" else 0
    steps = {"card": card_step,
             "cpu": TrainStep(card_step.model, card_step.optimizer, cfg, torch.device("cpu"))}
    states = {"card": state_of(cfg, init, dev), "cpu": state_of(cfg, init, "cpu")}
    out = {"slices": 0, "windows": 0, "splits": 0, "split_records": [], "jump_slices": 0,
           "jump_records": [], "guard_splits": 0, "guard_records": [],
           "logloss_max_rel_gap": 0.0}
    if pooled:
        out.update(kink_slices=0, kink_examples=0, kink_units=0, kink_share_per_dispatch=[],
                   kink_elements_held=0, kink_elements_beyond_rounding=0,
                   kink_max_gap_over_bound=0.0, kink_dense_max_err_over_bound=0.0)
        if not kink_sync:
            shape = states["cpu"]["tables"]["emb"]["param"].shape
            out["kink_elements"] = {key: torch.zeros(shape, dtype=torch.bool)
                                    for key in ("held", "beyond_rounding")}

    def rows_of(side, uk):
        idx = uk.to(steps[side].device)
        return {n: {k: t[k][idx].cpu() for k in ("param", "n", "z")}
                for n, t in states[side]["tables"].items()}

    dense_before = {}

    def kinks_of(view: dict, window: dict, num_real: float) -> dict:
        """relu_kinks on both sides' state as it stands (before the
        update)."""
        return relu_kinks(card_step.model, view,
                          {side: states[side]["tables"] for side in steps},
                          {side: states[side]["dense"] for side in steps},
                          {side: window[side]["snaps"] for side in window},
                          s_fields, h, num_real)

    def hold_kinks(uk, snap, tolerance, jumps) -> None:
        """Pooled families: hold every emb element of the rows ``uk``
        that a kinked unit reaches (``jumps`` > 0) and the update stepped
        (``snap``: step_both's rows before and after, each side): the two
        sides' recovered gradients lie within ``tolerance`` (computed
        once, when needed) plus both read-backs' errors plus the jump;
        then (with ``kink_sync``) the CPU takes the card's state there.
        Counts the held elements, and those beyond the bound without the
        jump (which took it), which the diagnostic returns.  An n' == 0
        split was held by step_both already."""
        jump = jumps["emb"].double()
        held = jump > 0
        if not bool(held.any()):
            return
        (cb, ca), (pb, pa) = snap["card"], snap["cpu"]
        # the elements this update stepped on either side, but no split
        held &= ((ca["emb"]["n"] == 0) == (pa["emb"]["n"] == 0)) & (
            (ca["emb"]["z"] != cb["emb"]["z"]) | (ca["emb"]["n"] != cb["emb"]["n"])
            | (pa["emb"]["z"] != pb["emb"]["z"]) | (pa["emb"]["n"] != pb["emb"]["n"]))
        g_card, err_card = recovered_grads(cb["emb"], ca["emb"], opt)
        g_cpu, err_cpu = recovered_grads(pb["emb"], pa["emb"], opt)
        base = tolerance()["emb"].double() + err_card + err_cpu
        gap = (g_card - g_cpu).abs()
        over = held & (gap > base)
        ratio = torch.where(held, gap / (base + jump), 0.0)
        out["kink_elements_held"] += int(held.sum())
        out["kink_elements_beyond_rounding"] += int(over.sum())
        out["kink_max_gap_over_bound"] = max(out["kink_max_gap_over_bound"],
                                             float(ratio.max()))
        if synchronize and bool((ratio > 1.0).any()):
            i, col = divmod(int(torch.argmax(ratio)), jump.shape[1])
            raise AssertionError("an emb element of a kinked row beyond its bound: " + json.dumps(
                {"slice": out["slices"], "row": int(uk[i]), "col": col,
                 "g": {"card": float(g_card[i, col]), "cpu": float(g_cpu[i, col])},
                 "bound": float(base[i, col]), "jump": float(jump[i, col])}))
        if not kink_sync:
            for key, mask in (("held", held), ("beyond_rounding", over)):
                idx = mask.nonzero()
                out["kink_elements"][key][uk[idx[:, 0]], idx[:, 1]] = True
        elif synchronize:
            idx = held.nonzero()
            rows, cols = uk[idx[:, 0]], idx[:, 1]
            for k in ca["emb"]:
                states["cpu"]["tables"]["emb"][k][rows, cols] = ca["emb"][k][idx[:, 0], cols]

    def hold_dense(dense_jump: dict) -> None:
        """Pooled families, after a slice with a kinked unit: the dense
        parameters on the card within TRAIN_BOUNDS' terms of the CPU's
        plus sgd_lr times the kinked units' gradient jumps; then (with
        ``kink_sync``) the CPU takes the card's."""
        for name, t in states["card"]["dense"].items():
            want, got = states["cpu"]["dense"][name], t.detach().cpu()
            bound = (TRAIN_BOUNDS["table_rtol"] * want.abs()
                     + TRAIN_BOUNDS["table_atol_frac"] * want.abs().max())
            if name in dense_jump:
                bound = bound + cfg.sgd_lr * dense_jump[name]
            ratio = float(((got - want).abs() / bound.clamp(min=1e-30)).max())
            out["kink_dense_max_err_over_bound"] = max(out["kink_dense_max_err_over_bound"],
                                                       ratio)
            if not kink_sync:
                continue
            if ratio > 1.0:
                raise AssertionError(f"slice {out['slices']}: dense {name} on the card "
                                     f"{ratio} times its bound from the CPU's")
            if synchronize:
                want.copy_(got)

    def step_both(uk, update, tolerance, straddle=None, jumps=None):
        """``update(side)`` on both sides, then the n' == 0 splits and z
        jumps among the rows ``uk``; ``tolerance(before, other)`` gives the
        bounds on their summed gradients ({table: [U, width]}), computed
        once when a split needs them (plus ``jumps``, the kinks' jumps,
        when given), and
        ``straddle(before)`` (MVM) the rows whose slots straddle the
        guard, when a z jump needs it.  A pooled family's dense
        parameters before the update are kept in ``dense_before``.
        Returns the rows before and after, each side, and the bounds
        (a callable, computed once)."""
        snap = {}
        for side in steps:
            before = rows_of(side, uk)
            if pooled:
                dense_before[side] = {k: t.detach().cpu().clone()
                                      for k, t in states[side]["dense"].items()}
            update(side)
            snap[side] = (before, rows_of(side, uk))
        (cb, ca), (pb, pa) = snap["card"], snap["cpu"]
        tols = {}

        def tols_once():
            if not tols:
                tols.update(tolerance(pb, cb))
            return tols

        for name in ca:
            split = (ca[name]["n"] == 0) != (pa[name]["n"] == 0)
            tol = None
            for i, col in split.nonzero().tolist():
                if tol is None:
                    tol = tols_once()[name]
                    if jumps is not None:
                        tol = tol + jumps[name]
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
        return snap, tols_once

    def live_unique(view):
        keys = view_keys(view, h)
        return torch.unique(keys[keys >= 0])  # sorted

    for arrays in shipped:
        planes = {"card": arrays, "cpu": {k: a.cpu() if isinstance(a, torch.Tensor) else a
                                          for k, a in arrays.items()}}
        # a sequential dispatch's slices, or an unsliced one whole
        slices = arrays.get("slice_num_real", [arrays["num_real"]])
        rows = arrays["ckeys"].shape[0] // len(slices)
        views = [{side: {k: a[j * rows:(j + 1) * rows] for k, a in planes[side].items()
                         if isinstance(a, torch.Tensor)} for side in steps}
                 for j in range(len(slices))]
        window = {}
        uk_batch = live_unique(planes["cpu"])
        dispatch_kinked = 0
        if card_step.window:
            start = rows_of("cpu", uk_batch)
            start_card = rows_of("card", uk_batch)
            dense_start = {side: {k: t.detach().cpu().clone()
                                  for k, t in states[side]["dense"].items()}
                           for side in steps}
            window = {side: steps[side].window_open(states[side]["tables"], planes[side])
                      for side in steps}
            window_jumps = ({"emb": torch.zeros(uk_batch.numel(), cfg.emb_dim),
                             "w": torch.zeros(uk_batch.numel(), 1)} if pooled else None)
        for j, num_real in enumerate(slices):
            view = views[j]
            uk = live_unique(view["cpu"])
            acc = {side: torch.zeros(2, dtype=torch.float64, device=steps[side].device)
                   for side in steps}

            def update(side, j=j, view=view, num_real=num_real):
                if window:
                    steps[side].window_slice(states[side]["tables"], window[side], j,
                                             view[side], num_real, acc[side],
                                             states[side]["dense"])
                else:
                    steps[side]._update(states[side]["tables"], view[side], num_real,
                                        acc[side], states[side]["dense"])

            def tolerance(before, other, view=view, num_real=num_real, uk=uk):
                if pooled:
                    return pool_tolerances(card_step.model, view["cpu"], num_real, uk,
                                           before, other, dense_before["cpu"],
                                           dense_before["card"], s_fields, h)
                return split_tolerance(view["cpu"], num_real, uk, before, h, s_fields,
                                       form, other)

            kinks = jumps = None
            if pooled:
                kinks = kinks_of(view, window, num_real)
                jumps = kink_row_jumps(view["cpu"], uk, kinks, h)
                dispatch_kinked += int(kinks["examples"].sum())
                if window:
                    at = torch.searchsorted(uk_batch, uk)
                    for name, jump in jumps.items():
                        window_jumps[name].index_add_(0, at, jump)
            snap, tols = step_both(uk, update, tolerance, jumps=jumps,
                                   straddle=None if not guard else
                                   lambda before, view=view, num_real=num_real, uk=uk:
                                   guard_rows(view["cpu"], num_real, uk, before, h, s_fields))
            if pooled and bool(kinks["examples"].any()):
                out["kink_slices"] += 1
                out["kink_examples"] += int(kinks["examples"].sum())
                out["kink_units"] += sum(int(u.sum()) for u in kinks["units"].values())
                hold_kinks(uk, snap, tols, jumps)
                hold_dense(kinks["dense"])
            ll = {side: float(acc[side][0]) / max(float(acc[side][1]), 1.0) for side in steps}
            gap = abs(ll["card"] - ll["cpu"]) / max(abs(ll["cpu"]), 1.0)
            out["logloss_max_rel_gap"] = max(out["logloss_max_rel_gap"], gap)
            if synchronize and gap > TRAIN_BOUNDS["logloss_rtol"]:
                raise AssertionError(f"slice {out['slices']}: log-loss {ll['card']} on the "
                                     f"card vs {ll['cpu']} on the CPU")
            out["slices"] += 1
        if pooled:
            share = dispatch_kinked / arrays["ckeys"].shape[0]
            out["kink_share_per_dispatch"].append(share)
            if synchronize and share > KINK_SHARE_CAP:
                raise AssertionError(f"{share:.4f} of a dispatch's examples hold a kinked "
                                     f"ReLU unit, above KINK_SHARE_CAP {KINK_SHARE_CAP}")
        if window:
            uk = uk_batch  # the hot and cold rows the window's close steps

            def close(side):
                steps[side].window_close(states[side]["tables"], window[side])

            def window_tolerance(_before, _other, views=views, arrays=arrays,
                                 uk_batch=uk_batch, start=start, start_card=start_card,
                                 dense_start=dense_start):
                total = {}
                for j, num_real in enumerate(arrays["slice_num_real"]):
                    tols = (pool_tolerances(card_step.model, views[j]["cpu"], num_real,
                                            uk_batch, start, start_card, dense_start["cpu"],
                                            dense_start["card"], s_fields, h)
                            if pooled else split_tolerance(views[j]["cpu"], num_real,
                                                           uk_batch, start, h, s_fields,
                                                           form))
                    for name, tol in tols.items():
                        total[name] = tol if name not in total else total[name] + tol
                return total

            def window_straddle(_before, views=views, arrays=arrays,
                                uk_batch=uk_batch, start=start):
                rows = torch.zeros(uk_batch.numel(), dtype=torch.bool)
                for j, num_real in enumerate(arrays["slice_num_real"]):
                    rows |= guard_rows(views[j]["cpu"], num_real, uk_batch, start, h, s_fields)
                return rows

            snap, tols = step_both(uk, close, window_tolerance,
                                   straddle=window_straddle if guard else None,
                                   jumps=window_jumps)
            if pooled:
                hold_kinks(uk, snap, tols, window_jumps)
            out["windows"] += 1
    out["tables"] = compare_states(states["card"], states["cpu"],
                                   gate=synchronize and kink_sync)
    if keep is not None:
        keep.update(states)
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

def kink_witness(dev, workdir: str) -> dict:
    """wide_deep's hot inner (phase 35's ``hot_inner_mb128``: one
    dispatch of 128 slices, the path whose card-vs-CPU replay once
    missed TRAIN_BOUNDS on a hot emb row) trained on the card, then
    replayed through ``lockstep_tables`` from the same seeded state
    twice: as the phases replay it, and with ReLU's kinks left
    unsynchronised (each kinked element still held to its bound).  For
    the second, the final emb arrays against TRAIN_BOUNDS: the worst
    element over all, over the elements a kinked unit never reached,
    and over those that never went beyond their bound without the
    jump, and whether the worst lies among either."""
    import torch

    from xflow_tpu_torch.trainer import Trainer

    data = write_train_shards(workdir)
    mode = next(m for f, label, m, *_ in POOLED_MODES
                if f == "wide_deep" and label == "hot_inner_mb128")
    cfg = pooled_config("wide_deep", single_shard(data, workdir), "", **mode, epochs=1)
    init = fresh_init(dev, cfg)
    trainer = Trainer(cfg, device=dev, log=lambda _: None)
    trainer.state = state_of(cfg, init, dev)
    shipped = keep_shipped_batches(trainer)
    trainer.train()
    torch.cuda.synchronize()
    trainer.close()
    out = {}
    for kink_sync in (True, False):
        t0 = time.perf_counter()
        keep = {}
        rep = lockstep_tables(trainer.step, cfg, init, shipped, kink_sync=kink_sync,
                              keep=keep)
        masks = rep.pop("kink_elements", None)
        rep["seconds"] = time.perf_counter() - t0
        if masks is not None:
            worst = {}
            for key in ("param", "n", "z"):
                want = keep["cpu"]["tables"]["emb"][key].to(dev)
                got = keep["card"]["tables"]["emb"][key]
                bound = (TRAIN_BOUNDS["table_rtol"] * want.abs()
                         + TRAIN_BOUNDS["table_atol_frac"] * want.abs().max())
                ratio = (got - want).abs() / torch.where(bound > 0, bound, 1.0)
                i = int(torch.argmax(ratio))
                row, col = divmod(i, ratio.shape[1])
                worst[key] = {
                    "max_err_over_bound": float(ratio.view(-1)[i]), "row": row, "col": col,
                    "row_is_hot": row < cfg.hot_size,
                    **{f"worst_{m}": bool(masks[m][row, col]) for m in masks},
                    **{f"max_err_over_bound_outside_{m}":
                       float(torch.where(masks[m].to(dev), 0.0, ratio).max()) for m in masks},
                    "elements": {m: int(masks[m].sum()) for m in masks}}
                del want, got, bound, ratio
            rep["unsynced_emb"] = worst
        out["synchronised" if kink_sync else "kinks_unsynchronised"] = rep
        log(json.dumps({"kink_witness": kink_sync, **{k: v for k, v in rep.items()
                                                      if not k.endswith("records")}}))
        del keep
        torch.cuda.empty_cache()
    return out


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
    parser.add_argument(
        "--kink-witness", action="store_true",
        help="instead of the phases: wide_deep's hot inner replayed on the card "
        "and the CPU in lockstep with ReLU's kinks synchronised and not")
    parser.add_argument(
        "--kernel-times", nargs="?", const=",".join(KERNEL_TIME_GROUPS), default="",
        metavar="GROUPS",
        help="instead of the phases: the kernels timed alone on path-like batches, the "
        f"comma-separated GROUPS of {', '.join(KERNEL_TIME_GROUPS)} (all by default; "
        "kernel_times); run from two checkouts in one call to compare them")
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

    global T_START
    t_start = T_START = time.perf_counter()
    dev = resolve_device("cuda")
    cpu_k3_on_touched_rows()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(dev)}")
    # the dense blocks run in full float32: neither flag is changed
    log(json.dumps({"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                    "float32_matmul_precision": torch.get_float32_matmul_precision()}))
    log(json.dumps(dict(build_all(), phase=1)))
    if args.kernel_times:
        groups = tuple(args.kernel_times.split(","))
        unknown = set(groups) - set(KERNEL_TIME_GROUPS)
        if unknown:
            raise SystemExit(f"chip_smoke: unknown --kernel-times groups {sorted(unknown)}")
        log(json.dumps({"kernel_times": kernel_times(dev, groups), "card": card}))
        log(f"chip_smoke: diagnostic done in {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.seq_witness or args.seq_lockstep or args.kink_witness:
        workdir = tempfile.mkdtemp(prefix="xflow-seq-witness-")
        try:
            if args.seq_witness:
                seq_witness(dev, T_LOG2, workdir, args.seq_witness)
            elif args.kink_witness:
                kink_witness(dev, workdir)
            else:
                seq_lockstep(dev, T_LOG2, workdir, args.seq_lockstep)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"chip_smoke: diagnostic done in {time.perf_counter() - t_start:.1f} s")
        return 0
    for name in ("score", "train", "optim", "sparse", "wire", "pool"):
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
    k2_table = phase_k2_table(dev)
    log(json.dumps({"phase": "6b", **{k: a for k, a in k2_table.items()
                                      if k != "table_cover"}}))
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
        log(f"phases 1-14 done at {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        k6 = phase_k6(dev, train_path["data"], T_LOG2)
        log(json.dumps({"phase": 15, "checks": k6["checks"]}))
        torch.cuda.empty_cache()
        paths = phase_input_paths(dev, T_LOG2, workdir, train_path)
        torch.cuda.empty_cache()
        hot = phase_hot(dev, T_LOG2, workdir, train_path)
        log(f"phases 17-20 done at {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        wide = phase_wide_fm(dev, workdir, train_path)
        log(json.dumps({"phase": 21, "k1_fm_d_tiled": wide["k1"],
                        "k2_fm_d_tiled": wide["k2"]}))
        torch.cuda.empty_cache()
        mvm = phase_mvm(dev, T_LOG2, workdir, train_path)
        log(f"phases 21-27 done at {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        ffm = phase_ffm(dev, workdir, train_path)
        log(f"phases 28-33 done at {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        pooled = phase_pooled(dev, workdir, train_path)
        log(f"phases 34-38 done at {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        c5 = phase_c5(dev)
        log(json.dumps({"phase": 39, "c5_worst": c5["worst"]}))
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
    train_rows += ffm_train_rows(ffm, card)
    train_rows += pooled_train_rows(pooled, card)
    log(json.dumps({"train": train_rows}))

    head = next(r for r in timings if r["mode"] == "fm" and r["B"] == BUCKETS[-1])
    fm_row = next(r for r in train_path["rows"] if r["model"] == "fm")
    k2_head = next(r for r in fm_row["k2_main_path"] if r["keys"] == "main_path")
    k3_head = next(r for r in fm_row["k3_main_path"] if r["table"] == "v")
    k2_main = [r for row in train_path["rows"] for r in row["k2_main_path"]]
    k3_main = [dict(r, model=row["model"]) for row in train_path["rows"]
               for r in row["k3_main_path"]]
    k2_err = {k: max(k2_check[k], train_path["k2_check"][k],
                     modes["worst"]["k2_index"][k], k2_table[k])
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
                   and r["model"] == "fm" and r["path"] == "sparse main path")
    k2_index = [r for r in modes["timings"] if r["kernel"].startswith("train_step")]
    kernels = [{
        "name": "score",
        "route": "cuda",
        "source": "xflow_tpu_torch/csrc/score.cu",
        "replaces": REPLACES,
        "launches": main_path["launches"] + train_launches["score"],
        "launches_by_path": {"serve": main_path["launches"],
                             "train": train_launches["score"]},
        # every training path's K1 launches are its eval batches (the
        # exact counts of phases 8, 11-13 and 16) but phase 8's artifact
        # scoring, at the engine's buckets
        "launches_by_shape": {
            "serving, buckets of up to 512 rows (phases 3-4)": main_path["launches"],
            "artifact scoring, buckets of up to 512 rows (phase 8)":
                train_path["k1_engine_launches"],
            f"eval, {min(TEST_LINES, TRAIN_BATCHES[-1])}-row batches":
                train_launches["score"] - train_path["k1_engine_launches"]},
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
        "bound_full_ms": k3_head["bound_full_ms"],
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
        "shape": {"optimizer": "ftrl", "tables": "w and v in one launch", "U": k5_head["U"],
                  "D": [1, D], "keys": "the sparse main path's first batch"},
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
    kernels += ffm_kernel_entries(ffm)
    kernels += pooled_kernel_entries(pooled)
    # C5: each field form's device-memory stage past its cap (phase 39),
    # beside the entry of its form
    for entry in kernels:
        name = entry["name"]
        geometry = ("mvm" if "mvm" in name else "ffm" if "ffm" in name
                    else "pooled" if name.startswith("field_pool") else None)
        if geometry is None or "dict_decode" in name:
            continue
        entry["past_cap"] = [r for r in c5["timings"] if r["geometry"] == geometry
                             and r["kernel"].split(" ")[0] == name.split(" ")[0]]
        entry["past_cap_max_abs_err"] = c5["worst"]["max_abs_err"]
    # the hot paths' K4 plans and full-table K3 passes, beside the
    # entries' own paths above
    hot_rows = {f"{r['model']} {r['mode']}": r for r in hot["rows"]}
    kernels[3]["launches_hot_paths"] = sum(n["consolidate_keys"]
                                           for n in hot["launches_by_path"].values())
    kernels[2]["launches_hot_paths_full_table"] = sum(
        r["steps"] * r["tables"] for p, r in hot_rows.items()
        if r["mode"] in ("hot_dense", "hot_inner_windowend_dense"))
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("a float32 matmul flag changed during the run: the dense "
                             "blocks must run in full float32")
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
