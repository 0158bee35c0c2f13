"""Training/eval loop (the reference's trainer.py for one host): the
worker loop of the reference (LRWorker::train / batch_training /
predict, lr_worker.cc:73-217) as a host loop feeding the train step on
the card.

Each epoch streams every ``prefix-%05d`` train shard (libffm text,
binary block-cache shards, or packed shards from ``python -m
xflow_tpu_torch.io.packed``) through the loader (the native parser
when ``native_parser`` and it builds, and the packer, on a prefetch
thread), or with ``input_streams > 1`` through N concurrent shard
streams (io/fanout.py), each with its own parse workers and the
dictionary wire's host compaction (``TrainStep.precompact``), merged
back into serial shard order.  The staging ring (``_transfer_ahead``)
runs the host half of ``put_batch`` ``transfer_ahead_depth`` batches
ahead on worker threads: compaction, the copy into pinned memory and
the copies on the step's copy stream (booked as ``h2d``, reported
under ``overlapped``).  The training thread runs the device half (the
stream waits on the copies' event; K6 decodes the dictionary wire) and
queues the update's kernels (``dispatch``).  Batch order, and so
training, is the same at any depth and stream count.  Nothing in the
loop waits for the card: the per-step metrics stay on the device and
are fetched once per epoch (``device_block``), as the reference does
(trainer.py:930-932).  ``evaluate`` streams the test shard(s) through
K1 and reports log-loss and midrank AUC, optionally writing the
reference's ``label\\tpctr`` prediction lines.

With a hot table (``hot_size_log2 > 0``) the trainer takes the
frequency remap from ``checkpoint_dir/remap.npy`` when a previous run
saved one, and otherwise measures key frequencies over the first
``freq_sample_mib`` of the training shards and builds it (io/freq.py),
as the reference's ``_init_remap`` does (trainer.py:425-478), logging
how much of the sampled occurrence mass the H head rows capture, and
saves it there; the loaders then remap and steer every batch,
``prepare_batch`` does the same for an external batch, and an exported
artifact carries the remap.  Packed shards hold post-remap keys: a hot
model trains from them with the remap their packer was given, kept in
``checkpoint_dir/remap.npy``.

With ``checkpoint_dir`` the trainer checkpoints (utils/checkpoint.py)
at every epoch end and every ``checkpoint_every_steps`` steps, books
each save as the ``checkpoint`` phase (``checkpoint_seconds`` in the
epoch record), and ``restore`` resumes from the newest generation,
mid-shard at the saved data cursor; SIGTERM or SIGINT during
``train()`` finishes the step in flight, checkpoints the cursor of the
last batch dispatched (batches the ring staged past it are dropped and
read again on resume) and returns with the epoch record's
``preempted`` set.

Under ``store_mode="tiered"`` (store/) the state is the store's hot
tier, the staging ring is off (a ring worker planning batch N+1 would
cold-fetch keys whose batch-N write-back is still in flight), the
store's maintenance applies the promotion worker's plan every
``store_promote_every`` steps and at each epoch end, each epoch logs a
``store`` row, and checkpoints are the store's tier-erased fold.

Not ported yet, and refused by name: the profiler, span trace, flight
recorder, watchdog, exporters and chaos failpoints (ROADMAP A14).
"""

from __future__ import annotations

import glob
import os
import queue
import sys
import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Iterator

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.device import resolve_device
from xflow_tpu_torch.io import freq
from xflow_tpu_torch.io.batch import Batch, remap_batch
from xflow_tpu_torch.io.loader import ShardLoader, make_parse_fn, parser_name
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.obs import Obs, emit_health, health_row
from xflow_tpu_torch.optim import make_optimizer
from xflow_tpu_torch.parallel.step import TrainStep, init_state
from xflow_tpu_torch.utils.checkpoint import (
    IncompatibleCheckpoint,
    checkpoint_candidates,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from xflow_tpu_torch.utils.metrics import AucAccumulator


def _ring_workers(depth: int) -> int:
    """The staging ring's worker count at ``depth`` (the reference's):
    one a slot up to a cap set by the host's cores, and at least 2 once
    the ring double-buffers, so that one worker can compact while
    another copies."""
    if depth <= 1:
        return 1
    return min(depth, max(2, min(4, (os.cpu_count() or 2) - 1)))


class _StagingRing:
    """The staging ring's workers: ``workers`` daemon threads named
    ``xf-ring-<i>`` taking jobs in submission order, each job resolving
    a Future.  ``close`` is bounded: it cancels the jobs not started and
    joins the workers, whose jobs in flight are bounded host work and
    copies."""

    def __init__(self, workers: int):
        self._jobs: queue.SimpleQueue = queue.SimpleQueue()
        self._threads = [
            threading.Thread(target=self._work, name=f"xf-ring-{i}", daemon=True)
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    def submit(self, fn: Callable, *args: Any) -> Future:
        fut: Future = Future()
        self._jobs.put((fut, fn, args))
        return fut

    def _work(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            fut, fn, args = job
            if not fut.set_running_or_notify_cancel():
                continue  # cancelled before it started
            try:
                fut.set_result(fn(*args))
            except BaseException as e:  # reaches the consumer's result()
                fut.set_exception(e)

    def close(self, pending: list[Future], join_timeout: float) -> int:
        """Cancel ``pending`` jobs not yet started, stop every worker and
        join them within ``join_timeout`` seconds in all; returns how
        many outlived the join."""
        for fut in pending:
            fut.cancel()
        for _ in self._threads:
            self._jobs.put(None)
        deadline = time.monotonic() + join_timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        return sum(t.is_alive() for t in self._threads)


def find_shards(prefix: str) -> list[str]:
    """All existing ``prefix-%05d`` shards, in rank order; if none match,
    treat ``prefix`` itself as a single file."""
    shards = sorted(glob.glob(glob.escape(prefix) + "-" + "[0-9]" * 5))
    if not shards:
        if os.path.exists(prefix):
            return [prefix]
        raise FileNotFoundError(f"no shards matching {prefix}-NNNNN and no file {prefix}")
    return shards


def check_trainer_config(cfg: Config) -> None:
    """Refuse the Trainer features this slice does not port, naming the
    ROADMAP item that brings each."""
    refusals = (
        (cfg.profile_dir, "profile_dir: the profiler hook is not ported "
         "yet (ROADMAP A14)"),
        (cfg.obs_trace_out, "obs_trace_out: the span trace is not ported "
         "yet (ROADMAP A14)"),
        (cfg.obs_flight_out or cfg.obs_watchdog, "obs_flight_out / "
         "obs_watchdog: the flight recorder and watchdog are not ported "
         "yet (ROADMAP A14)"),
        (cfg.obs_export_port or cfg.obs_resource_every_s > 0,
         "obs_export_port / obs_resource_every_s: the live exporters are "
         "not ported yet (ROADMAP A14)"),
        (cfg.obs_lock_sanitizer, "obs_lock_sanitizer is not ported yet "
         "(ROADMAP A14)"),
        (cfg.chaos_spec, "chaos_spec: the failpoint fabric is not ported "
         "yet (ROADMAP A14)"),
    )
    for refused, why in refusals:
        if refused:
            raise NotImplementedError(why)


class Trainer:
    """One host, one device (the card unless ``device="cpu"`` is asked
    for), ``input_streams`` shard streams and the staging ring."""

    def __init__(
        self,
        cfg: Config,
        device: str | torch.device = "cuda",
        log: Callable[[str], None] | None = None,
    ):
        check_trainer_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = make_model(cfg)
        self.optimizer = make_optimizer(cfg)
        self.obs = Obs()
        self.step = TrainStep(
            self.model, self.optimizer, cfg, self.device, obs=self.obs
        )
        # tiered: the device state is the bounded hot tier, not a [T, D]
        # table (at 2^28 that is the very buffer the store avoids)
        if self.step.store is not None:
            self.state = self.step.store.init_device_state()
        else:
            self.state = init_state(self.model, self.optimizer, cfg, self.device)
        self.epoch = 0
        self._log = log if log is not None else lambda s: print(s, file=sys.stderr)
        self.host = 0
        self.num_hosts = 1
        self._resume_cursor: tuple[int, int] = (0, 0)
        self._preempted = False
        # the hot table's frequency remap (io/freq.py): loaded from the
        # checkpoint dir when present, else measured from a deterministic
        # sample of the training data
        self.remap: np.ndarray | None = None
        self.hot_mass: float | None = None
        if cfg.hot_size_log2:
            self._init_remap()
        else:
            # the reverse of _init_remap's guard: a checkpoint trained
            # WITH a hot table stores rows in the permuted space
            path = self._remap_path()
            if path is not None and os.path.exists(path):
                raise ValueError(
                    f"{path} exists: this checkpoint_dir was trained "
                    "with a hot table; set hot_size_log2 to match "
                    "(or use a fresh checkpoint_dir)"
                )
        # every step's train log-loss so far, fetched at each epoch end
        self.step_logloss: list[float] = []
        # live loader prefetch iterators, closed by close() so abandoned
        # producer threads never outlive the Trainer
        self._live_prefetch: set = set()
        # live staging rings (train_epoch's _transfer_ahead generators),
        # closed by close() when an exception or a preemption abandons one
        self._live_transfer: set = set()
        self.metrics_logger = None
        if cfg.metrics_out:
            from xflow_tpu_torch.utils.logging import MetricsLogger

            self.metrics_logger = MetricsLogger(
                cfg.metrics_out, run_header=self._run_header()
            )
            self.obs.metrics_logger = self.metrics_logger

    # -- lifecycle ---------------------------------------------------------

    def _run_header(self) -> dict:
        """The metrics file's ``run_start`` row: enough to tell two
        appended runs apart and check their configs match."""
        dev = self.device
        return {
            "run_id": f"{int(time.time() * 1000):x}-{os.getpid():x}",
            "config_digest": self.cfg.digest(),
            "rank": self.host,
            "num_hosts": self.num_hosts,
            "model": self.cfg.model,
            "device": (
                torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
            ),
            # the parser that runs: Config.native_parser asks for the
            # native one, and a host that cannot build it parses in Python
            "parser": parser_name(self.cfg.native_parser),
        }

    def close(self) -> None:
        """Stop every live staging ring and prefetch thread (each with a
        bounded join) and close the metrics file.  Idempotent; use the
        Trainer as a context manager to cover every exit."""
        for gen in list(self._live_transfer):
            # GeneratorExit at its suspended yield: _transfer_ahead
            # cancels its queued work and joins its workers
            gen.close()
        self._live_transfer.clear()
        for it in list(self._live_prefetch):
            it.close()
        self._live_prefetch.clear()
        if self.step.store is not None:
            # flush the pending miss write-back and reap the promotion
            # worker (bounded join; a leak lands as a health row before
            # the metrics logger closes below)
            self.step.store.close()
        if self.metrics_logger is not None:
            self.metrics_logger.close()

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- input -------------------------------------------------------------

    def _parse_fn(self):
        cfg = self.cfg
        return make_parse_fn(cfg.table_size, cfg.hash_mode, cfg.seed,
                             prefer_native=cfg.native_parser)

    def _remap_path(self) -> str | None:
        if not self.cfg.checkpoint_dir:
            return None
        return os.path.join(self.cfg.checkpoint_dir, "remap.npy")

    def _init_remap(self) -> None:
        """The saved remap of ``checkpoint_dir``, else one counted over
        the first ``freq_sample_mib`` of the GLOBAL shard list and saved
        there (the reference's ``_init_remap``)."""
        cfg = self.cfg
        path = self._remap_path()
        if path is not None:
            existing = freq.load_remap(path)
            if existing is not None:
                if len(existing) != cfg.table_size:
                    raise ValueError(
                        f"saved remap at {path} has {len(existing)} rows "
                        f"but table_size is {cfg.table_size} — "
                        "table_size_log2 changed between runs?"
                    )
                self.remap = existing
                return
        if path is not None and latest_checkpoint(cfg.checkpoint_dir):
            raise ValueError(
                "hot table enabled but this checkpoint_dir holds a "
                "checkpoint trained WITHOUT one (no remap.npy): the table "
                "rows live in the unpermuted key space — set "
                "hot_size_log2=0 to resume it, or use a fresh "
                "checkpoint_dir"
            )
        if not cfg.train_path:
            raise ValueError(
                "hot table enabled but no train_path to sample key "
                "frequencies from and no saved remap in checkpoint_dir"
            )
        counts = freq.count_keys(
            find_shards(cfg.train_path), self._parse_fn(), cfg.table_size,
            cfg.freq_sample_mib << 20, cfg.block_mib << 20,
        )
        self.remap = freq.build_remap(counts, cfg.hot_size)
        self.hot_mass = freq.hot_mass(counts, self.remap, cfg.hot_size)
        self._log(
            f"hot remap: {cfg.hot_size} rows capture {self.hot_mass:.1%} of "
            f"sampled feature occurrences"
        )
        if path is not None and self.host == 0:
            os.makedirs(cfg.checkpoint_dir, exist_ok=True)
            freq.save_remap(path, self.remap)

    def prepare_batch(self, batch: Batch) -> Batch:
        """Bring an externally built Batch (raw hash-space keys) into
        this model's key space: the hot remap and the hot/cold steering
        (io/batch.py::remap_batch, shared with the serving engine).
        Loader-produced batches are already prepared."""
        return remap_batch(batch, self.remap, self.cfg.hot_size, self.cfg.hot_nnz)

    def _loader(self, path: str) -> ShardLoader:
        cfg = self.cfg
        return ShardLoader(
            path,
            batch_size=cfg.batch_size,
            max_nnz=cfg.max_nnz,
            table_size=cfg.table_size,
            block_mib=cfg.block_mib,
            hash_mode=cfg.hash_mode,
            hash_seed=cfg.seed,
            parse_fn=self._parse_fn(),
            remap=self.remap,
            hot_size=cfg.hot_size,
            hot_nnz=cfg.hot_nnz,
            obs=self.obs,
            # v2 packed shards skip expansion AND re-compaction when the
            # step ships the dictionary wire
            emit_compact=self.step.dict_wire,
            io_retries=cfg.io_retries,
            io_retry_backoff_s=cfg.io_retry_backoff_s,
            max_quarantined_frac=cfg.max_quarantined_frac,
        )

    def _tracked_prefetch(self, loader: ShardLoader, depth: int, offset: int,
                          workers: int):
        it = loader.prefetch(depth, offset, workers)
        self._live_prefetch.add(it)
        return it

    def _parse_workers(self) -> int:
        w = self.cfg.parse_workers
        if w < 0:
            w = max(1, min(6, (os.cpu_count() or 1) - 1))
        return w

    def _my_shards(self, prefix: str) -> list[str]:
        shards = find_shards(prefix)
        return [s for i, s in enumerate(shards) if i % self.num_hosts == self.host]

    def iter_train_batches(
        self, start_shard: int = 0, start_offset: int = 0
    ) -> Iterator[tuple[Batch, int, int]]:
        """Yields (batch, shard_index, resume_offset) over one epoch,
        from shard ``start_shard`` at byte offset ``start_offset`` (a
        restored cursor); each finished shard logs a ``shard`` row with
        its observed loader throughput when metrics are on.  With
        ``input_streams > 1`` the shard list fans out over N concurrent
        streams (io/fanout.py): the same batches in the same order."""
        shards = self._my_shards(self.cfg.train_path)
        if self.cfg.input_streams > 1:
            yield from self._iter_fanout(shards, start_shard, start_offset)
            return
        depth = self.cfg.prefetch_batches
        workers = self._parse_workers()
        for si, path in enumerate(shards):
            if si < start_shard:
                continue
            offset = start_offset if si == start_shard else 0
            loader = self._loader(path)
            it = self._tracked_prefetch(loader, depth, offset, workers)
            t_shard = time.perf_counter()
            examples = 0
            try:
                for batch, resume in it:
                    examples += batch.num_real()
                    yield batch, si, resume
            finally:
                it.close()
                self._live_prefetch.discard(it)
            self._log_shard_row(si, path, examples, time.perf_counter() - t_shard)

    def _iter_fanout(
        self, shards: list[str], start_shard: int, start_offset: int
    ) -> Iterator[tuple[Batch, int, int]]:
        """``iter_train_batches`` through the N-stream fan-out: stream s
        reads shards i % N == s, each with its share of the parse
        workers and the host compaction (``TrainStep.precompact``), and
        the merge restores serial shard order.  ``shard`` rows keep the
        serial path's consumer-side timing; ``stream`` rows land when
        the epoch's pool winds down (a preemption's break included)."""
        from xflow_tpu_torch.io.fanout import ShardStreamPool

        cfg = self.cfg
        workers = self._parse_workers()
        n_eff = max(1, min(cfg.input_streams, len(shards) - start_shard))
        pool = ShardStreamPool(
            shards,
            self._loader,
            num_streams=cfg.input_streams,
            depth=max(1, cfg.prefetch_batches),
            start_shard=start_shard,
            start_offset=start_offset,
            # the serial path's parse workers divide across the streams,
            # so N streams do not multiply the thread budget
            parse_workers=max(1, workers // n_eff) if workers > 1 else workers,
            transform=self.step.precompact,
            obs=self.obs,
        )
        self._live_prefetch.add(pool)
        cur: int | None = None
        examples = 0
        t_shard = time.perf_counter()
        try:
            for batch, si, resume in pool:
                if cur is None:
                    cur = si
                elif si != cur:
                    self._log_shard_row(cur, shards[cur], examples,
                                        time.perf_counter() - t_shard)
                    cur = si
                    examples = 0
                    t_shard = time.perf_counter()
                examples += batch.num_real()
                yield batch, si, resume
            if cur is not None:
                self._log_shard_row(cur, shards[cur], examples,
                                    time.perf_counter() - t_shard)
        finally:
            pool.close()
            self._live_prefetch.discard(pool)
            self._log_stream_rows(pool)

    def _log_stream_rows(self, pool) -> None:
        """One ``stream`` row per reader stream per epoch: its finished
        shards' totals and backpressure stall (the reference's keys,
        obs/schema.py)."""
        if self.metrics_logger is None:
            return
        for row in pool.stream_stats():
            self.metrics_logger.log("stream", {"epoch": self.epoch, **row})

    def _transfer_ahead(
        self, it: Iterator[tuple[Batch, int, int]], depth: int | None = None
    ) -> Iterator[tuple[Any, int, int]]:
        """The staging ring: ``put_batch_host`` (compaction, the pinned
        copy, the copies on the step's copy stream) runs up to ``depth``
        (``transfer_ahead_depth``) items ahead of the consumer on worker
        threads, and yields ``(staged, shard_idx, resume)`` for
        ``put_batch_device``.  The pending deque keeps submission order,
        so batch order, and training, is the same at any depth.  On any
        exit (the stream's end, a worker's exception, ``close()`` at a
        preemption) it cancels the work not started, joins its workers
        within 30 s in all, and closes ``it``; a worker that outlives
        the join is counted (``ring.leaked_threads``) and reported."""
        if depth is None:
            depth = self.cfg.transfer_ahead_depth
        ring = _StagingRing(_ring_workers(depth))
        pending: deque = deque()
        try:
            for batch, si, resume in it:
                pending.append((ring.submit(self.step.put_batch_host, batch), si, resume))
                # occupancy: steadily depth + 1 means the device (or the
                # dispatch) is the bottleneck, 0-1 that the input is
                self.obs.observe("transfer_ahead_depth", len(pending))
                if len(pending) > depth:
                    fut, psi, presume = pending.popleft()
                    yield fut.result(), psi, presume
            while pending:
                fut, psi, presume = pending.popleft()
                yield fut.result(), psi, presume
        finally:
            self._reap_ring(ring, [fut for fut, _, _ in pending])
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _reap_ring(self, ring: _StagingRing, pending: list,
                   join_timeout: float = 30.0) -> None:
        leaked = ring.close(pending, join_timeout)
        if leaked:
            warnings.warn(
                f"{leaked} staging-ring worker(s) outlived their close() join "
                f"({join_timeout:.1f}s): wedged in put_batch_host",
                RuntimeWarning,
                stacklevel=3,
            )
            self.obs.counter("ring.leaked_threads", leaked)
            emit_health(
                self.obs, cause="ring_thread_leak", channel="transfer",
                detail=f"{leaked} staging-ring worker(s) outlived close() join",
                silence_seconds=join_timeout, threshold_seconds=join_timeout,
            )

    def _log_shard_row(self, si: int, path: str, examples: int, dt: float) -> None:
        if self.metrics_logger is None:
            return
        self.metrics_logger.log("shard", {
            "epoch": self.epoch,
            "shard": os.path.basename(path),
            "index": si,
            "examples": examples,
            "seconds": round(dt, 3),
            "examples_per_sec": round(examples / max(dt, 1e-9), 1),
        })

    # -- training ----------------------------------------------------------

    def _timed_save(self, shard_idx: int, offset: int) -> float:
        """save() booked as the ``checkpoint`` phase; returns its seconds,
        which the epoch record reports as ``checkpoint_seconds`` apart
        from examples/s.  A failed save leaves a ``health`` row before
        re-raising: the previous complete generation stays restorable."""
        t0 = time.perf_counter()
        try:
            with self.obs.phase("checkpoint"):
                self.save(shard_idx, offset)
        except BaseException as e:
            if self.metrics_logger is not None:
                self.metrics_logger.log("health", health_row(
                    cause="checkpoint_save_failed",
                    channel="train",
                    silence_seconds=0.0,
                    threshold_seconds=0.0,
                    detail=f"{type(e).__name__}: {e} — previous "
                    "complete generation remains restorable",
                ))
            raise
        return time.perf_counter() - t0

    def train_epoch(self, start_shard: int = 0, start_offset: int = 0) -> dict:
        """One epoch from shard ``start_shard`` at ``start_offset``;
        with ``checkpoint_dir`` a save every ``checkpoint_every_steps``
        steps, and on preemption a save at the step in flight (once: a
        periodic save of the same step already holds it) and a stop."""
        cfg = self.cfg
        obs = self.obs
        obs.registry.reset()  # epoch-scoped phase accounting
        t0 = time.time()
        steps = 0
        ckpt_seconds = 0.0
        preempted = False
        device_metrics = []  # fetched once at epoch end: no sync per step
        store = self.step.store
        # the staging ring runs put_batch's host half ahead; reaped below
        # on the normal path, by close() when an exception abandons it.
        # The tiered store runs without it: its plans must follow the
        # previous step's write-back (read-your-writes)
        batches = self.iter_train_batches(start_shard, start_offset)
        stream = batches if store is not None else self._transfer_ahead(batches)
        self._live_transfer.add(stream)
        it = iter(stream)
        while True:
            t_step = time.perf_counter()
            try:
                # the input stall: parse, pack and the host half of
                # put_batch hide behind this wait, and what they do not
                # overlap surfaces here
                with obs.phase("input_stall"):
                    item, shard_idx, resume = next(it)
            except StopIteration:
                break
            if store is not None:
                arrays = self.step.put_batch(item)
            else:
                # the device half where the reference decodes the wire:
                # in the step (its jitted _expand_dict_wire)
                with obs.phase("dispatch"):
                    arrays = self.step.put_batch_device(item)
            device_metrics.append(self.step.dispatch_train(self.state, arrays))
            obs.observe("step_seconds", time.perf_counter() - t_step)
            steps += 1
            if store is not None and steps % cfg.store_promote_every == 0:
                # between-steps tier maintenance: flush the miss
                # write-back, apply the promotion worker's plan
                # (in-flight batches never see a moving key->slot map)
                self.state = store.maintain(self.state, obs=obs)
            saved = False
            if cfg.checkpoint_dir and cfg.checkpoint_every_steps and (
                steps % cfg.checkpoint_every_steps == 0
            ):
                ckpt_seconds += self._timed_save(shard_idx, resume)
                saved = True
            if self._preempted:
                if not saved:
                    ckpt_seconds += self._timed_save(shard_idx, resume)
                preempted = True
                break
        # no-op when the stream ran dry; on a preemption's break it stops
        # the ring and the loader now (their staged batches are dropped)
        self._live_transfer.discard(stream)
        stream.close()
        if store is not None:
            # epoch-end flush: the LAST step's miss write-back must land
            # before eval/save/export reads the cold store
            self.state = store.maintain(self.state, obs=obs)
        with obs.phase("device_block"):
            if device_metrics:
                host = torch.stack((
                    torch.stack([m["logloss"] for m in device_metrics]),
                    torch.stack([m["count"] for m in device_metrics]),
                )).cpu().numpy()
            else:
                host = np.zeros((2, 0), np.float32)
        self.step_logloss.extend(float(ll) for ll in host[0])
        seen = float(sum(float(c) for c in host[1]))
        ll_sum = float(sum(float(ll) * float(c) for ll, c in zip(host[0], host[1])))
        return self._epoch_stats(seen, ll_sum, steps, time.time() - t0,
                                 ckpt_seconds, preempted)

    def _epoch_stats(self, seen: float, ll_sum: float, steps: int, dt: float,
                     ckpt_seconds: float = 0.0, preempted: bool = False) -> dict:
        """Epoch record: throughput, per-phase wall seconds, stall
        fraction, step-time percentiles, the staging ring's mean
        occupancy and the ``wire`` row.  `phases` holds
        main-thread-exclusive intervals; `overlapped` holds the worker
        threads' parse, pack and h2d, which hide behind input_stall."""
        snap = self.obs.registry.snapshot(reset=True)
        phases = snap.phase_seconds()
        # the worker threads' phases: parse and pack, and under the
        # staging ring put_batch's host half (h2d); the tiered store runs
        # put_batch inline on the training thread, an exclusive phase
        workers = ("parse", "pack") + (("h2d",) if self.step.store is None else ())
        overlapped = {k: round(phases.pop(k), 6) for k in workers if k in phases}
        phases = {k: round(v, 6) for k, v in phases.items()}
        step_hist = snap.hists.get("step_seconds", {})
        stats = {
            "epoch": self.epoch,
            "examples": seen,
            "steps": steps,
            "train_logloss": ll_sum / max(seen, 1.0),
            "examples_per_sec": seen / max(dt - ckpt_seconds, 1e-9),
            "seconds": dt,
            "checkpoint_seconds": round(ckpt_seconds, 6),
            "preempted": preempted,
            "phases": phases,
            "overlapped": overlapped,
            "input_stall_frac": round(
                phases.get("input_stall", 0.0) / max(dt, 1e-9), 6
            ),
            "step_time_p50": round(step_hist.get("p50", 0.0), 6),
            "step_time_p90": round(step_hist.get("p90", 0.0), 6),
            "step_time_p99": round(step_hist.get("p99", 0.0), 6),
        }
        occ = snap.hists.get("transfer_ahead_depth")
        if occ:
            stats["transfer_ahead_depth_mean"] = round(occ["mean"], 3)
        # put_batch's host half split: compaction (with the reorder and
        # the wire counters), the copy into pinned memory, the enqueue
        split = {k: round(snap.counters[f"h2d.{k}_s"], 6)
                 for k in ("compact", "pin", "enqueue") if f"h2d.{k}_s" in snap.counters}
        if split:
            stats["h2d_split"] = split
        if "wire.bytes" in snap.counters:
            # compaction_ratio: cold occurrences per table row the
            # dictionary wire left to touch (1.0 on the other wires)
            touched = snap.counters.get("wire.cold_touched", 0)
            occ = snap.counters.get("wire.cold_occ", 0)
            stats["_wire"] = {
                "epoch": self.epoch,
                "format": self.step.wire_format,
                "wire_bytes_per_example": round(
                    snap.counters["wire.bytes"]
                    / max(snap.counters.get("wire.examples", 0), 1),
                    2,
                ),
                "compaction_ratio": round(occ / touched if touched else 1.0, 3),
            }
        if self.step.store is not None:
            # tiered-store accounting (store/tiered.py::plan_batch +
            # maintain) -> the epoch's `store` row; the hit rate is
            # occurrence-weighted (the share of feature occurrences the
            # hot tier served without a cold fetch)
            hits = snap.counters.get("store.hit_occ", 0)
            misses = snap.counters.get("store.miss_occ", 0)
            stats["_store"] = {
                "epoch": self.epoch,
                "hot_hit_rate": round(hits / max(hits + misses, 1), 6),
                "promotions": int(snap.counters.get("store.promotions", 0)),
                "demotions": int(snap.counters.get("store.demotions", 0)),
                "cold_fetch_seconds": round(
                    snap.counters.get("store.cold_fetch_seconds", 0.0), 6),
                "hot_occupancy": round(self.step.store.occupancy_frac(), 6),
            }
        if "loader.parse_bytes" in snap.counters:
            stats["parse_mb_per_sec"] = round(
                snap.counters["loader.parse_bytes"] / 2**20
                / max(overlapped.get("parse", 0.0), 1e-9),
                2,
            )
        return stats

    def train(self) -> list[dict]:
        """Full training run (reference batch_training loop over epochs,
        lr_worker.cc:179-205, with the epoch banner every 30 at :202).

        With ``checkpoint_dir``, every epoch end saves, and SIGTERM or
        SIGINT finishes the step in flight, saves the weights, optimizer
        state and data cursor, and returns (the last record's
        ``preempted`` is set); a later run that calls ``restore`` goes
        on mid-shard."""
        history = []
        restore_handlers = self._install_preemption_handler()
        try:
            while self.epoch < self.cfg.epochs:
                start_shard, start_offset = self._resume_cursor
                self._resume_cursor = (0, 0)
                stats = self.train_epoch(start_shard, start_offset)
                wire_stats = stats.pop("_wire", None)
                store_stats = stats.pop("_store", None)
                history.append(stats)
                if self.metrics_logger is not None:
                    self.metrics_logger.log("train_epoch", stats)
                    if wire_stats is not None:
                        self.metrics_logger.log("wire", wire_stats)
                    if store_stats is not None:
                        self.metrics_logger.log("store", store_stats)
                self._log_device_mem()
                if self.epoch % 30 == 0 or self.epoch == self.cfg.epochs - 1:
                    self._log(
                        f"epoch {self.epoch}: logloss={stats['train_logloss']:.6f} "
                        f"examples/s={stats['examples_per_sec']:.0f}"
                    )
                if stats["preempted"]:
                    # the process is about to exit for a restart: flush
                    # the metrics now
                    self.close()
                    break
                self.epoch += 1
                if self.cfg.checkpoint_dir:
                    self._timed_save(0, 0)
                if (
                    self.cfg.eval_every_epochs
                    and self.cfg.test_path
                    and self.epoch < self.cfg.epochs  # final eval is the caller's
                    and self.epoch % self.cfg.eval_every_epochs == 0
                ):
                    self.evaluate()
        except BaseException:
            self.close()  # never lose buffered metrics rows
            raise
        finally:
            restore_handlers()
        return history

    def _install_preemption_handler(self) -> Callable[[], None]:
        """Install SIGTERM/SIGINT -> checkpoint-and-stop handlers (only
        with checkpointing on, only from the main thread); returns the
        function that restores the previous handlers.  The handler fires
        ONCE and then restores them, so a second signal acts as it would
        have (a second Ctrl-C interrupts a wedged step)."""
        self._preempted = False
        if not self.cfg.checkpoint_dir:
            return lambda: None
        import signal

        prev = {}

        def restore():
            for sig, h in prev.items():
                signal.signal(sig, h)
            prev.clear()

        def on_signal(signum, frame):
            self._log(
                f"signal {signum}: finishing step, checkpointing, stopping "
                "(send again to force)"
            )
            self._preempted = True
            restore()

        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev[sig] = signal.signal(sig, on_signal)
        except ValueError:  # not the main thread: no handler possible
            restore()
            return lambda: None
        return restore

    def _log_device_mem(self) -> None:
        """Per-epoch ``device_mem`` row: the card's allocator counters
        (the CPU has none, and its row carries only id and platform)."""
        if self.metrics_logger is None or not self.cfg.obs_device_memory:
            return
        dev = self.device
        entry: dict[str, Any] = {"id": int(dev.index or 0), "platform": dev.type}
        if dev.type == "cuda":
            entry["bytes_in_use"] = int(torch.cuda.memory_allocated(dev))
            entry["peak_bytes_in_use"] = int(torch.cuda.max_memory_allocated(dev))
            entry["bytes_limit"] = int(torch.cuda.get_device_properties(dev).total_memory)
        self.metrics_logger.log(
            "device_mem", {"epoch": self.epoch, "devices": [entry]}
        )

    # -- evaluation --------------------------------------------------------

    def evaluate(self, pred_out: str | None = None) -> dict:
        cfg = self.cfg
        obs = self.obs
        obs.registry.reset()  # eval-scoped phase accounting
        t0 = time.time()
        acc = AucAccumulator()
        pred_file = None
        out_path = pred_out if pred_out is not None else cfg.pred_out
        per_block = bool(out_path) and cfg.pred_style == "per_block"
        if per_block:
            os.makedirs(out_path, exist_ok=True)
            # a previous eval with more blocks would leave stale files
            for f in glob.glob(os.path.join(out_path, f"pred_{self.host}_*.txt")):
                os.remove(f)
        elif out_path:
            pred_file = open(out_path, "w")

        def batches() -> Iterator[Batch]:
            workers = self._parse_workers()
            for path in self._my_shards(cfg.test_path):
                # reference predict uses doubled block size (lr_worker.cc:80)
                loader = self._loader(path)
                loader.block_bytes = (cfg.block_mib * 2) << 20
                it = self._tracked_prefetch(loader, cfg.prefetch_batches, 0, workers)
                try:
                    for batch, _ in it:
                        yield batch
                finally:
                    it.close()
                    self._live_prefetch.discard(it)

        try:
            block_idx = 0
            it = iter(batches())
            while True:
                try:
                    with obs.phase("input_stall"):
                        batch = next(it)
                except StopIteration:
                    break
                arrays = self.step.put_batch(batch, predict=True)
                with obs.phase("dispatch"):
                    garr = self.step.predict(self.state, arrays)
                with obs.phase("device_block"):
                    pctr = garr.cpu().numpy()
                acc.add(batch.labels, pctr, batch.weights)
                if per_block and batch.weights.sum() > 0:
                    # reference artifact granularity: one
                    # pred_<rank>_<block>.txt per block (lr_worker.cc:74-78)
                    with obs.phase("pred_write"), open(
                        os.path.join(out_path, f"pred_{self.host}_{block_idx}.txt"),
                        "w",
                    ) as f:
                        for y, p, w in zip(batch.labels, pctr, batch.weights):
                            if w > 0:
                                f.write(f"{int(y)}\t{p:.6f}\n")
                    block_idx += 1
                elif pred_file is not None:
                    with obs.phase("pred_write"):
                        for y, p, w in zip(batch.labels, pctr, batch.weights):
                            if w > 0:
                                # "(label, pctr)" lines, lr_worker.cc:62-68
                                pred_file.write(f"{int(y)}\t{p:.6f}\n")
        finally:
            if pred_file is not None:
                pred_file.close()
        with obs.phase("metrics_compute"):
            ll, auc = acc.compute()
            n = acc.count()
            pos = int(acc.pairs()[0].sum()) if n else 0
        snap = obs.registry.snapshot(reset=True)
        phases = snap.phase_seconds()
        overlapped = {
            k: round(phases.pop(k), 6) for k in ("parse", "pack") if k in phases
        }
        result = {
            "epoch": self.epoch,
            "logloss": ll,
            "auc": auc,
            "examples": n,
            "tp": pos,
            "fp": n - pos,
            "seconds": round(time.time() - t0, 3),
            "phases": {k: round(v, 6) for k, v in phases.items()},
            "overlapped": overlapped,
        }
        self._log(f"logloss: {ll:.6f}\tauc = {auc:.6f}\ttp = {pos} fp = {n - pos}")
        if self.metrics_logger is not None:
            self.metrics_logger.log("eval", result)
        return result

    # -- checkpointing -----------------------------------------------------

    def save(self, shard_idx: int = 0, offset: int = 0,
             extra: dict | None = None) -> str | None:
        """Checkpoint the state with the data cursor ``(shard_idx,
        offset)`` of this epoch (``extra`` merges more keys into the
        manifest's cursor); returns the path, or None without
        ``checkpoint_dir``."""
        if not self.cfg.checkpoint_dir:
            return None
        # per-host cursors, as the reference records them: a host
        # restores its own
        cursors = [{"shard": int(shard_idx), "offset": int(offset)}]
        cursor = {
            "epoch": self.epoch,
            "num_hosts": self.num_hosts,
            "cursors": cursors,
            # rank-0 view kept for human inspection of the manifest
            "shard": cursors[0]["shard"],
            "offset": cursors[0]["offset"],
        }
        if extra:
            cursor.update(extra)
        # tiered: the tier-erased fold (store/tiered.py), touched rows of
        # BOTH tiers, key-sorted, in the row-range shard format
        save = self.step.store.save_checkpoint if self.step.store is not None \
            else save_checkpoint
        return save(
            self.cfg.checkpoint_dir,
            self.state,
            cursor,
            self.cfg.to_json(),
            keep=self.cfg.checkpoint_keep,
        )

    def restore(self, auto: bool = False) -> dict | None:
        """Resume from a checkpoint if one exists; returns the cursor or
        None.  The state comes back on this trainer's device, the epoch
        and the data cursor with it (a cursor saved by another number of
        hosts restarts the epoch from its beginning).

        ``auto`` (``--resume auto``): walk every generation newest-first
        and restore the newest complete, loadable one; a generation with
        no manifest or an unreadable one is skipped with a
        ``checkpoint_fallback`` health row.  Plain mode follows LATEST
        and treats an unusable checkpoint as "start fresh"."""
        if not self.cfg.checkpoint_dir:
            return None
        if auto:
            candidates = checkpoint_candidates(self.cfg.checkpoint_dir)
        else:
            path = latest_checkpoint(self.cfg.checkpoint_dir)
            candidates = [path] if path is not None else []
        cursor = None
        load = self.step.store.load_checkpoint if self.step.store is not None \
            else load_checkpoint
        for path in candidates:
            try:
                self.state, cursor = load(path, self.state)
                break
            except IncompatibleCheckpoint as e:
                if not auto:
                    self._log(f"ignoring unusable checkpoint: {e} — starting fresh")
                    return None
                self._fallback_health(path, e)
            except (OSError, ValueError) as e:
                if not auto:
                    raise
                self._fallback_health(path, e)
        if cursor is None:
            return None
        self.epoch = int(cursor.get("epoch", 0))
        cursors = cursor.get("cursors")
        saved_hosts = int(cursor.get("num_hosts", 1))
        if cursors is not None and saved_hosts == self.num_hosts:
            mine = cursors[self.host]
            self._resume_cursor = (int(mine["shard"]), int(mine["offset"]))
        elif cursors is not None:
            self._log(
                f"checkpoint was saved with {saved_hosts} hosts, now "
                f"{self.num_hosts}: shard assignment changed — restarting "
                f"epoch {self.epoch} from the beginning"
            )
            self._resume_cursor = (0, 0)
        else:
            self._resume_cursor = (int(cursor.get("shard", 0)),
                                   int(cursor.get("offset", 0)))
        return cursor

    def _fallback_health(self, path: str, err: BaseException) -> None:
        """One skipped restore candidate (auto mode): a log line and a
        ``health`` row, so the fallback is not a silent rewind."""
        self._log(
            f"resume auto: skipping unusable checkpoint {path} "
            f"({type(err).__name__}: {err}) — falling back to the next "
            "newest complete generation"
        )
        if self.metrics_logger is not None:
            self.metrics_logger.log("health", health_row(
                cause="checkpoint_fallback",
                channel="train",
                silence_seconds=0.0,
                threshold_seconds=0.0,
                detail=f"{os.path.basename(path)}: {type(err).__name__}: {err}",
            ))
