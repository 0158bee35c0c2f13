"""Training/eval loop (the reference's trainer.py for one host and
one input stream): the worker loop of the reference (LRWorker::train /
batch_training / predict, lr_worker.cc:73-217) as a host loop feeding
the train step on the card.

Each epoch streams every ``prefix-%05d`` train shard (libffm text, or
packed shards from ``python -m xflow_tpu_torch.io.packed``) through the
loader (the native parser when ``native_parser`` and it builds, and
the packer, on a prefetch thread), ships each batch inline over the
step's wire (the dictionary wire by default, decoded on the card by
K6; booked as ``h2d``), and queues the update's kernels
(``dispatch``).  Nothing in the
loop waits for the card: the per-step metrics stay on the device and
are fetched once per epoch (``device_block``), as the reference does
(trainer.py:930-932).  ``evaluate`` streams the test shard(s) through
K1 and reports log-loss and midrank AUC, optionally writing the
reference's ``label\\tpctr`` prediction lines.

With a hot table (``hot_size_log2 > 0``) the trainer first measures
key frequencies over the first ``freq_sample_mib`` of the training
shards and builds the frequency remap (io/freq.py), as the reference's
``_init_remap`` does (trainer.py:430-478), logging how much of the
sampled occurrence mass the H head rows capture; the loaders then
remap and steer every batch, ``prepare_batch`` does the same for an
external batch, and an exported artifact carries the remap.  The
reference reads and writes ``checkpoint_dir/remap.npy``; the port keeps
the remap in memory, since checkpoints are ROADMAP A6.

Not ported yet, and refused by name: checkpoints, resume and the
preemption handler (ROADMAP A6); the profiler, span trace, flight
recorder, watchdog, exporters and chaos failpoints (A14).  The staging
ring (``transfer_ahead_depth``, A10) is not used: the transfer runs
inline.
"""

from __future__ import annotations

import glob
import os
import sys
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.device import resolve_device
from xflow_tpu_torch.io import freq
from xflow_tpu_torch.io.batch import Batch, remap_batch
from xflow_tpu_torch.io.loader import (
    PACKED_MAGIC,
    ShardLoader,
    make_parse_fn,
    parser_name,
)
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.obs import Obs
from xflow_tpu_torch.optim import make_optimizer
from xflow_tpu_torch.parallel.step import TrainStep, init_state
from xflow_tpu_torch.utils.metrics import AucAccumulator


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
        (cfg.checkpoint_dir, "checkpoint_dir: checkpoints, resume, the "
         "preemption handler and a hot model's remap.npy are not ported "
         "yet (ROADMAP A6)"),
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
    """One host, one input stream, one device (the card unless
    ``device="cpu"`` is asked for)."""

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
        self.state = init_state(self.model, self.optimizer, cfg, self.device)
        self.epoch = 0
        self._log = log if log is not None else lambda s: print(s, file=sys.stderr)
        self.host = 0
        self.num_hosts = 1
        # the hot table's frequency remap (io/freq.py), measured from a
        # deterministic sample of the training data
        self.remap: np.ndarray | None = None
        self.hot_mass: float | None = None
        if cfg.hot_size_log2:
            self._init_remap()
        # every step's train log-loss so far, fetched at each epoch end
        self.step_logloss: list[float] = []
        # live loader prefetch iterators, closed by close() so abandoned
        # producer threads never outlive the Trainer
        self._live_prefetch: set = set()
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
        """Stop every live prefetch thread and close the metrics file.
        Idempotent; use the Trainer as a context manager to cover every
        exit."""
        for it in list(self._live_prefetch):
            it.close()
        self._live_prefetch.clear()
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

    def _init_remap(self) -> None:
        """Count key frequencies over the first ``freq_sample_mib`` of
        the GLOBAL shard list and build the remap (the reference's
        ``_init_remap`` without its checkpoint_dir, ROADMAP A6)."""
        cfg = self.cfg
        if not cfg.train_path:
            raise ValueError(
                "hot table enabled but no train_path to sample key "
                "frequencies from and no saved remap in checkpoint_dir"
            )
        shards = find_shards(cfg.train_path)
        with open(shards[0], "rb") as f:
            if f.read(len(PACKED_MAGIC)) == PACKED_MAGIC:
                raise NotImplementedError(
                    f"{shards[0]}: training a hot-table model from packed "
                    "shards is not ported yet: their remap is the one kept "
                    "in checkpoint_dir/remap.npy (ROADMAP A6)"
                )
        counts = freq.count_keys(
            shards, self._parse_fn(), cfg.table_size,
            cfg.freq_sample_mib << 20, cfg.block_mib << 20,
        )
        self.remap = freq.build_remap(counts, cfg.hot_size)
        self.hot_mass = freq.hot_mass(counts, self.remap, cfg.hot_size)
        self._log(
            f"hot remap: {cfg.hot_size} rows capture {self.hot_mass:.1%} of "
            f"sampled feature occurrences"
        )

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

    def iter_train_batches(self) -> Iterator[tuple[Batch, int, int]]:
        """Yields (batch, shard_index, resume_offset) over one epoch;
        each finished shard logs a ``shard`` row with its observed
        loader throughput when metrics are on."""
        depth = self.cfg.prefetch_batches
        workers = self._parse_workers()
        for si, path in enumerate(self._my_shards(self.cfg.train_path)):
            loader = self._loader(path)
            it = self._tracked_prefetch(loader, depth, 0, workers)
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

    def train_epoch(self) -> dict:
        obs = self.obs
        obs.registry.reset()  # epoch-scoped phase accounting
        t0 = time.time()
        steps = 0
        device_metrics = []  # fetched once at epoch end: no sync per step
        it = iter(self.iter_train_batches())
        while True:
            t_step = time.perf_counter()
            try:
                with obs.phase("input_stall"):
                    batch, _, _ = next(it)
            except StopIteration:
                break
            arrays = self.step.put_batch(batch)
            device_metrics.append(self.step.dispatch_train(self.state, arrays))
            obs.observe("step_seconds", time.perf_counter() - t_step)
            steps += 1
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
        return self._epoch_stats(seen, ll_sum, steps, time.time() - t0)

    def _epoch_stats(self, seen: float, ll_sum: float, steps: int, dt: float) -> dict:
        """Epoch record: throughput, per-phase wall seconds, stall
        fraction, step-time percentiles and the ``wire`` row.  `phases`
        holds main-thread-exclusive intervals; `overlapped` holds the
        prefetch thread's parse/pack, which hide behind input_stall."""
        snap = self.obs.registry.snapshot(reset=True)
        phases = snap.phase_seconds()
        overlapped = {
            k: round(phases.pop(k), 6) for k in ("parse", "pack") if k in phases
        }
        phases = {k: round(v, 6) for k, v in phases.items()}
        step_hist = snap.hists.get("step_seconds", {})
        stats = {
            "epoch": self.epoch,
            "examples": seen,
            "steps": steps,
            "train_logloss": ll_sum / max(seen, 1.0),
            "examples_per_sec": seen / max(dt, 1e-9),
            "seconds": dt,
            "checkpoint_seconds": 0.0,
            "preempted": False,
            "phases": phases,
            "overlapped": overlapped,
            "input_stall_frac": round(
                phases.get("input_stall", 0.0) / max(dt, 1e-9), 6
            ),
            "step_time_p50": round(step_hist.get("p50", 0.0), 6),
            "step_time_p90": round(step_hist.get("p90", 0.0), 6),
            "step_time_p99": round(step_hist.get("p99", 0.0), 6),
        }
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
        if "loader.parse_bytes" in snap.counters:
            stats["parse_mb_per_sec"] = round(
                snap.counters["loader.parse_bytes"] / 2**20
                / max(overlapped.get("parse", 0.0), 1e-9),
                2,
            )
        return stats

    def train(self) -> list[dict]:
        """Full training run (reference batch_training loop over epochs,
        lr_worker.cc:179-205, with the epoch banner every 30 at :202)."""
        history = []
        try:
            while self.epoch < self.cfg.epochs:
                stats = self.train_epoch()
                wire_stats = stats.pop("_wire", None)
                history.append(stats)
                if self.metrics_logger is not None:
                    self.metrics_logger.log("train_epoch", stats)
                    if wire_stats is not None:
                        self.metrics_logger.log("wire", wire_stats)
                self._log_device_mem()
                if self.epoch % 30 == 0 or self.epoch == self.cfg.epochs - 1:
                    self._log(
                        f"epoch {self.epoch}: logloss={stats['train_logloss']:.6f} "
                        f"examples/s={stats['examples_per_sec']:.0f}"
                    )
                self.epoch += 1
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
        return history

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
