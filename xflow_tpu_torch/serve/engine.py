"""PredictEngine — the low-latency scoring tier, on PyTorch.

Loads a frozen artifact (serve/artifact.py), written by either package,
or wraps a live trainer state (api.py::XFlow), with no optimizer state:
the engine owns the model's param-only tables on its device and the
predict step.  As in the reference (its serve/engine.py):

* **Shape buckets, one CUDA graph per key.**  Every request batch is
  padded onto a small fixed set of batch-size buckets (default
  1/8/64/512).  Each device call has a key, as the reference keys its
  executables: (leg, ``topk_k``, rows, ``max_nnz``, ``hot_nnz``), the
  shapes of every plane it ships.  ``compile_count`` counts the distinct
  keys run so far, fleet-wide: after ``warm()`` it equals
  ``len(buckets)`` per warmed leg (predict, and top-k with an item index
  attached) and must stay there under any traffic mix and any ``k``.
  On the card each replica captures one CUDA graph per key — the port's
  counterpart of the reference's lower-and-compile per bucket.  The
  planes go into static device buffers that belong to the graph: a call
  copies its planes into the graph's pinned host buffers, then into the
  static ones (``non_blocking``, on the replica's own stream), replays
  the graph and copies the outputs back once.  ``captures`` counts the
  graphs captured and ``graph_replays`` the replays per leg, both summed
  over an engine and its clones; ``graph_launches`` says what one replay
  of each leg launches (the kernel wrappers' launch counts during its
  capture: a replay does not pass through the wrappers).  A capture or a
  replay that fails raises; nothing falls back to eager.  ``graphs=False``
  runs the same legs eagerly on the card (to time the two side by
  side); on the CPU nothing is captured and the plain versions run.
* **Digest-checked identity.**  ``load`` refuses an artifact whose
  manifest digest doesn't match its embedded config, or the caller's
  expected config.

One predict call is one K1 launch (ops/score.py); for wide_deep, dcn
and two_tower one K7 launch (ops/pool.py) and the dense head on
cuBLAS, with the artifact's dense parameters.  A retrieval model
(two_tower) also serves top-k: ``attach_item_index`` puts an item index
[N, index_dim] on the card (``load`` attaches the artifact's own), and
``topk`` runs K7, the user tower and one dot-product scan ``u @
index.T`` per bucket, then a stable descending sort, so tied scores
keep the lower index first as ``lax.top_k`` does.  The engine runs on
the card unless the caller passes ``device="cpu"``
(device.py::resolve_device).  A hot-table model needs its frequency
remap (the artifact's ``remap.npy``): request rows arrive in the raw
hash key space and are remapped and steered into the hot and cold
planes before scoring (io/batch.py::remap_batch), and a hot model
without its remap is refused, as the reference refuses it.

A graph holds the tables' device pointers.  Training writes them in
place (ops/optim.py), so ``update_state`` with the same tensors keeps
the graphs; a state whose tensors were replaced (``Trainer.restore``)
re-captures them.  One thread drives a replica (its MicroBatcher's
worker); a capture runs on a side stream in thread-local capture mode,
so a rollout's candidate captures while the other replicas replay, and
no serving work runs on the legacy default stream.  A model trained
under the tiered store serves from its export, the folded logical
table (serve/artifact.py): the predict step's config copy pins
``store_mode="dense"`` as the reference's does (serve/engine.py:
123-134), while the digest check keeps the artifact's own config.
``apply_delta`` (ROADMAP A12) and a mesh of more than one device (A13)
are refused by name; the failpoints and flight recorder come with
ROADMAP A14.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.device import resolve_device
from xflow_tpu_torch.io.batch import Batch, pad_batch_rows, remap_batch
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.obs import Obs
from xflow_tpu_torch.ops import pool as pool_op
from xflow_tpu_torch.ops import score as score_op
from xflow_tpu_torch.ops.wire import _signed_view
from xflow_tpu_torch.parallel.step import (
    PredictStep,
    check_servable,
    to_device_planes,
    validate_compact_batch,
)

DEFAULT_BUCKETS = (1, 8, 64, 512)
DEFAULT_TOPK = 16

# one capture at a time in the process (the kernel wrappers' launch
# counters are read around each capture)
_CAPTURE_LOCK = threading.Lock()


def _slice_rows(batch: Batch, start: int, stop: int) -> Batch:
    return Batch(
        keys=batch.keys[start:stop],
        slots=batch.slots[start:stop],
        vals=batch.vals[start:stop],
        mask=batch.mask[start:stop],
        labels=batch.labels[start:stop],
        weights=batch.weights[start:stop],
        hot_keys=batch.hot_keys[start:stop],
        hot_slots=batch.hot_slots[start:stop],
        hot_vals=batch.hot_vals[start:stop],
        hot_mask=batch.hot_mask[start:stop],
    )


def _zero_batch(rows: int, k: int, kh: int) -> Batch:
    """An all-padding batch with ``k`` cold and ``kh`` hot slots."""
    def z(n, dtype):
        return np.zeros((rows, n), dtype)

    return Batch(keys=z(k, np.int32), slots=z(k, np.int32), vals=z(k, np.float32),
                 mask=z(k, np.float32), labels=np.zeros(rows, np.float32),
                 weights=np.zeros(rows, np.float32), hot_keys=z(kh, np.int32),
                 hot_slots=z(kh, np.int32), hot_vals=z(kh, np.float32),
                 hot_mask=z(kh, np.float32))


def _launch_counts() -> dict[str, int]:
    """The kernel wrappers' launch counters (K1, K7)."""
    return {"score": score_op.score.launches,
            "field_pool": pool_op.field_pool.launches}


class _GraphStats:
    """Graph counters shared by an engine and its clones."""

    def __init__(self):
        self.lock = threading.Lock()
        self.captures = 0
        self.replays: dict[str, int] = {}
        self.launches: dict[str, dict[str, int]] = {}
        self.capture_launches = dict.fromkeys(_launch_counts(), 0)


class _Graph:
    """One captured leg at one key: the graph, its static device input
    planes (``planes`` under their device names, ``static`` under their
    wire names), their pinned host staging, its outputs and their
    pinned host copies."""

    __slots__ = ("graph", "static", "pinned", "planes", "outputs", "host_out")

    def __init__(self, host: dict[str, np.ndarray], device: torch.device):
        self.graph = torch.cuda.CUDAGraph()
        self.static, self.pinned, self.planes = {}, {}, {}
        # to_device_planes keeps the wire's order, so the names pair up
        cpu = to_device_planes(host, torch.device("cpu"))
        for wire_name, (dev_name, t) in zip(host, cpu.items()):
            self.static[wire_name] = torch.empty_like(t, device=device)
            self.pinned[wire_name] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.planes[dev_name] = self.static[wire_name]
        self.outputs: tuple = ()
        self.host_out: tuple = ()

    def stage(self, host: dict[str, np.ndarray]) -> None:
        """Copy a call's planes into the pinned buffers and enqueue
        their copies into the static ones on the current stream."""
        for name, a in host.items():
            np.copyto(self.pinned[name].numpy(), _signed_view(np.ascontiguousarray(a)))
            self.static[name].copy_(self.pinned[name], non_blocking=True)


class PredictEngine:
    """Bucketed predict over a frozen (or live) model state.

    Construct directly from a state (convert.py::state_from_numpy, or a
    Trainer's live state) or via ``load`` from an exported artifact.
    ``state`` may carry optimizer slots; they are stripped to param-only
    tables.  A hot-table model needs its ``remap`` (io/freq.py)."""

    def __init__(
        self,
        cfg: Config,
        state: dict[str, Any],
        device: str | torch.device = "cuda",
        buckets: Sequence[int] | None = None,
        digest: str | None = None,
        warm: bool = False,
        remap: np.ndarray | None = None,
        obs=None,
        graphs: bool = True,
    ):
        check_servable(cfg)
        if cfg.hot_size_log2 and remap is None:
            raise ValueError(
                "model was trained with a hot table but no remap was "
                "provided — raw request keys cannot be translated"
            )
        self.cfg = cfg
        self.remap = remap
        self.digest = digest if digest is not None else cfg.digest()
        self.device = resolve_device(device)
        self.obs = obs if obs is not None else Obs()
        self.model = make_model(cfg)
        # a tiered artifact holds the folded dense table: the step's
        # config copy serves it as one (self.cfg keeps the digest)
        self.step = PredictStep(self.model, cfg.replace(store_mode="dense"), self.device)
        raw = tuple(buckets) if buckets else DEFAULT_BUCKETS
        if any(b < 1 for b in raw):
            raise ValueError(f"bucket sizes must be >= 1, got {raw}")
        self.buckets = tuple(sorted(set(raw)))
        self.state = self._strip_state(state)
        self._servable_step: int | None = None
        # distinct executable keys run so far: SHARED across ``clone()``
        # replicas, so compile_count counts fleet-wide
        self._keys: set[tuple] = set()
        self._stats = _GraphStats()
        cuda = self.device.type == "cuda"
        self.graphs = bool(graphs) and cuda
        # this replica's graphs, its stream and its graphs' memory pool
        self._graphs: dict[tuple, _Graph] = {}
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        if cuda:  # the tables' uploads land before any side stream reads them
            torch.cuda.synchronize(self.device)
        self.warm_seconds = 0.0
        self._parse_fn = None
        # the serve-time item index (retrieval families): attached by
        # ``load`` from the artifact's item_index.* files or by
        # ``attach_item_index``; ``topk`` refuses until one is
        self.item_index: dict | None = None
        self._index_arr: torch.Tensor | None = None
        self.topk_k = 0
        # {"h2d": s, "execute": s} of the LAST prepared call (the batch
        # span's device split), written and read on the one thread that
        # drives this replica
        self.last_device_phases: dict | None = None
        if warm:
            self.warm()

    @property
    def compile_count(self) -> int:
        return len(self._keys)

    @property
    def captures(self) -> int:
        """Graphs captured by this engine and its clones."""
        return self._stats.captures

    @property
    def graph_replays(self) -> dict[str, int]:
        """Graph replays per leg, by this engine and its clones."""
        with self._stats.lock:
            return dict(self._stats.replays)

    @property
    def graph_launches(self) -> dict[str, dict[str, int]]:
        """Kernel launches one replay of each leg makes."""
        with self._stats.lock:
            return {leg: dict(n) for leg, n in self._stats.launches.items()}

    @property
    def capture_launches(self) -> dict[str, int]:
        """Kernel launches the captures made through the wrappers (each
        capture's eager warm-up and its captured call): on the card, a
        wrapper's count over a serving path is exactly this."""
        with self._stats.lock:
            return dict(self._stats.capture_launches)

    @property
    def servable_step(self) -> int:
        """Train step of the served state."""
        if self._servable_step is None:
            self._servable_step = int(self.state["step"])
        return self._servable_step

    @servable_step.setter
    def servable_step(self, step: int) -> None:
        self._servable_step = int(step)

    @property
    def servable_digest(self) -> str:
        """Identity of the served (config, train step) point
        (serve/artifact.py::servable_digest)."""
        from xflow_tpu_torch.serve.artifact import servable_digest

        return servable_digest(self.digest, self.servable_step)

    def apply_delta(self, directory: str) -> "PredictEngine":
        """Fold an incremental delta export onto this servable: refused
        until ROADMAP A12 ports the continuous-training delta."""
        raise NotImplementedError(
            "apply_delta: incremental delta exports are not ported yet "
            "(ROADMAP A12)"
        )

    # -- construction ------------------------------------------------------

    @classmethod
    def load(
        cls,
        directory: str,
        config: Config | None = None,
        device: str | torch.device = "cuda",
        buckets: Sequence[int] | None = None,
        warm: bool = True,
        topk_k: int | None = None,
        num_devices: int = 1,
        obs=None,
        graphs: bool = True,
    ) -> "PredictEngine":
        """Load an exported artifact onto ``device`` (the card unless
        ``"cpu"`` is asked for), with its dense parameters and, when it
        holds one, its item index (``topk_k`` wide).  ``config``, when
        given, is the caller's expectation: its digest must equal the
        artifact's or the load is refused (never score through the
        wrong model).  ``num_devices`` above 1 (a serving mesh) is
        refused."""
        from xflow_tpu_torch.convert import state_from_numpy
        from xflow_tpu_torch.serve.artifact import (
            load_dense,
            load_item_index,
            load_manifest,
            load_remap,
        )
        from xflow_tpu_torch.utils.checkpoint import RangeReader

        if num_devices > 1:
            raise NotImplementedError(
                f"num_devices={num_devices}: a multi-GPU serving mesh is "
                "not ported yet (ROADMAP A13)"
            )
        dev = resolve_device(device)
        manifest = load_manifest(directory)
        cfg = Config.from_json(manifest["config"])
        digest = manifest["config_digest"]
        if config is not None and config.digest() != digest:
            raise ValueError(
                f"artifact {directory} was exported from config "
                f"{digest}, but the expected config digests to "
                f"{config.digest()} — refusing to serve a mismatched "
                "model"
            )
        check_servable(cfg)  # before reading any table shard
        tables: dict[str, np.ndarray] = {}
        for spec in make_model(cfg).tables():
            key = f"{spec.name}.param"
            meta = manifest["arrays"].get(key)
            if meta is None:
                raise ValueError(f"artifact {directory} missing {key}")
            reader = RangeReader(
                directory, key, tuple(meta["shape"]), np.dtype(meta["dtype"])
            )
            tables[spec.name] = reader.read()
        state = state_from_numpy(cfg, tables, dev, step=manifest["step"],
                                 dense=load_dense(directory, manifest))
        engine = cls(
            cfg, state, device=dev, buckets=buckets, digest=digest, warm=False,
            remap=load_remap(directory, manifest), obs=obs, graphs=graphs,
        )
        index = load_item_index(directory)
        if index is not None:
            engine.attach_item_index(index, topk_k=topk_k)
        if warm:  # after the index attach, so the top-k buckets warm too
            engine.warm()
        return engine

    def clone(self) -> "PredictEngine":
        """A replica over the SAME weights, item index and key set — N
        replicas without N× the table memory.  Each replica gets its own
        PredictStep, stream and graphs, as each is driven by its own
        batcher thread and a graph's static buffers cannot be shared: a
        clone captures every key its source has captured."""
        replica = PredictEngine(
            self.cfg,
            self.state,
            device=self.device,
            buckets=self.buckets,
            digest=self.digest,
            remap=self.remap,
            obs=self.obs,
            graphs=self.graphs,
        )
        replica.state = self.state  # share, don't re-strip
        replica._keys = self._keys
        replica._stats = self._stats
        replica._servable_step = self._servable_step
        replica.warm_seconds = self.warm_seconds
        replica.item_index = self.item_index
        replica._index_arr = self._index_arr
        replica.topk_k = self.topk_k
        for key in list(self._graphs):
            replica._capture(key)
        return replica

    @staticmethod
    def _strip_state(state: dict[str, Any]) -> dict[str, Any]:
        """Param-only view of a (possibly full training) state."""
        return {
            "tables": {
                name: {"param": t["param"]}
                for name, t in state["tables"].items()
            },
            "dense": state.get("dense", {}),
            "step": state.get("step", 0),
        }

    @staticmethod
    def _pointers(state: dict[str, Any]) -> tuple:
        """The device addresses a graph holds of ``state``."""
        ptrs = [(n, t["param"].data_ptr()) for n, t in state["tables"].items()]
        ptrs += [(n, t.data_ptr()) for n, t in state["dense"].items()]
        return tuple(sorted(ptrs))

    def update_state(self, state: dict[str, Any]) -> None:
        """Swap in newer weights of the same shapes (the live trainer
        state after more steps).  Tensors written in place keep this
        replica's graphs; replaced ones re-capture every captured key."""
        new = self._strip_state(state)
        recapture = bool(self._graphs) and (
            self._pointers(new) != self._pointers(self.state))
        if self.device.type == "cuda":  # training's writes land first
            torch.cuda.synchronize(self.device)
        self.state = new
        self._servable_step = None  # re-resolve lazily on next use
        if recapture:
            keys = list(self._graphs)
            self._drop_graphs(keys)
            for key in keys:
                self._capture(key)

    # -- warmup ------------------------------------------------------------

    def warm(self) -> float:
        """Run every bucket once (one all-padding batch each), and with
        an item index attached every top-k bucket too, so every serving
        key has its graph before the first request; returns and records
        the seconds."""
        t0 = time.perf_counter()
        for b in self.buckets:
            self.predict(self._empty_batch(b))
            if self._index_arr is not None:
                self.topk(self._empty_batch(b))
        self.warm_seconds = time.perf_counter() - t0
        return self.warm_seconds

    def _empty_batch(self, rows: int) -> Batch:
        return _zero_batch(rows, self.cfg.max_nnz, 0)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (the largest bucket for oversized
        requests — predict() chunks those)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    # -- device calls ------------------------------------------------------

    def _leg(self, leg: str):
        """The device work of ``leg`` over a dict of planes, as a tuple
        of output tensors."""
        if leg == "predict":
            return lambda arrays: (self.step.predict(self.state, arrays),)
        if leg == "topk":
            index, k = self._index_arr, self.topk_k

            def topk(arrays):
                u = self._tower("topk", arrays)
                scores = u @ index.T  # [B, N]
                vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
                return vals[:, :k].contiguous(), idx[:, :k].contiguous(), u
            return topk
        return lambda arrays: (self._tower("item_embed", arrays),)

    def _tower(self, leg: str, arrays: dict[str, torch.Tensor]) -> torch.Tensor:
        """K7 and a tower (the user tower for ``leg="topk"``, the item
        tower for ``"item_embed"``): [B, index_dim] on the device."""
        pooled, _ = self.step.pool(self.state, arrays)
        tower = (self.model.user_from_pooled if leg == "topk"
                 else self.model.item_from_pooled)
        return tower(self.state["dense"], pooled)

    def _key(self, leg: str, batch: Batch) -> tuple:
        """The reference's executable key (its engine.py:569-571, :733):
        the top-k width rides the top-k and item-tower legs only."""
        k = self.topk_k if leg != "predict" else 0
        return (leg, k, batch.batch_size, batch.max_nnz, batch.hot_nnz)

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _run(self, leg: str, batch: Batch) -> tuple[np.ndarray, ...]:
        """One prepared bucket-sized batch through ``leg``: h2d, the
        replay of its graph (eager on the CPU or with ``graphs=False``)
        and one fetch of the outputs."""
        key = self._key(leg, batch)
        t_call = time.perf_counter()
        host = self.step.host_wire_np(batch)
        if key not in self._keys:
            self._keys.add(key)
            self.obs.counter("serve.compiles")
        if not self.graphs:
            with self._on_stream(), torch.no_grad():
                arrays = to_device_planes(host, self.device)
                t_h2d = time.perf_counter()
                out = tuple(t.cpu().numpy() for t in self._leg(leg)(arrays))
        else:
            g = self._graphs.get(key) or self._capture(key, host)
            with torch.cuda.stream(self._stream):
                g.stage(host)
                t_h2d = time.perf_counter()
                g.graph.replay()
                for dst, src in zip(g.host_out, g.outputs):
                    dst.copy_(src, non_blocking=True)
            self._stream.synchronize()
            out = tuple(h.numpy().copy() for h in g.host_out)
            with self._stats.lock:
                self._stats.replays[leg] = self._stats.replays.get(leg, 0) + 1
        self.last_device_phases = {
            "h2d": t_h2d - t_call,
            "execute": time.perf_counter() - t_h2d,
        }
        return out

    def _drop_graphs(self, keys: list) -> None:
        """Drop this replica's graphs at ``keys``.  With none left their
        memory pool is released, and a released pool cannot take
        another capture: the next capture starts a fresh one."""
        for key in keys:
            del self._graphs[key]
        if self.graphs and not self._graphs:
            self._pool = torch.cuda.graph_pool_handle()

    def _capture(self, key: tuple, host: dict[str, np.ndarray] | None = None) -> _Graph:
        """Capture ``key``'s leg into a CUDA graph on a side stream: one
        eager run there first (it loads the kernels' modules and sizes
        cuBLAS's workspace), then the capture.  Raises on failure."""
        leg, _, rows, k, kh = key
        if host is None:
            host = self.step.host_wire_np(_zero_batch(rows, k, kh))
        g = _Graph(host, self.device)
        fn = self._leg(leg)
        side = torch.cuda.Stream(self.device)
        with _CAPTURE_LOCK:
            try:
                start = _launch_counts()
                with torch.cuda.stream(side), torch.no_grad():
                    g.stage(host)
                    fn(g.planes)
                side.synchronize()
                before = _launch_counts()
                # capture_begin/end, not torch.cuda.graph: that context
                # also synchronizes the whole device (stalling the other
                # replicas' replays), runs gc.collect() and empties the
                # allocator's cache on every capture
                with torch.cuda.stream(side), torch.no_grad():
                    g.graph.capture_begin(pool=self._pool,
                                          capture_error_mode="thread_local")
                    try:
                        g.outputs = fn(g.planes)
                    finally:
                        g.graph.capture_end()
                after = _launch_counts()
            except Exception as e:
                raise RuntimeError(
                    f"CUDA graph capture of {leg} at key {key} failed: {e}"
                ) from e
        g.host_out = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                           for o in g.outputs)
        self._graphs[key] = g
        with self._stats.lock:
            self._stats.captures += 1
            self._stats.launches[leg] = {n: after[n] - before[n] for n in after}
            for n in after:
                self._stats.capture_launches[n] += after[n] - start[n]
        return g

    # -- featurize ---------------------------------------------------------

    def featurize_raw(self, rows: Sequence) -> Batch:
        """A Batch from single-row requests — feed it to ``predict``
        (which pads).  Each row is either a 1-D key array or a
        ``(keys, slots, vals)`` tuple (slots/vals may be None → 0 / 1.0,
        the hash-mode convention).  Features beyond ``max_nnz`` are
        truncated, like the training loader."""
        n = len(rows)
        k = self.cfg.max_nnz
        keys = np.zeros((n, k), np.int32)
        slots = np.zeros((n, k), np.int32)
        vals = np.zeros((n, k), np.float32)
        mask = np.zeros((n, k), np.float32)
        for i, row in enumerate(rows):
            if isinstance(row, tuple):
                rk, rs, rv = row
            else:
                rk, rs, rv = row, None, None
            rk = np.asarray(rk)
            m = min(len(rk), k)
            keys[i, :m] = rk[:m]
            if rs is not None:
                slots[i, :m] = np.asarray(rs)[:m]
            vals[i, :m] = 1.0 if rv is None else np.asarray(rv)[:m]
            mask[i, :m] = 1.0
        return Batch(
            keys=keys, slots=slots, vals=vals, mask=mask,
            labels=np.zeros(n, np.float32),
            weights=np.ones(n, np.float32),
        )

    def featurize(self, rows: Sequence) -> Batch:
        """``featurize_raw`` + widen + pad to the covering bucket: the
        Batch is ready for ``predict_prepared`` (the batcher's featurize
        leg).  ``rows`` must fit the largest bucket."""
        n = len(rows)
        if n > self.buckets[-1]:
            raise ValueError(
                f"featurize: {n} rows exceed the largest bucket "
                f"{self.buckets[-1]} — use predict(featurize_raw(rows))"
            )
        return pad_batch_rows(
            self._prepare(self.featurize_raw(rows)), self.bucket_for(n)
        )

    def score_text(self, lines: Iterable[str]) -> np.ndarray:
        """pctr for libffm-format text lines (``label\\tfgid:fid:val``,
        label ignored) — the CLI ``score`` path.  Parses with the
        artifact config's hashing and seed."""
        from xflow_tpu_torch.io.batch import pack_batch
        from xflow_tpu_torch.io.loader import make_parse_fn

        if self._parse_fn is None:
            cfg = self.cfg
            self._parse_fn = make_parse_fn(cfg.table_size, cfg.hash_mode, cfg.seed)
        data = "".join(
            line if line.endswith("\n") else line + "\n" for line in lines
        ).encode()
        block = self._parse_fn(data)
        n = block.num_samples
        if n == 0:
            return np.zeros(0, np.float32)
        out = []
        cap = self.buckets[-1]
        for s in range(0, n, cap):
            e = min(s + cap, n)
            raw = pack_batch(block, s, e, e - s, self.cfg.max_nnz)
            out.append(self.predict(raw))
        return np.concatenate(out)

    # -- retrieval: item index + top-k --------------------------------------

    def attach_item_index(self, index: dict, topk_k: int | None = None) -> None:
        """Arm the top-k mode with an item index (serve/artifact.py::
        load_item_index's dict, or any dict with ``item_index`` [N, D]
        and ``item_ids`` [N]): the scan operand goes to the device once;
        ``topk_k`` fixes the result width (DEFAULT_TOPK, capped at N)."""
        if not hasattr(self.model, "user_embed"):
            raise ValueError(
                f"model {self.cfg.model!r} has no user tower "
                "(models/__init__.py registry: retrieval=False) — "
                "top-k retrieval needs a two-tower-factored family"
            )
        emb = np.asarray(index["item_index"], np.float32)
        if emb.ndim != 2 or not len(emb):
            raise ValueError(f"item index must be [N, index_dim], got {emb.shape}")
        want = self.model.index_dim
        if emb.shape[1] != want:
            raise ValueError(
                f"item index rows are {emb.shape[1]} wide but model "
                f"{self.cfg.model!r} scans {want} lanes (tower_dim "
                f"{self.cfg.tower_dim} + 2 bias lanes) — the index was "
                "exported from a different tower geometry; re-run "
                "export_item_index"
            )
        self.item_index = dict(index)
        self.item_index["ids_order"] = np.argsort(np.asarray(index["item_ids"]),
                                                  kind="stable")
        self._index_arr = torch.tensor(emb, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.topk_k = min(topk_k if topk_k is not None else DEFAULT_TOPK, len(emb))
        if self.topk_k < 1:
            raise ValueError("topk_k must be >= 1")
        # graphs of the old index or width hold its pointer: drop them
        self._drop_graphs([k for k in self._graphs if k[0] != "predict"])

    def topk_prepared(self, batch: Batch) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(item_ids [B, topk_k], scores [B, topk_k], user_emb [B, D])
        for one already-prepared bucket-sized batch: K7, the user
        tower, the scan against the index, a stable descending sort (a
        tie keeps the lower index first, as ``lax.top_k``)."""
        if self._index_arr is None:
            raise ValueError(
                "top-k refused: no item index attached — export one "
                "with serve.artifact.export_item_index (retrieval "
                "families only) or attach_item_index(...)"
            )
        vals, idx, u = self._run("topk", batch)
        return self.item_index["item_ids"][idx], vals, u

    def topk(self, batch: Batch, k: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """(item_ids [B, k], scores [B, k]) for an externally built
        raw-key-space batch of user-side features.  Any batch size
        (padded and chunked like ``predict``); any ``k <= topk_k``
        slices the one result width, so mixed-k traffic adds no key."""
        kk = self.topk_k if k is None else int(k)
        if kk < 1 or kk > self.topk_k:
            raise ValueError(
                f"k={kk} outside (0, topk_k={self.topk_k}] — the "
                "engine serves ONE top-k width; raise topk_k at "
                "load/attach time for deeper candidate sets"
            )
        n = batch.batch_size
        batch = self._prepare(batch)
        cap = self.buckets[-1]
        ids_out, score_out = [], []
        for s in range(0, n, cap):
            e = min(s + cap, n)
            chunk = pad_batch_rows(_slice_rows(batch, s, e), self.bucket_for(e - s))
            ids, vals, _ = self.topk_prepared(chunk)
            ids_out.append(ids[: e - s, :kk])
            score_out.append(vals[: e - s, :kk])
        return np.concatenate(ids_out), np.concatenate(score_out)

    def item_embeddings(self, rows: Sequence) -> np.ndarray:
        """Item-tower embeddings [len(rows), index_dim] for
        featurize_raw-protocol catalog rows: export_item_index's compute
        leg, bucket-chunked."""
        if not hasattr(self.model, "item_embed"):
            raise ValueError(
                f"model {self.cfg.model!r} has no item tower "
                "(registry: retrieval=False)"
            )
        cap = self.buckets[-1]
        out = []
        for s in range(0, len(rows), cap):
            chunk = rows[s:s + cap]
            b = pad_batch_rows(self._prepare(self.featurize_raw(chunk)),
                               self.bucket_for(len(chunk)))
            out.append(self._run("item_embed", b)[0][: len(chunk)])
        return np.concatenate(out)

    # -- predict -----------------------------------------------------------

    def _prepare(self, batch: Batch) -> Batch:
        """Canonicalize an external raw-key-space batch: widen it so its
        total feature width (hot + cold) matches the training geometry's
        ``max_nnz`` with zero-mask columns (no new shapes), then apply
        the hot remap and steering (a no-op without a hot table).
        Wider batches keep their width (truncating would silently drop
        features) and run one extra key per distinct width (counted in
        ``serve.noncanonical_shape``) — the featurize tier only produces
        canonical widths."""
        cfg = self.cfg
        if batch.hot_nnz and not cfg.hot_size:
            raise ValueError(
                "batch carries hot planes but the model has no hot table"
            )
        total = batch.hot_nnz + batch.max_nnz
        if total > cfg.max_nnz:
            self.obs.counter("serve.noncanonical_shape")
        if total < cfg.max_nnz:
            pad = cfg.max_nnz - total
            b = batch.batch_size
            z_i = np.zeros((b, pad), np.int32)
            z_f = np.zeros((b, pad), np.float32)
            batch = Batch(
                keys=np.concatenate([batch.keys, z_i], axis=1),
                slots=np.concatenate([batch.slots, z_i], axis=1),
                vals=np.concatenate([batch.vals, z_f], axis=1),
                mask=np.concatenate([batch.mask, z_f], axis=1),
                labels=batch.labels,
                weights=batch.weights,
                hot_keys=batch.hot_keys,
                hot_slots=batch.hot_slots,
                hot_vals=batch.hot_vals,
                hot_mask=batch.hot_mask,
            )
        return remap_batch(batch, self.remap, cfg.hot_size, cfg.hot_nnz)

    def predict(self, batch: Batch) -> np.ndarray:
        """pctr for one externally built Batch.  Any batch size: rows
        pad up to the smallest covering bucket; oversized batches chunk
        by the largest bucket.  Returns exactly ``batch.batch_size``
        values."""
        n = batch.batch_size
        batch = self._prepare(batch)
        cap = self.buckets[-1]
        if n <= cap:
            padded = pad_batch_rows(batch, self.bucket_for(n))
            return self.predict_prepared(padded)[:n]
        out = []
        for s in range(0, n, cap):
            e = min(s + cap, n)
            chunk = pad_batch_rows(
                _slice_rows(batch, s, e), self.bucket_for(e - s)
            )
            out.append(self.predict_prepared(chunk)[: e - s])
        return np.concatenate(out)

    def predict_prepared(self, batch: Batch) -> np.ndarray:
        """Run one already-prepared, bucket-sized batch on the device;
        returns pctr for every row (padding included).  This is the
        'device' leg of the batcher's latency accounting: h2d + execute
        + fetch."""
        if self.step.compact_wire:
            # serving traffic is heterogeneous: validate every batch, or
            # a value-carrying request would score with vals=1
            validate_compact_batch(batch)
        return self._run("predict", batch)[0]
