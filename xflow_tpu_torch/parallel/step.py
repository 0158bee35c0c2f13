"""The reference's parallel/step.py for LR and FM: the host wire, the
train step in every update mode but the hot table's, and the device
scoring call.

The reference jits ``_train_impl`` (step.py:1024-1129) as one XLA
program.  Here :class:`TrainStep` runs each of its update modes as a
short sequence of hand-written kernels:

* dense (step.py:1070-1129): K2 (ops/train.py: gather, logit, clamped
  sigmoid, residual, per-occurrence gradients scattered into the
  table's [T, D] buffer ``g``, log-loss) over the whole batch, then K3
  (ops/optim.py) once per table over the whole table.  Dense mode with
  ``microbatch > 1`` (the reference's scan over interleaved slices,
  step.py:1085-1121) or ``cold_consolidate`` (``_scatter_grads`` with a
  plan, step.py:984-990) computes this same update: on a TPU those
  forms bound the [B, K, D] intermediates and the scatter's cost, but
  K2 is fused and builds no intermediates, so here they run this step;
* sparse (step.py:1053-1066, ``_sparse_update`` 1158-1248 without hot
  planes, ``_apply_touched_rows`` 1143-1156): K4 (ops/sparse.py: the
  batch's unique keys and each occurrence's slot), K2 in index mode
  (gradients summed per unique key into ``gsum`` [M, D]), and K5 per
  table (FTRL or SGD on the touched rows only).  The state holds no
  [T, D] gradient buffer;
* sequential (``_train_sequential``, step.py:1250-1325): the batch's
  interleaved slices (``_interleaved_slices``, step.py:264-277: example
  i → slice i % s) in order, each a whole update at its own
  ``num_real`` with the dense inner (K2 + K3) or the sparse inner (K4 +
  K2 + K5), so slice k reads the tables as slice k-1 left them.  The
  hot inner needs the hot table (ROADMAP A8b).

``_predict_impl`` (step.py:1516) is :class:`PredictStep`'s one K1 launch
(ops/score.py), shared by all.

State.  ``{"tables": {name: {"param", <aux>..., "g"}}, "dense": {},
"step": int}``: the reference's layout plus ``g``, the table's gradient
buffer, which the port keeps across steps (K3 clears it) where the
reference allocates a zeroed one per step (step.py:1075-1081); the
sparse modes keep none (:func:`uses_grad_buffer`).  The per-slice
consolidation buffers (K4's slot map, unique keys and slots, and one
``gsum`` per table) belong to the TrainStep, are allocated once at the
largest slice's size and are left zeroed and the map at -1 by K5.  The
reference donates its state to the jitted step (step.py:402); the port
updates these tensors IN PLACE.

Wires.  The compact wire (hash mode) ships sentinel-coded int32 keys,
``-1`` where the slot is padding, and — for training — uint8 labels and
weights.  The full wire (numeric mode or ``wire_mode="full"``) ships the
same keys plus the masked values ``x = vals * mask`` and float32 labels
and weights.  The dictionary wire (``wire_dedup="auto"`` or ``"on"``,
hash mode on one device: :func:`dict_wire_ok`) compacts each batch on
the host (io/compact.py::CompactBatch) and ships its tiered planes;
K6 (ops/wire.py) decodes them on the card, inside ``put_batch``, into
the compact wire's planes, so every update mode and ``predict`` run on
the compact wire's planes unchanged.  ``evaluate``'s batches take the
same wire as training's, as in the reference.  The reference's
dictionary decode also ships a consolidation plan for dense
``cold_consolidate``; the port runs that mode as the plain dense step
(K2 builds no [B, K, D] intermediates), so the plan is not decoded.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.io.batch import Batch, narrow_keys_i32
from xflow_tpu_torch.io.compact import CompactBatch
from xflow_tpu_torch.models import PORTED, make_model
from xflow_tpu_torch.obs import Obs
from xflow_tpu_torch.ops.optim import optim_update
from xflow_tpu_torch.ops.score import MAX_DIM, score
from xflow_tpu_torch.ops.sparse import consolidate_keys, touched_update
from xflow_tpu_torch.ops.train import train_step
from xflow_tpu_torch.ops.wire import dict_decode, to_device

# {"tables": {name: {"param": [T, D], <aux>, "g"}}, "dense": {}, "step": int}
State = dict[str, Any]


def validate_compact_batch(batch: Batch) -> None:
    """Compact-wire invariants: binary features (val 1 wherever mask 1)
    and 0/1 labels/weights.  A value-carrying batch on the compact wire
    would silently score with vals=1."""
    if not np.array_equal(batch.vals * batch.mask, batch.mask):
        raise ValueError(
            "compact wire requires binary features (val 1 wherever "
            "mask 1); set wire_mode='full' for value-carrying batches"
        )
    for arr in (batch.labels, batch.weights):
        if not np.isin(arr, (0.0, 1.0)).all():
            raise ValueError(
                "compact wire requires 0/1 labels and weights; set "
                "wire_mode='full'"
            )


def sentinel_keys(keys: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """int32 keys with -1 on padding slots.  Narrowed THROUGH the
    audited choke point: masked lanes are zeroed in the wide dtype first
    (padding may carry unreduced garbage, and only live keys owe the
    range contract), then the sentinel is applied in int32 space."""
    live = narrow_keys_i32(np.where(mask > 0, keys, 0))
    return np.where(mask > 0, live, np.int32(-1))


def compact_wire_np(batch: Batch) -> dict[str, np.ndarray]:
    """The host half of the compact wire (the reference's
    ``compact_wire_np`` for slot-free models without a hot table):
    sentinel-coded int32 keys + uint8 labels/weights."""
    return {
        "ckeys": sentinel_keys(batch.keys, batch.mask),
        "labels_u8": batch.labels.astype(np.uint8),
        "weights_u8": batch.weights.astype(np.uint8),
    }


class PredictStep:
    """Wire + device call for one (model, config, device)."""

    def __init__(self, model, cfg: Config, device: torch.device):
        self.model = model
        self.cfg = cfg
        self.device = device
        # Compact wire eligibility (Config.wire_mode): binary vals (hash
        # mode); slot-reading models would also need max_fields <= 255.
        uses_slots = bool(getattr(model, "uses_slots", True))
        compact_ok = cfg.hash_mode and not (uses_slots and cfg.max_fields > 255)
        if cfg.wire_mode == "compact" and not compact_ok:
            raise ValueError(
                "wire_mode='compact' requires hash_mode (binary vals) "
                "and, for slot-reading models, max_fields <= 255; model "
                f"{model.name!r} / hash_mode={cfg.hash_mode} / "
                f"max_fields={cfg.max_fields} does not qualify"
            )
        self.compact_wire = cfg.wire_mode != "full" and compact_ok

    def host_wire_np(self, batch: Batch) -> dict[str, np.ndarray]:
        """The numpy planes predict ships for ``batch``."""
        if self.compact_wire:
            return {"ckeys": compact_wire_np(batch)["ckeys"]}
        return {
            "ckeys": sentinel_keys(batch.keys, batch.mask),
            "x": (batch.vals * batch.mask).astype(np.float32),
        }

    def put_batch(self, batch: Batch) -> dict[str, torch.Tensor]:
        """Host->device transfer of the predict wire."""
        return {
            k: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for k, a in self.host_wire_np(batch).items()
        }

    def predict(self, state: State, arrays: dict[str, torch.Tensor]) -> torch.Tensor:
        """pctr [B] per example (reference calculate_pctr,
        lr_worker.cc:46-61): one K1 launch on the card."""
        tables = state["tables"]
        v = tables["v"]["param"] if "v" in tables else None
        return score(arrays["ckeys"], arrays.get("x"), tables["w"]["param"], v)


def table_generator(seed: int, index: int, device: torch.device) -> torch.Generator:
    """The init stream of table ``index``: one generator per table, from
    ``(seed, index)`` (the reference folds the index into its PRNG key,
    step.py:114)."""
    mixed = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, index])
    return torch.Generator(device=device).manual_seed(
        int(mixed.generate_state(1, dtype=np.uint64)[0])
    )


def sparse_update(cfg: Config) -> bool:
    """Whether the optimizer touches only the rows a batch (or slice)
    uses: ``update_mode="sparse"``, or sequential mode's sparse inner."""
    return cfg.update_mode == "sparse" or (
        cfg.update_mode == "sequential" and cfg.sequential_inner == "sparse"
    )


def uses_grad_buffer(cfg: Config) -> bool:
    """Whether a train state keeps the [T, D] gradient buffer ``g``: the
    dense forms do; the sparse update allocates none, as the reference
    allocates none (memory-budget.json's ``_train_impl`` entry)."""
    return not sparse_update(cfg)


def init_state(model, optimizer, cfg: Config, device: torch.device) -> State:
    """Fresh tables on ``device`` (the reference's step.py:100-130): each
    table's init (zeros for w, N(0,1) * v_init_scale for v), the
    optimizer's aux tensors, and a zeroed gradient buffer where the
    update mode uses one."""
    tables: dict[str, dict[str, torch.Tensor]] = {}
    for i, spec in enumerate(model.tables()):
        param = spec.init(
            cfg.table_size, table_generator(cfg.seed, i, device), device
        )
        tables[spec.name] = {"param": param, **optimizer.init_aux(param)}
        if uses_grad_buffer(cfg):
            tables[spec.name]["g"] = torch.zeros_like(param)
    return {"tables": tables, "dense": {}, "step": 0}


def check_servable(cfg: Config) -> None:
    """Refuse a configuration this port cannot serve yet, naming the
    ROADMAP item that brings it."""
    if cfg.hot_size_log2 > 0:
        raise NotImplementedError(
            f"hot_size_log2={cfg.hot_size_log2}: the hot table (its remap "
            "and hot gather) is not ported yet (ROADMAP A8b / B7)"
        )
    if cfg.store_mode == "tiered":
        raise NotImplementedError(
            "store_mode='tiered' is not ported yet (ROADMAP A11)"
        )
    if cfg.model not in PORTED:
        make_model(cfg)  # raises NotImplementedError naming the item
    if cfg.model == "fm" and cfg.v_dim > MAX_DIM:
        raise NotImplementedError(
            f"v_dim={cfg.v_dim} exceeds the scoring kernel's register "
            f"capacity {MAX_DIM} (csrc/score.cu kMaxDim)"
        )


def dict_wire_ok(cfg: Config, uses_slots: bool) -> bool:
    """The reference's dictionary-wire eligibility (step.py:353-366):
    the compact-wire invariants, one device, u8 per-row counts and hot
    ids that fit the tiered encoding.  The port trains on one device:
    ``num_devices`` 0 (all of them) is its one card, and more than one
    is refused (ROADMAP A13)."""
    kh = cfg.hot_nnz if cfg.hot_size else 0
    compact_ok = cfg.hash_mode and not (uses_slots and cfg.max_fields > 255)
    return (
        compact_ok
        and cfg.num_devices <= 1
        and cfg.max_nnz <= 255
        and kh <= 255
        and (not cfg.hot_size_log2 or cfg.hot_size_log2 <= 16)
    )


def check_trainable(cfg: Config) -> None:
    """Refuse a configuration this slice cannot train, naming the
    ROADMAP item that brings it, and ``wire_dedup="on"`` where the
    reference refuses it.  A trained model is evaluated through K1, so
    it must be servable first."""
    check_servable(cfg)
    refusals = (
        (cfg.update_mode == "sequential" and cfg.sequential_inner == "hot",
         "sequential_inner='hot' needs the hot table, which is not ported "
         "yet (ROADMAP A8b)"),
        (cfg.num_devices > 1,
         f"num_devices={cfg.num_devices}: multi-GPU training is not ported "
         "yet (ROADMAP A13)"),
        (cfg.input_streams > 1,
         f"input_streams={cfg.input_streams}: the input fan-out is not "
         "ported yet (ROADMAP A10)"),
    )
    for refused, why in refusals:
        if refused:
            raise NotImplementedError(why)
    if cfg.wire_dedup == "on" and not dict_wire_ok(cfg, make_model(cfg).uses_slots):
        raise ValueError(
            "wire_dedup='on' requires the compact-wire invariants "
            "(hash_mode; max_fields <= 255 for slot models), a "
            "single-process single-device mesh, max_nnz/hot_nnz "
            "<= 255, and hot_size_log2 <= 16"
        )


class TrainStep:
    """Wire + device calls for training one (model, optimizer, config,
    device) in the configured update mode (module docstring).
    ``predict`` is PredictStep's K1 call."""

    def __init__(self, model, optimizer, cfg: Config, device: torch.device,
                 obs: Obs | None = None):
        check_trainable(cfg)
        self.model = model
        self.optimizer = optimizer
        self.cfg = cfg
        self.device = device
        self.obs = obs if obs is not None else Obs()
        self.predict_step = PredictStep(model, cfg, device)
        self.compact_wire = self.predict_step.compact_wire
        self.dict_wire = (
            cfg.wire_mode != "full"
            and cfg.wire_dedup != "off"
            and dict_wire_ok(cfg, model.uses_slots)
        )
        self._compact_validated = False
        # sequential slices (Config guarantees that the microbatch
        # divides the batch); the dense forms take the batch whole
        self.slices = cfg.microbatch if cfg.update_mode == "sequential" else 1
        self.sparse = sparse_update(cfg)
        self._scratch: dict[str, Any] = {}

    @property
    def wire_format(self) -> str:
        return "dict" if self.dict_wire else "compact" if self.compact_wire else "full"

    def _dict_geometry_ok(self, batch) -> bool:
        """A batch rides the dictionary wire only at the loader's
        geometry; other widths keep the compact wire."""
        return batch.max_nnz == self.cfg.max_nnz and batch.hot_nnz == 0

    def precompact(self, batch):
        """Host dictionary compaction ahead of ``put_batch`` (off the
        consumer thread, for an input fan-out): the CompactBatch
        ``put_batch`` would build, or the batch unchanged where the
        dictionary wire does not apply.  The planes are exactly the
        inline path's."""
        if (isinstance(batch, CompactBatch) or not self.dict_wire
                or not self._dict_geometry_ok(batch)):
            return batch
        cb = CompactBatch.from_batch(batch, self.cfg.table_size, 0,
                                     check=not self._compact_validated)
        self._compact_validated = True
        return cb

    def host_wire_np(self, batch, predict: bool = False):
        """The numpy planes that cross the link for ``batch`` (a Batch,
        or a CompactBatch from a packed-v2 shard) under this step's
        wire, and the CompactBatch when the dictionary wire ran (else
        None).  ``predict`` ships PredictStep's planes on the other
        wires.  The first batch is validated (the reference's latch:
        loader batches satisfy the invariants by construction)."""
        check = not self._compact_validated
        self._compact_validated = True
        if isinstance(batch, CompactBatch):
            if self.dict_wire and self._dict_geometry_ok(batch):
                return batch.wire(ship_slots=False), batch
            batch = batch.expand()
        if self.dict_wire and self._dict_geometry_ok(batch):
            # LR and FM read no slots, so none ship
            cb = CompactBatch.from_batch(batch, self.cfg.table_size, 0, check=check)
            return cb.wire(ship_slots=False), cb
        if predict:
            return self.predict_step.host_wire_np(batch), None
        if self.compact_wire:
            if check:
                validate_compact_batch(batch)
            return compact_wire_np(batch), None
        return {
            "ckeys": sentinel_keys(batch.keys, batch.mask),
            "x": (batch.vals * batch.mask).astype(np.float32),
            "labels": batch.labels.astype(np.float32),
            "weights": batch.weights.astype(np.float32),
        }, None

    def slice_order(self, b: int) -> np.ndarray:
        """Row order that makes the reference's interleaved slices
        (example i → slice i % s, step.py:264-277) contiguous: slice k is
        rows [k*b/s, (k+1)*b/s) of the reordered planes."""
        s = self.slices
        if b % s:
            raise ValueError(f"microbatch {s} must divide the batch's {b} rows")
        return np.arange(b).reshape(b // s, s).T.reshape(-1)

    def _sliced(self, batch) -> Batch:
        """``batch`` with its rows in ``slice_order``, for the dictionary
        wire to compact: each sequential slice of the decoded planes is
        then a contiguous view."""
        if isinstance(batch, CompactBatch):
            batch = batch.expand()
        order = self.slice_order(batch.batch_size)
        return Batch(keys=batch.keys[order], slots=batch.slots[order],
                     vals=batch.vals[order], mask=batch.mask[order],
                     labels=batch.labels[order], weights=batch.weights[order])

    def _book_wire(self, wire: dict[str, np.ndarray], examples: int,
                   cb: CompactBatch | None) -> None:
        """The counters behind the trainer's ``wire`` row (the
        reference's ``_book_wire``): bytes across the link, examples,
        batches, and on the dictionary wire the cold occurrences and the
        table rows they touch after host dedup."""
        self.obs.counter("wire.bytes", sum(int(a.nbytes) for a in wire.values()))
        self.obs.counter("wire.examples", examples)
        self.obs.counter("wire.batches")
        if cb is not None:
            self.obs.counter("wire.cold_occ", cb.n_cold)
            self.obs.counter("wire.cold_touched", cb.cold_touched)

    def put_batch(self, batch, predict: bool = False) -> dict[str, Any]:
        """Host->device transfer of ``batch`` (a Batch or a CompactBatch),
        booked as the 'h2d' phase and in the wire counters, for training
        or (``predict``) for K1.  On the dictionary wire K6 decodes the
        shipped planes here, so the result holds the compact wire's
        planes whatever the wire.  A training batch also carries
        ``num_real`` = max(sum(weights), 1) as a host float, so the
        device never syncs for it.  With sequential slices its rows are
        reordered (the Batch before the dictionary wire compacts it, the
        planes of the other wires), and ``slice_num_real`` holds each
        slice's max(sum(weights), 1)."""
        with self.obs.phase("h2d"):
            sliced = self.slices > 1 and not predict
            dict_batch = self.dict_wire and self._dict_geometry_ok(batch)
            if sliced and dict_batch:
                batch = self._sliced(batch)
            wire, cb = self.host_wire_np(batch, predict)
            self._book_wire(wire, batch.num_real(), cb)
            weights = batch.weights
            if sliced and not dict_batch:
                order = self.slice_order(len(weights))
                wire = {k: a[order] for k, a in wire.items()}
                weights = weights[order]
            if cb is not None:
                planes = dict_decode(to_device(wire, self.device), self.cfg.max_nnz)
                arrays: dict[str, Any] = dict(zip(("ckeys", "labels_u8", "weights_u8"),
                                                  planes))
            else:
                arrays = {
                    k: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                    for k, a in wire.items()
                }
            if predict:
                return {k: arrays[k] for k in ("ckeys", "x") if k in arrays}
            arrays["num_real"] = max(float(np.sum(weights)), 1.0)
            if self.slices > 1:
                per = weights.reshape(self.slices, -1).sum(axis=1, dtype=np.float64)
                arrays["slice_num_real"] = [max(float(w), 1.0) for w in per]
            return arrays

    def train(self, state: State, arrays: dict[str, Any]) -> dict[str, torch.Tensor]:
        """One step, in place on ``state``, in the configured update mode
        (module docstring).  Returns ``{"logloss", "count"}`` as device
        tensors (no sync): the log-loss and weight sums over every slice,
        ``logloss = sum / max(count, 1)``."""
        tables = state["tables"]
        # float64: every K2 launch of the step adds its block partials here
        acc = torch.zeros(2, dtype=torch.float64, device=self.device)
        if self.slices > 1:
            # sequential: each slice is a whole update at its own num_real
            rows = arrays["ckeys"].shape[0] // self.slices
            for k, num_real in enumerate(arrays["slice_num_real"]):
                view = {name: a[k * rows:(k + 1) * rows] for name, a in arrays.items()
                        if isinstance(a, torch.Tensor)}
                self._update(tables, view, num_real, acc)
        else:
            self._update(tables, arrays, arrays["num_real"], acc)
        state["step"] += 1
        return {"logloss": acc[0] / torch.clamp(acc[1], min=1.0), "count": acc[1]}

    def _update(self, tables: dict, view: dict, num_real: float,
                acc: torch.Tensor) -> None:
        """One optimizer application over ``view`` (the batch, or one
        sequential slice), every gradient divided by ``num_real``: the
        touched-rows form (K4, K2 in index mode, K5 per table), or the
        dense form (K2 into ``g``, then K3 per table)."""
        if self.sparse:
            self._touched_rows(tables, view, num_real, acc)
            return
        self._k2(tables, view, num_real, acc, {n: t["g"] for n, t in tables.items()})
        for table in tables.values():
            optim_update(table, self.optimizer)

    def _k2(self, tables: dict, view: dict, num_real: float, acc: torch.Tensor,
            grads: dict, slots: torch.Tensor | None = None) -> None:
        w, v = tables["w"], tables.get("v")
        if "labels_u8" in view:
            labels, weights = view["labels_u8"], view["weights_u8"]
        else:
            labels, weights = view["labels"], view["weights"]
        train_step(
            view["ckeys"], view.get("x"), labels, weights, num_real,
            w["param"], v["param"] if v is not None else None,
            grads["w"], grads.get("v"), acc, slots=slots,
        )

    def _touched_rows(self, tables: dict, view: dict, num_real: float,
                      acc: torch.Tensor) -> None:
        """K4 over the view's keys, K2 in index mode into the per-table
        ``gsum``, then K5 per table: the optimizer on the touched rows.
        The last table's K5 resets the slot map."""
        keys = view["ckeys"]
        scratch = self._buffers(tables, keys.numel())
        m = keys.numel()
        slots = scratch["slots"][:m].view(keys.shape)
        ukeys, count = scratch["ukeys"][:m], scratch["count"]
        consolidate_keys(keys, self.cfg.table_size, ukeys, count, slots,
                         scratch["slot_map"])
        gsum = {n: g[:m] for n, g in scratch["gsum"].items()}
        self._k2(tables, view, num_real, acc, gsum, slots=slots)
        names = list(tables)
        for name in names:
            touched_update(
                tables[name], self.optimizer, ukeys, count, gsum[name],
                scratch["slot_map"] if name == names[-1] else None,
            )

    def _buffers(self, tables: dict, m: int) -> dict[str, Any]:
        """The consolidation buffers for up to ``m`` occurrences, grown
        (never shrunk) on demand: the zeroed ``gsum`` [M, D] per table,
        K4's unique keys, count and slots, and (on the card) the slot map
        [T] at -1.  K5 leaves ``gsum`` zeroed and the map at -1."""
        sc = self._scratch
        if sc.get("cap", 0) < m:
            dev = self.device
            sc["cap"] = m
            sc["gsum"] = {n: torch.zeros((m, t["param"].shape[1]), device=dev)
                          for n, t in tables.items()}
            sc["ukeys"] = torch.empty(m, dtype=torch.int32, device=dev)
            sc["slots"] = torch.empty(m, dtype=torch.int32, device=dev)
            sc["count"] = torch.zeros(1, dtype=torch.int32, device=dev)
            if "slot_map" not in sc:
                sc["slot_map"] = (
                    torch.full((self.cfg.table_size,), -1, dtype=torch.int32,
                               device=dev)
                    if dev.type == "cuda" else None
                )
        return sc

    def dispatch_train(self, state: State, arrays: dict[str, Any]) -> dict[str, torch.Tensor]:
        """``train`` under the 'dispatch' phase: the launches return as
        soon as they are queued, and the device time surfaces later as
        'device_block' (the epoch-end metrics fetch)."""
        with self.obs.phase("dispatch"):
            return self.train(state, arrays)

    def predict(self, state: State, arrays: dict[str, torch.Tensor]) -> torch.Tensor:
        return self.predict_step.predict(state, arrays)
