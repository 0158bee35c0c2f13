"""The reference's parallel/step.py for LR and FM: the host wire, the
dense-mode train step and the device scoring call.

The reference jits ``_train_impl`` (step.py:1024-1129) as one XLA
program: expand the wire, gather rows, logit, clamped sigmoid,
residual, per-occurrence gradients, scatter-add into a zeroed [T, D]
buffer per table, then one optimizer pass over every table.  Here
:class:`TrainStep` runs the same step as two hand-written kernels: K2
(ops/train.py) for everything up to the gradient buffers and the
log-loss, then K3 (ops/optim.py) once per table for the optimizer pass.
``_predict_impl`` (step.py:1516) is :class:`PredictStep`'s one K1
launch (ops/score.py), shared by both.

State.  ``{"tables": {name: {"param", <aux>..., "g"}}, "dense": {},
"step": int}``: the reference's layout plus ``g``, the table's gradient
buffer, which the port keeps across steps (K3 clears it) where the
reference allocates a zeroed one per step (step.py:1075-1081).  The
reference donates its state to the jitted step (step.py:402); the port
updates these tensors IN PLACE.

Wires.  The compact wire (hash mode) ships sentinel-coded int32 keys,
``-1`` where the slot is padding, and — for training — uint8 labels and
weights.  The full wire (numeric mode or ``wire_mode="full"``) ships the
same keys plus the masked values ``x = vals * mask`` and float32 labels
and weights.  The reference's dictionary wire (``wire_dedup="auto"``)
decodes, under the default ``cold_consolidate=False``, to the same key
planes as the compact wire, so ``"auto"`` trains over the compact wire
here; ``"on"`` is refused until it is ported (ROADMAP A5).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.io.batch import Batch, narrow_keys_i32
from xflow_tpu_torch.models import PORTED, make_model
from xflow_tpu_torch.obs import Obs
from xflow_tpu_torch.ops.optim import optim_update
from xflow_tpu_torch.ops.score import MAX_DIM, score
from xflow_tpu_torch.ops.train import train_step

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


def init_state(model, optimizer, cfg: Config, device: torch.device) -> State:
    """Fresh tables on ``device`` (the reference's step.py:100-130): each
    table's init (zeros for w, N(0,1) * v_init_scale for v), the
    optimizer's aux tensors, and a zeroed gradient buffer."""
    tables: dict[str, dict[str, torch.Tensor]] = {}
    for i, spec in enumerate(model.tables()):
        param = spec.init(
            cfg.table_size, table_generator(cfg.seed, i, device), device
        )
        tables[spec.name] = {
            "param": param,
            **optimizer.init_aux(param),
            "g": torch.zeros_like(param),
        }
    return {"tables": tables, "dense": {}, "step": 0}


def check_servable(cfg: Config) -> None:
    """Refuse a configuration this port cannot serve yet, naming the
    ROADMAP item that brings it."""
    if cfg.hot_size_log2 > 0:
        raise NotImplementedError(
            f"hot_size_log2={cfg.hot_size_log2}: the hot table (its remap "
            "and hot gather) is not ported yet (ROADMAP A8 / B7)"
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


def check_trainable(cfg: Config) -> None:
    """Refuse a configuration this slice cannot train, naming the
    ROADMAP item that brings it.  A trained model is evaluated through
    K1, so it must be servable first."""
    check_servable(cfg)
    refusals = (
        (cfg.update_mode != "dense",
         f"update_mode={cfg.update_mode!r} is not ported yet (ROADMAP A8)"),
        (cfg.microbatch > 1,
         f"microbatch={cfg.microbatch} is not ported yet (ROADMAP A8)"),
        (cfg.cold_consolidate,
         "cold_consolidate is not ported yet (ROADMAP A8)"),
        (cfg.wire_dedup == "on",
         "wire_dedup='on': the dictionary wire is not ported yet (ROADMAP A5)"),
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


class TrainStep:
    """Wire + device calls for training one (model, optimizer, config,
    device): the dense, microbatch=1 branch of the reference's
    ``_train_impl``.  ``predict`` is PredictStep's K1 call."""

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
        self._compact_validated = False

    @property
    def wire_format(self) -> str:
        return "compact" if self.compact_wire else "full"

    def host_wire_np(self, batch: Batch) -> dict[str, np.ndarray]:
        """The numpy planes the train step ships for ``batch``.  The
        first compact-wire batch is validated (the reference's latch:
        loader batches satisfy the invariants by construction)."""
        if self.compact_wire:
            if not self._compact_validated:
                validate_compact_batch(batch)
                self._compact_validated = True
            return compact_wire_np(batch)
        return {
            "ckeys": sentinel_keys(batch.keys, batch.mask),
            "x": (batch.vals * batch.mask).astype(np.float32),
            "labels": batch.labels.astype(np.float32),
            "weights": batch.weights.astype(np.float32),
        }

    def put_batch(self, batch: Batch, predict: bool = False) -> dict[str, Any]:
        """Host->device transfer, booked as the 'h2d' phase; ``predict``
        ships PredictStep's planes.  A training batch also carries
        ``num_real`` = max(sum(weights), 1) as a host float, so the
        device never syncs for it."""
        with self.obs.phase("h2d"):
            if predict:
                return self.predict_step.put_batch(batch)
            wire = self.host_wire_np(batch)
            self.obs.counter("wire.bytes", sum(int(a.nbytes) for a in wire.values()))
            self.obs.counter("wire.examples", batch.num_real())
            self.obs.counter("wire.batches")
            arrays: dict[str, Any] = {
                k: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for k, a in wire.items()
            }
            arrays["num_real"] = max(float(np.sum(batch.weights)), 1.0)
            return arrays

    def train(self, state: State, arrays: dict[str, Any]) -> dict[str, torch.Tensor]:
        """One step, in place on ``state``: K2 once (gradients into each
        table's ``g``, log-loss and weight sums), then K3 once per table.
        Returns ``{"logloss", "count"}`` as device tensors (no sync)."""
        tables = state["tables"]
        acc = torch.zeros(2, dtype=torch.float32, device=self.device)
        w, v = tables["w"], tables.get("v")
        if "labels_u8" in arrays:
            labels, weights = arrays["labels_u8"], arrays["weights_u8"]
        else:
            labels, weights = arrays["labels"], arrays["weights"]
        train_step(
            arrays["ckeys"], arrays.get("x"), labels, weights,
            arrays["num_real"], w["param"],
            v["param"] if v is not None else None,
            w["g"], v["g"] if v is not None else None, acc,
        )
        for table in tables.values():
            optim_update(table, self.optimizer)
        state["step"] += 1
        return {"logloss": acc[0] / torch.clamp(acc[1], min=1.0), "count": acc[1]}

    def dispatch_train(self, state: State, arrays: dict[str, Any]) -> dict[str, torch.Tensor]:
        """``train`` under the 'dispatch' phase: the launches return as
        soon as they are queued, and the device time surfaces later as
        'device_block' (the epoch-end metrics fetch)."""
        with self.obs.phase("dispatch"):
            return self.train(state, arrays)

    def predict(self, state: State, arrays: dict[str, torch.Tensor]) -> torch.Tensor:
        return self.predict_step.predict(state, arrays)
