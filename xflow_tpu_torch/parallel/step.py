"""The predict half of the reference's parallel/step.py: the host wire
and the device scoring call.

The reference's ``TrainStep._predict_impl`` (step.py:1516) expands the
wire, gathers rows, takes the model's logit and the clamped sigmoid as
one jitted program.  Here :class:`PredictStep` ships the same compact
wire and hands it to K1 (ops/score.py), which does all four in one
kernel launch.  Training (``TrainStep``) comes with ROADMAP A3.

Wires.  The compact wire (hash mode) ships sentinel-coded int32 keys,
``-1`` where the slot is padding.  The full wire (numeric mode or
``wire_mode="full"``) ships the same keys plus the masked values
``x = vals * mask``; predict reads nothing else, so labels, weights and
slots stay on the host.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.io.batch import Batch, narrow_keys_i32
from xflow_tpu_torch.ops.score import score

# {"tables": {name: {"param": [T, D] tensor}}, "dense": {}, "step": int}
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
