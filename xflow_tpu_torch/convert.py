"""Weights across the two packages.

The reference keeps each table's parameters as a ``[T, D]`` array
(``PredictEngine.state["tables"][name]["param"]``, or the ``.npy``
shards of an artifact).  The port's state holds the same arrays as
tensors on its device; these two functions carry them across as numpy.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.models import make_model


def state_from_numpy(
    cfg: Config,
    tables: dict[str, np.ndarray],
    device: str | torch.device,
    step: int = 0,
) -> dict[str, Any]:
    """The port's param-only state from numpy tables ``{name: [T, dim]
    float32}``, one per table of ``cfg``'s model; refuses a missing,
    extra or misshapen table.  The tensors are copies (``device="cpu"``
    included), so the caller's arrays are never aliased."""
    specs = make_model(cfg).tables()
    want = {spec.name for spec in specs}
    if set(tables) != want:
        raise ValueError(
            f"model {cfg.model!r} has tables {sorted(want)}, got {sorted(tables)}"
        )
    out = {}
    for spec in specs:
        arr = np.asarray(tables[spec.name])
        shape = (cfg.table_size, spec.dim)
        if arr.shape != shape or arr.dtype != np.float32:
            raise ValueError(
                f"table {spec.name!r} must be float32 {shape}, got "
                f"{arr.dtype} {arr.shape}"
            )
        out[spec.name] = {"param": torch.tensor(arr, device=device)}
    return {"tables": out, "dense": {}, "step": int(step)}


def state_to_numpy(state: dict[str, Any]) -> dict[str, np.ndarray]:
    """``{name: [T, dim] float32}`` host copies of a state's tables."""
    return {
        name: t["param"].detach().cpu().numpy().copy()
        for name, t in state["tables"].items()
    }
