"""Weights and optimizer state across the two packages.

The reference keeps each table as ``[T, D]`` arrays: ``param`` plus
the optimizer's aux arrays (``n`` and ``z`` for FTRL) in a train
state, ``param`` alone in a ``PredictEngine`` or an artifact.  The
port's state holds the same arrays as tensors on its device; these two
functions carry them across as numpy, so a JAX ``TrainStep`` state
becomes the port's state and back.  The port's gradient buffer ``g``
has no counterpart in the reference and never crosses: a train state
coming in gets it zeroed where its update mode uses one (every mode but
the sparse forms, ``parallel/step.py::uses_grad_buffer``), and a state
going out leaves it behind.  A hot-table model's state has the same
layout (its head is rows [0, H) of each table); its frequency remap
travels beside the state (``Trainer.remap``, an artifact's
``remap.npy``).  The dense (MLP) parameters of wide_deep, dcn and
two_tower cross by name (the reference's pytree keys: ``w1``, ``b1``,
``u_w1``, ``cross_w``, ``w_out``...), as float32 arrays of the same
shapes, in ``state["dense"]`` on both sides.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.models import dense_shapes, make_model
from xflow_tpu_torch.parallel.step import uses_grad_buffer


def state_from_numpy(
    cfg: Config,
    tables: dict[str, Any],
    device: str | torch.device,
    step: int = 0,
    dense: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """The port's state from numpy tables, one per table of ``cfg``'s
    model: each value is a float32 [T, dim] param array, or a dict of
    them (``{"param", "n", "z"}`` from a reference train state).  A
    table given as a dict is a train state's: where ``cfg``'s update
    mode keeps one, it also gets the port's zeroed gradient buffer
    ``g``, which ``TrainStep.train`` needs.
    ``dense`` holds the model's dense parameters by name (exactly its
    own, each of its init's shape; none for a table-only model).
    Refuses a missing, extra or misshapen table or dense parameter.  The
    tensors are copies (``device="cpu"`` included), so the caller's
    arrays are never aliased."""
    model = make_model(cfg)
    specs = model.tables()
    want = {spec.name for spec in specs}
    if set(tables) != want:
        raise ValueError(
            f"model {cfg.model!r} has tables {sorted(want)}, got {sorted(tables)}"
        )
    out = {}
    for spec in specs:
        entry = tables[spec.name]
        if not isinstance(entry, dict):
            entry = {"param": entry}
        if "param" not in entry:
            raise ValueError(f"table {spec.name!r} has no 'param' array")
        shape = (cfg.table_size, spec.dim)
        out[spec.name] = {}
        for key, arr in entry.items():
            arr = np.asarray(arr)
            if arr.shape != shape or arr.dtype != np.float32:
                raise ValueError(
                    f"table {spec.name!r} {key!r} must be float32 {shape}, "
                    f"got {arr.dtype} {arr.shape}"
                )
            out[spec.name][key] = torch.tensor(arr, device=device)
        if isinstance(tables[spec.name], dict) and uses_grad_buffer(cfg):
            out[spec.name]["g"] = torch.zeros(shape, device=device)
    shapes = dense_shapes(model)
    dense = dense or {}
    if set(dense) != set(shapes):
        raise ValueError(f"model {cfg.model!r} has dense parameters {sorted(shapes)}, "
                         f"got {sorted(dense)}")
    dense_out = {}
    for name, arr in dense.items():
        arr = np.asarray(arr)
        if arr.shape != shapes[name] or arr.dtype != np.float32:
            raise ValueError(f"dense {name!r} must be float32 {shapes[name]}, got "
                             f"{arr.dtype} {arr.shape}")
        dense_out[name] = torch.tensor(arr, device=device)
    return {"tables": out, "dense": dense_out, "step": int(step)}


def dense_to_numpy(state: dict[str, Any]) -> dict[str, np.ndarray]:
    """Host copies of a state's dense parameters ({} for a table-only
    model)."""
    return {name: t.detach().cpu().numpy().copy()
            for name, t in state.get("dense", {}).items()}


def state_to_numpy(state: dict[str, Any], aux: bool = False) -> dict[str, Any]:
    """Host copies of a state's tables: ``{name: [T, dim] float32}``
    params, or with ``aux`` ``{name: {"param", <aux>...}}`` (everything
    but the port's gradient buffer ``g``)."""
    out: dict[str, Any] = {}
    for name, t in state["tables"].items():
        if aux:
            out[name] = {
                key: arr.detach().cpu().numpy().copy()
                for key, arr in t.items() if key != "g"
            }
        else:
            out[name] = t["param"].detach().cpu().numpy().copy()
    return out
