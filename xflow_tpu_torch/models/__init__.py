"""Model registry: builds a family from a Config.

The port registers the families it has ported; the other reference
families are config-valid (config.py MODEL_FAMILIES) but refused here,
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from xflow_tpu_torch.models.base import Model, TableSpec
from xflow_tpu_torch.models.fm import FMModel
from xflow_tpu_torch.models.lr import LRModel
from xflow_tpu_torch.models.mvm import MVMModel

# family -> ROADMAP item that ports it
UNPORTED = {
    "ffm": "A9b (B10)",
    "wide_deep": "A9c (B11)",
    "two_tower": "A9c (B11)",
    "dcn": "A9c (B11)",
}

PORTED = ("lr", "fm", "mvm")


def make_model(cfg) -> Model:
    # Reference model dispatch: main.cc:27-45, argv[3] '0'→LR '1'→FM
    # '2'→MVM.
    if cfg.model == "lr":
        return LRModel()
    if cfg.model == "fm":
        return FMModel(v_dim=cfg.v_dim, v_init_scale=cfg.v_init_scale)
    if cfg.model == "mvm":
        return MVMModel(v_dim=cfg.v_dim, v_init_scale=cfg.v_init_scale,
                        max_fields=cfg.max_fields)
    if cfg.model in UNPORTED:
        raise NotImplementedError(
            f"model family {cfg.model!r} is not ported to the PyTorch "
            f"package yet (ROADMAP {UNPORTED[cfg.model]}); ported: "
            f"{', '.join(PORTED)}"
        )
    raise ValueError(f"unknown model {cfg.model!r}")


__all__ = ["FMModel", "LRModel", "MVMModel", "Model", "PORTED", "TableSpec",
           "make_model"]
