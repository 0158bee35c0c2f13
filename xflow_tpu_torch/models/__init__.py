"""Model registry: builds a family from a Config (the reference's
models/__init__.py:111-147 registrations).  Every family of config.py's
MODEL_FAMILIES is ported."""

from __future__ import annotations

from xflow_tpu_torch.models.base import AutodiffModel, Model, TableSpec
from xflow_tpu_torch.models.dcn import DCNModel
from xflow_tpu_torch.models.ffm import FFMModel
from xflow_tpu_torch.models.fm import FMModel
from xflow_tpu_torch.models.lr import LRModel
from xflow_tpu_torch.models.mvm import MVMModel
from xflow_tpu_torch.models.two_tower import TwoTowerModel
from xflow_tpu_torch.models.wide_deep import WideDeepModel

PORTED = ("lr", "fm", "mvm", "ffm", "wide_deep", "two_tower", "dcn")


def dense_shapes(model) -> dict[str, tuple[int, ...]]:
    """The model's dense parameters by name and shape ({} for a
    table-only family): what its ``dense_init`` draws."""
    import torch

    if not hasattr(model, "dense_init"):
        return {}
    return {k: tuple(t.shape)
            for k, t in model.dense_init(torch.Generator().manual_seed(0)).items()}


def make_model(cfg) -> Model:
    # Reference model dispatch: main.cc:27-45, argv[3] '0'→LR '1'→FM
    # '2'→MVM; the extensions by name.
    if cfg.model == "lr":
        return LRModel()
    if cfg.model == "fm":
        return FMModel(v_dim=cfg.v_dim, v_init_scale=cfg.v_init_scale)
    if cfg.model == "mvm":
        return MVMModel(v_dim=cfg.v_dim, v_init_scale=cfg.v_init_scale,
                        max_fields=cfg.max_fields)
    if cfg.model == "ffm":
        return FFMModel(v_dim=cfg.ffm_v_dim, max_fields=cfg.max_fields,
                        v_init_scale=cfg.v_init_scale)
    if cfg.model == "wide_deep":
        return WideDeepModel(emb_dim=cfg.emb_dim, hidden=cfg.hidden_dim,
                             max_fields=cfg.max_fields, v_init_scale=cfg.v_init_scale)
    if cfg.model == "two_tower":
        return TwoTowerModel(emb_dim=cfg.emb_dim, tower_dim=cfg.tower_dim,
                             hidden=cfg.hidden_dim, max_fields=cfg.max_fields,
                             split_field=cfg.tower_split_field,
                             v_init_scale=cfg.v_init_scale)
    if cfg.model == "dcn":
        return DCNModel(emb_dim=cfg.emb_dim, hidden=cfg.hidden_dim,
                        cross_layers=cfg.cross_layers, max_fields=cfg.max_fields,
                        v_init_scale=cfg.v_init_scale)
    raise ValueError(f"unknown model {cfg.model!r}")


__all__ = ["AutodiffModel", "DCNModel", "FFMModel", "FMModel", "LRModel", "MVMModel",
           "Model", "PORTED", "TableSpec", "TwoTowerModel", "WideDeepModel",
           "dense_shapes", "make_model"]
