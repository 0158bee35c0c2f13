"""Deep & Cross ranker (the JAX package's models/dcn.py):

    x_0     = flattened field-pooled embedding tower  [B, P]
    x_{l+1} = x_0 * (x_l . w_l) + b_l + x_l           (cross stack)
    h       = ReLU(x_0 W1 + b1)                       (deep half)
    logit   = wide + [x_L ; h] W_out + b_out

The tables (``w``, ``emb``) and the dense-parameter path are
wide&deep's (models/wide_deep.py): K7 pools, the head runs under
``torch.autograd``, K8 scatters back, dense SGD at ``sgd_lr``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from xflow_tpu_torch.models.base import AutodiffModel, BatchArrays, TableSpec
from xflow_tpu_torch.models.blocks import (
    cross_network,
    field_sum_tower,
    flatten_tower,
    linear_term,
    masked_x,
)


@dataclasses.dataclass(frozen=True)
class DCNModel(AutodiffModel):
    emb_dim: int = 8
    hidden: int = 64
    cross_layers: int = 2
    max_fields: int = 32
    v_init_scale: float = 1e-2
    name: str = "dcn"

    def __post_init__(self) -> None:
        if self.cross_layers < 1:
            raise ValueError(
                f"dcn cross_layers {self.cross_layers} must be >= 1 "
                "(0 layers is wide&deep — use that family)"
            )

    def tables(self) -> list[TableSpec]:
        return [
            TableSpec("w", 1),
            TableSpec("emb", self.emb_dim, init_kind="normal",
                      init_scale=self.v_init_scale),
        ]

    def dense_init(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        p = self.max_fields * self.emb_dim

        def normal(shape, scale):
            return torch.randn(shape, generator=generator, dtype=torch.float32) * scale

        # cross weights start small (each layer perturbs the identity
        # path x_l + ...); biases zero; He for the ReLU deep half
        return {
            "cross_w": normal((self.cross_layers, p), math.sqrt(1.0 / p)),
            "cross_b": torch.zeros((self.cross_layers, p), dtype=torch.float32),
            "w1": normal((p, self.hidden), math.sqrt(2.0 / p)),
            "b1": torch.zeros(self.hidden, dtype=torch.float32),
            "w_out": normal((p + self.hidden, 1), math.sqrt(1.0 / (p + self.hidden))),
            "b_out": torch.zeros(1, dtype=torch.float32),
        }

    def head(self, dense: dict, pooled: torch.Tensor,
             wide: torch.Tensor | None) -> torch.Tensor:
        x0 = flatten_tower(pooled)  # [B, P]
        xc = cross_network(x0, dense["cross_w"], dense["cross_b"])
        h = torch.relu(x0 @ dense["w1"] + dense["b1"])
        out = (torch.cat([xc, h], dim=-1) @ dense["w_out"] + dense["b_out"])[:, 0]
        return wide + out

    def logit(self, rows: dict[str, torch.Tensor], batch: BatchArrays,
              dense: dict | None = None) -> torch.Tensor:
        assert dense is not None, "dcn requires dense cross/MLP params"
        x = masked_x(batch)  # [B, K]
        wide = linear_term(rows["w"], x)
        pooled = field_sum_tower(rows["emb"], x, batch["slots"], self.max_fields)
        return self.head(dense, pooled, wide)
