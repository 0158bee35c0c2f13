"""Two-tower retrieval (the JAX package's models/two_tower.py): user and
item towers over disjoint field groups, and their dot as the logit.

Fields ``[0, split_field)`` feed the user tower, ``[split_field,
max_fields)`` the item tower; one shared ``emb`` table (no ``w``), one
field-sum pool over all fields, a 2-layer MLP tower per side with
``tower_dim + 1`` outputs.  The last output is the side's bias, folded
into the dot by augmentation: ``u' = [u, b_u, 1]``, ``i' = [i, 1,
b_i]``, so ``<u', i'> = <u, i> + b_u + b_i`` and the top-k scan stays a
pure dot over ``index_dim = tower_dim + 2`` lanes.

Training and the pooled path are wide&deep's without the wide term
(models/wide_deep.py); serving's top-k runs ``user_embed`` and a scan
over the item index (serve/engine.py).
"""

from __future__ import annotations

import dataclasses

import torch

from xflow_tpu_torch.models.base import AutodiffModel, BatchArrays, TableSpec
from xflow_tpu_torch.models.blocks import (
    dot_interaction,
    field_sum_tower,
    masked_x,
    mlp_tower,
    mlp_tower_init,
)


@dataclasses.dataclass(frozen=True)
class TwoTowerModel(AutodiffModel):
    emb_dim: int = 8
    tower_dim: int = 16
    hidden: int = 64
    max_fields: int = 32
    split_field: int = 16  # fields < split are user-side, >= are item-side
    v_init_scale: float = 1e-2
    name: str = "two_tower"

    def __post_init__(self) -> None:
        if not 0 < self.split_field < self.max_fields:
            raise ValueError(
                f"two_tower split_field {self.split_field} must be in "
                f"(0, max_fields={self.max_fields}): both towers need "
                "at least one field"
            )

    @property
    def index_dim(self) -> int:
        """Serve-time index row width: tower_dim core lanes + the two
        bias lanes."""
        return self.tower_dim + 2

    def tables(self) -> list[TableSpec]:
        return [TableSpec("emb", self.emb_dim, init_kind="normal",
                          init_scale=self.v_init_scale)]

    def dense_init(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        user_in = self.split_field * self.emb_dim
        item_in = (self.max_fields - self.split_field) * self.emb_dim
        # + 1 output lane per tower: the per-side bias
        dense = mlp_tower_init(generator, user_in, self.hidden, self.tower_dim + 1,
                               prefix="u_")
        dense.update(mlp_tower_init(generator, item_in, self.hidden,
                                    self.tower_dim + 1, prefix="i_"))
        return dense

    def tower(self, rows: dict[str, torch.Tensor], batch: BatchArrays) -> torch.Tensor:
        """One shared field pool over all fields [B, F, E]."""
        return field_sum_tower(rows["emb"], masked_x(batch), batch["slots"],
                               self.max_fields)

    def user_from_pooled(self, dense: dict, pooled: torch.Tensor) -> torch.Tensor:
        """[B, tower_dim + 2] augmented user tower ``[u, b_u, 1]``."""
        part = pooled[:, : self.split_field]
        m = mlp_tower(dense, part.reshape(part.shape[0], -1), "u_")
        ones = torch.ones((m.shape[0], 1), dtype=m.dtype, device=m.device)
        return torch.cat([m, ones], dim=-1)  # [u, b_u, 1]

    def item_from_pooled(self, dense: dict, pooled: torch.Tensor) -> torch.Tensor:
        """[B, tower_dim + 2] augmented item tower ``[i, 1, b_i]``."""
        part = pooled[:, self.split_field:]
        m = mlp_tower(dense, part.reshape(part.shape[0], -1), "i_")
        ones = torch.ones((m.shape[0], 1), dtype=m.dtype, device=m.device)
        return torch.cat([m[:, : self.tower_dim], ones, m[:, self.tower_dim:]],
                         dim=-1)  # [i, 1, b_i]

    def user_embed(self, rows: dict[str, torch.Tensor], batch: BatchArrays,
                   dense: dict | None = None) -> torch.Tensor:
        assert dense is not None, "two_tower requires dense tower params"
        return self.user_from_pooled(dense, self.tower(rows, batch))

    def item_embed(self, rows: dict[str, torch.Tensor], batch: BatchArrays,
                   dense: dict | None = None) -> torch.Tensor:
        assert dense is not None, "two_tower requires dense tower params"
        return self.item_from_pooled(dense, self.tower(rows, batch))

    def head(self, dense: dict, pooled: torch.Tensor,
             wide: torch.Tensor | None) -> torch.Tensor:
        # the training logit is the retrieval score: the same dot
        return dot_interaction(self.user_from_pooled(dense, pooled),
                               self.item_from_pooled(dense, pooled))

    def logit(self, rows: dict[str, torch.Tensor], batch: BatchArrays,
              dense: dict | None = None) -> torch.Tensor:
        return dot_interaction(self.user_embed(rows, batch, dense),
                               self.item_embed(rows, batch, dense))
