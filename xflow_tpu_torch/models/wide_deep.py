"""Wide & Deep: sparse linear ("wide") + embedding MLP ("deep") — the
JAX package's models/wide_deep.py.

* Wide: the LR weight table ``w``, updated by the table optimizer.
* Deep: an embedding table ``emb`` [T, emb_dim]; each example's
  embeddings are field-summed into ``max_fields`` buckets
  (``field_sum_tower``), flattened to [max_fields * emb_dim] and fed
  through a 2-layer ReLU MLP whose weights are dense parameters, updated
  by plain SGD at ``sgd_lr`` whatever the table optimizer is.

Gradients are autodiff's (the reference's ``value_and_grad`` of the
softplus loss): on the card K7 (ops/pool.py) pools the tower and sums
the wide term, ``torch.autograd`` differentiates ``head``, and K8
scatters the tower's gradient back to the occurrences.
"""

from __future__ import annotations

import dataclasses

import torch

from xflow_tpu_torch.models.base import AutodiffModel, BatchArrays, TableSpec
from xflow_tpu_torch.models.blocks import (
    field_sum_tower,
    flatten_tower,
    linear_term,
    masked_x,
    mlp_head,
    mlp_head_init,
)


@dataclasses.dataclass(frozen=True)
class WideDeepModel(AutodiffModel):
    emb_dim: int = 8
    hidden: int = 64
    max_fields: int = 32
    v_init_scale: float = 1e-2
    name: str = "wide_deep"

    def tables(self) -> list[TableSpec]:
        return [
            TableSpec("w", 1),
            TableSpec("emb", self.emb_dim, init_kind="normal",
                      init_scale=self.v_init_scale),
        ]

    def dense_init(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        # He init for the ReLU layer, small linear head
        return mlp_head_init(generator, self.max_fields * self.emb_dim, self.hidden)

    def head(self, dense: dict, pooled: torch.Tensor,
             wide: torch.Tensor | None) -> torch.Tensor:
        return wide + mlp_head(dense, flatten_tower(pooled))

    def logit(self, rows: dict[str, torch.Tensor], batch: BatchArrays,
              dense: dict | None = None) -> torch.Tensor:
        assert dense is not None, "wide_deep requires dense MLP params"
        x = masked_x(batch)  # [B, K]
        wide = linear_term(rows["w"], x)
        field_emb = field_sum_tower(rows["emb"], x, batch["slots"], self.max_fields)
        return self.head(dense, field_emb, wide)
