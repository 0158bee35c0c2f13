"""Plain SGD (the reference's optim/sgd.py on tensors): push applies
``w -= lr * g`` with lr=0.001 (sgd.h:16,52); pull is an identity read
(the reference's duplicated pull loop, sgd.h:53-57, is not carried)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float = 0.001
    name: str = "sgd"

    def init_aux(self, param: torch.Tensor) -> dict[str, torch.Tensor]:
        return {}

    def update_rows(
        self, rows: dict[str, torch.Tensor], g: torch.Tensor
    ) -> dict[str, torch.Tensor]:
        return {"param": rows["param"] - self.lr * g}
