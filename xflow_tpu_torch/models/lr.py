"""Sparse logistic regression, forward (reference:
src/model/lr/lr_worker.{h,cc}).

wx[b] = sum of the gathered w entries times the feature values
(lr_worker.cc:121-143; the value is 1.0 in hash mode).
"""

from __future__ import annotations

import torch

from xflow_tpu_torch.models.base import BatchArrays, TableSpec
from xflow_tpu_torch.models.blocks import linear_term, masked_x


class LRModel:
    name = "lr"
    # never reads batch["slots"] — eligible for the compact wire
    uses_slots = False

    def tables(self) -> list[TableSpec]:
        # w entries are zero-initialized server-side in the reference
        # (ftrl.h:50-53 default-constructed map entries).
        return [TableSpec("w", 1)]

    def logit(self, rows: dict[str, torch.Tensor], batch: BatchArrays) -> torch.Tensor:
        return linear_term(rows["w"], masked_x(batch))
