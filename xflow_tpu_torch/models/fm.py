"""2-way Factorization Machine, forward (reference:
src/model/fm/fm_worker.{h,cc}).

    logit = sum_i w_i x_i + sum_d [ (sum_i v_id x_i)^2 - sum_i v_id^2 x_i^2 ]

The standard FM ½ factor on the interaction term is **absent** in the
reference forward (fm_worker.cc:82,86) and is absent here too.  The
reference's backward is the ½-scaled form; it comes with training.
"""

from __future__ import annotations

import dataclasses

import torch

from xflow_tpu_torch.models.base import BatchArrays, TableSpec
from xflow_tpu_torch.models.blocks import fm_pair_pieces, linear_term, masked_x


@dataclasses.dataclass(frozen=True)
class FMModel:
    v_dim: int = 10  # reference: ftrl.h:16
    v_init_scale: float = 1e-2
    name: str = "fm"
    # the 2-way interaction sums over ALL features (fm_worker.cc:63-86)
    # and never reads slots — compact-wire eligible
    uses_slots = False

    def tables(self) -> list[TableSpec]:
        return [
            TableSpec("w", 1),
            TableSpec(
                "v", self.v_dim, init_kind="normal",
                init_scale=self.v_init_scale,
            ),
        ]

    def logit(self, rows: dict[str, torch.Tensor], batch: BatchArrays) -> torch.Tensor:
        x = masked_x(batch)
        linear = linear_term(rows["w"], x)
        sum_vx, sum_vx2 = fm_pair_pieces(rows["v"], x)
        # No ½ factor: fm_worker.cc:82,86.
        return linear + torch.sum(sum_vx * sum_vx - sum_vx2, dim=-1)
