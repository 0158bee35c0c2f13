"""Multi-View Machine (reference: src/model/mvm/mvm_worker.{h,cc}, and
the JAX package's models/mvm.py, whose form this is).

Per factor d, v is summed within each field (slot), the factors
1 + slotsum are multiplied across fields, and the products are summed
over factors, CENTRED:

    logit = sum_d [ prod_s (1 + slotsum_sd)  -  1 ]
    grad_v_id = x_i * prod_s(1 + slotsum_sd) / (1 + slotsum_{s(i),d})

The ``1 + sum`` form and the ``- 1`` are the JAX package's intentional
divergence from the C++ reference (whose forward multiplies bare slot
sums): an empty field is a neutral factor 1, and the logit starts at 0
instead of +v_dim.  The gradient is zeroed where the own-field factor's
magnitude is below ``_GUARD_EPS`` (the C++ reference zeroes it,
mvm_worker.cc:156) and for slots outside ``[0, max_fields)``, negative
ones included, which the forward ignores.  MVM uses only the v table
(store 1, mvm_worker.h:38); v rows init N(0,1) * v_init_scale like FM.

On the card the forward runs in K1's MVM form and the forward, backward
and scatter in K2's (csrc/mvm.cuh); ``logit`` and ``grad_logit`` are
their plain forms, held against the reference in the tests.
"""

from __future__ import annotations

import dataclasses

import torch

from xflow_tpu_torch.models.base import BatchArrays, TableSpec
from xflow_tpu_torch.models.blocks import masked_x, mvm_slot_terms

_GUARD_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class MVMModel:
    v_dim: int = 10
    v_init_scale: float = 1e-2
    max_fields: int = 32
    name: str = "mvm"
    # sums v within each field: the wires ship the field planes
    uses_slots = True

    def tables(self) -> list[TableSpec]:
        return [
            TableSpec(
                "v", self.v_dim, init_kind="normal",
                init_scale=self.v_init_scale,
            )
        ]

    def _slot_terms(
        self, rows: dict[str, torch.Tensor], batch: BatchArrays
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(one_plus_slotsum [B, S, D], prod over S [B, D])."""
        return mvm_slot_terms(
            rows["v"], masked_x(batch), batch["slots"], self.max_fields
        )

    def logit(self, rows: dict[str, torch.Tensor], batch: BatchArrays) -> torch.Tensor:
        _, prod = self._slot_terms(rows, batch)
        # centred: the structural +v_dim baseline removed
        return torch.sum(prod - 1.0, dim=-1)

    def grad_logit(
        self, rows: dict[str, torch.Tensor], batch: BatchArrays
    ) -> dict[str, torch.Tensor]:
        x = masked_x(batch)  # [B, K]
        one_plus, prod = self._slot_terms(rows, batch)
        slots = batch["slots"]
        slot_idx = torch.clamp(slots, 0, self.max_fields - 1).long()  # [B, K]
        d = one_plus.shape[-1]
        own = torch.gather(
            one_plus, 1, slot_idx[:, :, None].expand(-1, -1, d)
        )  # [B, K, D]
        guarded = torch.abs(own) < _GUARD_EPS
        safe = torch.where(guarded, torch.ones_like(own), own)
        grad_v = torch.where(
            guarded, torch.zeros_like(own), prod[:, None, :] / safe
        ) * x[..., None]
        # slots outside [0, max_fields) contribute nothing to the
        # forward, so they get no gradient (negative ones included)
        valid = ((slots >= 0) & (slots < self.max_fields))[..., None]
        return {"v": torch.where(valid, grad_v, torch.zeros_like(grad_v))}
