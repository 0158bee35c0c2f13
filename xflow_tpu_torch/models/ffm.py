"""Field-aware Factorization Machine (the JAX package's models/ffm.py,
an extension beyond the C++ reference's LR/FM/MVM).

    logit = sum_i w_i x_i
          + sum_{i<j} < v[k_i, f_j, :], v[k_j, f_i, :] > x_i x_j

Each key holds one latent vector per field: the v table is
[T, max_fields * v_dim], viewed as [T, F, D].  The pair term is the
field-aggregated identity of the reference (no [B, K, K, D] pair
tensors):

    S[b, f1, f2, :] = sum_{i: field(i)=f1, valid} x_i * v[k_i, f2, :]
    pair = 1/2 ( sum_{f1,f2} <S[f1,f2], S[f2,f1]>
                 - sum_i x_i^2 ||v[k_i, f_i]||^2 )

A slot whose field lies outside [0, F) (negative, past max_fields, or
the compact wire's clamped 255) is dropped from the pair term and gets
no v gradient; it still counts in the linear term and gets its w
gradient (the reference's ``masked_x`` against ``x_eff``).

The reference takes FFM's gradient by automatic differentiation
(``value_and_grad``) of ``softplus(logit) - y * logit``
(``AutodiffModel``).  Here it is written out (``grad_logit``), held
against ``torch.autograd`` of ``logit`` and the reference's autodiff
gradient in the tests:

    d logit / d w[k_i]        = x_i
    d logit / d v[k_i, f2, d] = x_eff_i * S[f2, f_i, d]
                                - [f2 == f_i] * x_eff_i^2 * v[k_i, f_i, d]

computed as x_eff_i * (S[f2, f_i, d] - [f2 == f_i] * x_eff_i * v[...]),
autodiff's order: for a slot alone in its field S[f_i, f_i] is exactly
x_eff_i * v[k_i, f_i], so its own-field gradient is exactly 0 there as
in the reference, and FTRL's n' == 0 rule (init kept) sees the same
zeros.

``autodiff = True`` tells the train step that its residual is the
unclamped sigmoid's (ops/train.py).  v opts out of the hot table's path
(``TableSpec.hot=False``, models/base.py).  On the card the forward runs
in K1's FFM form and the forward, backward and scatter in K2's
(csrc/ffm.cuh); ``logit`` and ``grad_logit`` are their plain forms.
"""

from __future__ import annotations

import dataclasses

import torch

from xflow_tpu_torch.models.base import BatchArrays, TableSpec
from xflow_tpu_torch.models.blocks import (
    ffm_field_interaction,
    ffm_field_sums,
    linear_term,
    masked_x,
    valid_fields,
)


@dataclasses.dataclass(frozen=True)
class FFMModel:
    v_dim: int = 4
    max_fields: int = 32
    v_init_scale: float = 1e-2
    name: str = "ffm"
    # each key's v is per field: the wires ship the field planes
    uses_slots = True
    # the reference's AutodiffModel marker: the residual is the
    # gradient of softplus(logit) - y * logit, the unclamped sigmoid's
    autodiff = True

    def tables(self) -> list[TableSpec]:
        return [
            TableSpec("w", 1),
            TableSpec(
                "v", self.max_fields * self.v_dim, init_kind="normal",
                init_scale=self.v_init_scale, hot=False,
            ),
        ]

    def _fields(self, batch: BatchArrays):
        """(masked x, x_eff, clipped field ids, valid) [B, K] each."""
        x = masked_x(batch)
        valid = valid_fields(batch["slots"], batch["mask"], self.max_fields)
        x_eff = torch.where(valid, x, torch.zeros_like(x))
        slot = torch.clamp(batch["slots"], 0, self.max_fields - 1).long()
        return x, x_eff, slot, valid

    def logit(self, rows: dict[str, torch.Tensor], batch: BatchArrays) -> torch.Tensor:
        x, x_eff, slot, valid = self._fields(batch)
        linear = linear_term(rows["w"], x)
        return linear + ffm_field_interaction(
            rows["v"], x_eff, slot, valid, self.max_fields, self.v_dim
        )

    def logit_pairwise(self, rows: dict[str, torch.Tensor], batch: BatchArrays) -> torch.Tensor:
        """The naive O(B*K^2*D) pairwise form (the reference's
        ``logit_pairwise``): the definition ``logit`` must match; a test
        oracle, not for use at scale."""
        b, k = batch["keys"].shape
        f, d = self.max_fields, self.v_dim
        x = batch["vals"] * batch["mask"]
        linear = torch.sum(rows["w"][..., 0] * x, dim=-1)
        v = rows["v"].reshape(b, k, f, d)
        slot = torch.clamp(batch["slots"], 0, f - 1).long()
        valid = (batch["slots"] >= 0) & (batch["slots"] < f) & (batch["mask"] > 0)
        # v_for[b, i, j, :] = v[key_i, field_of_j, :]
        v_for = v[
            torch.arange(b)[:, None, None],
            torch.arange(k)[None, :, None],
            slot[:, None, :],
            :,
        ]  # [B, K(i), K(j), D]
        inter = torch.einsum("bijd,bjid->bij", v_for, v_for)
        xx = x[:, :, None] * x[:, None, :]
        pair_valid = (
            valid[:, :, None]
            & valid[:, None, :]
            & (torch.arange(k)[:, None] < torch.arange(k)[None, :])
        )
        return linear + torch.sum(
            torch.where(pair_valid, inter * xx, torch.zeros_like(inter)), dim=(1, 2)
        )

    def grad_logit(
        self, rows: dict[str, torch.Tensor], batch: BatchArrays
    ) -> dict[str, torch.Tensor]:
        x, x_eff, slot, valid = self._fields(batch)
        b, k = slot.shape
        f, d = self.max_fields, self.v_dim
        s4 = ffm_field_sums(rows["v"], x_eff, slot, valid, f).reshape(b, f, f, d)
        # S[b, f2, f_i, :] for each slot i: [B, K, F (f2), D]
        own = s4.permute(0, 2, 1, 3)[torch.arange(b, device=slot.device)[:, None], slot]
        v4 = rows["v"].reshape(b, k, f, d)
        same = (torch.arange(f, device=slot.device)[None, None, :] == slot[:, :, None])
        xe = x_eff[:, :, None, None]
        # x_eff * (S - own-field x_eff v): the reference's autodiff
        # order, which is exactly 0 for a slot alone in its field
        grad_v = xe * (own - torch.where(same[..., None], v4 * xe, torch.zeros_like(v4)))
        return {"w": x[..., None], "v": grad_v.reshape(b, k, f * d)}
