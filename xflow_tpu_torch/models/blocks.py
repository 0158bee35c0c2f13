"""Model blocks: the reference's models/blocks.py pieces that LR, FM
and MVM use, on tensors.

Each body is the reference block's expression, in the same order, so
the plain path and the reference agree up to float rounding of the
same sums.  The field-pooling, FFM and dense blocks come with their
families (ROADMAP A9b, A9c).
"""

from __future__ import annotations

import torch

from xflow_tpu_torch.models.base import BatchArrays


def masked_x(batch: BatchArrays) -> torch.Tensor:
    """Effective feature values: ``vals * mask`` [B, K] — zero for
    padding, the value (1.0 in hash mode) for real entries."""
    return batch["vals"] * batch["mask"]


def linear_term(w_rows: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sparse linear reduction ``sum_i w_i x_i`` [B] over gathered
    [B, K, 1] w rows — LR's whole forward, FM's linear half."""
    return torch.sum(w_rows[..., 0] * x, dim=-1)


def fm_pair_pieces(
    v_rows: torch.Tensor, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """FM second-order pieces over gathered [B, K, D] v rows:
    ``(sum_i v_i x_i, sum_i (v_i x_i)^2)`` both [B, D]
    (fm_worker.cc:63-86's square-of-sum/sum-of-squares identity).  The
    forward combines them WITHOUT the standard ½ factor (reference
    quirk, models/fm.py)."""
    vx = v_rows * x[..., None]  # [B, K, D]
    sum_vx = torch.sum(vx, dim=1)  # [B, D]
    sum_vx2 = torch.sum(vx * vx, dim=1)  # [B, D]
    return sum_vx, sum_vx2


def mvm_slot_terms(
    v_rows: torch.Tensor,
    x: torch.Tensor,
    slots: torch.Tensor,
    num_fields: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MVM per-factor view products: ``(1 + slotsum [B, S, D], prod over
    S [B, D])`` in the consistent 1+sum form (models/mvm.py; the
    reference's blocks.py:186-202).  The reference sums through a
    one-hot [B, K, S] einsum; here each occurrence's v*x is added into
    its row's field by ``index_add_`` (the same sums in another order,
    without the [B, K, S] one-hot: 65,536 x 44 x 39 floats at the
    flagship batch).  A slot outside [0, num_fields) adds nothing (the
    one-hot's all-zero row), and nothing syncs the host."""
    b, k, d = v_rows.shape
    vx = v_rows * x[..., None]  # [B, K, D]
    ok = (slots >= 0) & (slots < num_fields)
    rows = torch.arange(b, device=slots.device)[:, None] * num_fields
    # out-of-range slots land in a dump row past the [B * S] sums
    idx = torch.where(ok, rows + slots.long(), torch.full_like(rows, b * num_fields))
    sums = torch.zeros((b * num_fields + 1, d), dtype=vx.dtype, device=vx.device)
    sums.index_add_(0, idx.reshape(-1), vx.reshape(-1, d))
    slotsum = sums[:-1].view(b, num_fields, d)
    one_plus = 1.0 + slotsum
    prod = torch.prod(one_plus, dim=1)  # [B, D]
    return one_plus, prod
