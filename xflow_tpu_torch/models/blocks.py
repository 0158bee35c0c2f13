"""Model blocks: the reference's models/blocks.py pieces that LR and
FM use, on tensors.

Each body is the reference block's expression, in the same order, so
the plain path and the reference agree up to float rounding of the
same sums.  The field-pooling, MVM, FFM and dense blocks come with
their families (ROADMAP A9).
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
