"""Model blocks: the reference's models/blocks.py pieces that LR, FM,
MVM and FFM use, on tensors.

Each body is the reference block's expression, in the same order, so
the plain path and the reference agree up to float rounding of the
same sums.  The field-pooling and dense blocks come with their
families (ROADMAP A9c).
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


def valid_fields(
    slots: torch.Tensor, mask: torch.Tensor, num_fields: int
) -> torch.Tensor:
    """Bool [B, K]: the entry is real AND its field id is in
    [0, num_fields) — the shared out-of-range-field drop semantics
    (negative or oversized field ids contribute nothing)."""
    return (slots >= 0) & (slots < num_fields) & (mask > 0)


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


def ffm_field_sums(
    v_rows: torch.Tensor,
    x_eff: torch.Tensor,
    slot: torch.Tensor,
    valid: torch.Tensor,
    num_fields: int,
) -> torch.Tensor:
    """FFM's field-aggregated sums ``S[b, f1, f2*D + d] = sum over the
    slots i of field f1 of x_eff_i * v[k_i, f2, d]`` [B, F, E], E = F*D,
    from the flat [B, K, E] gathered v plane: the first half of the
    reference's ``ffm_field_interaction`` (its one-hot of each slot's own
    field, zero for invalid slots, and the batch matmul over K)."""
    f = num_fields
    onehot = (
        (slot[:, :, None] == torch.arange(f, device=slot.device)[None, None, :])
        & valid[:, :, None]
    ).to(v_rows.dtype)  # [B, K, F]
    vx = v_rows * x_eff[:, :, None]  # [B, K, E]
    return torch.einsum("bkf,bke->bfe", onehot, vx)  # [B, F, E]


def ffm_field_interaction(
    v_rows: torch.Tensor,
    x_eff: torch.Tensor,
    slot: torch.Tensor,
    valid: torch.Tensor,
    num_fields: int,
    v_dim: int,
) -> torch.Tensor:
    """FFM pairwise term via the field-aggregated identity (models/ffm.py
    docstring): ``v_rows`` is the flat [B, K, F*D] gathered v plane,
    ``x_eff`` the validity-zeroed values, ``slot`` the [0, F)-clipped
    field ids.  Returns the [B] interaction ½(cross − diag)."""
    b, k = slot.shape
    f, d = num_fields, v_dim
    vx = v_rows * x_eff[:, :, None]  # [B, K, E]
    s = ffm_field_sums(v_rows, x_eff, slot, valid, f)  # [B, F, E]
    # cross term sum_{f1,f2,d} S[b,f1,f2,d] * S[b,f2,f1,d]
    s4 = s.reshape(b, f, f, d)
    cross = torch.sum(s4 * s4.permute(0, 2, 1, 3), dim=(1, 2, 3))
    # subtract the i == i diagonal: x_i^2 * ||v[k_i, f_i, :]||^2,
    # selecting each key's own-field block of E elementwise
    eslot = (torch.arange(f * d, device=slot.device) // d).to(slot.dtype)  # [E]
    emask = eslot[None, None, :] == slot[:, :, None]  # [B, K, E]
    diag = torch.sum(torch.where(emask, vx * vx, torch.zeros_like(vx)), dim=(1, 2))
    return 0.5 * (cross - diag)
