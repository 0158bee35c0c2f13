"""B7, the hot head's gather and scatter, as plain PyTorch functions of
the reference's contract (xflow_tpu/ops/hot.py).

On a TPU the reference replaces per-slice DMA for table rows [0, H)
with two-level one-hot matmuls (``hot_gather``, ops/hot.py:71;
``hot_scatter``, :122), because its gather pays per slice and its
matrix unit does not.  On the card the head is just rows [0, H) of the
same table: a hot occurrence is an ordinary row read and its gradient
an ordinary atomic add, so K1 (csrc/score.cu) and K2 (csrc/train.cu)
read and scatter the hot plane in the same pass as the cold one.  What
the port keeps is the contract, which these functions state and which
the plain versions of K1 and K2 call:

* ``hot_gather(w_hot, keys)``: row ``keys[i]`` of the [H, D] head for
  keys in [0, H), a zero row otherwise; exact in float32.  Under
  ``impl="mxu"`` with ``dtype=torch.bfloat16`` the head is rounded to
  bfloat16 (round to nearest even, as XLA's ``astype``) first
  (ops/hot.py:104).
* ``hot_scatter(keys, grads, H)``: the per-occurrence gradients [M, D]
  summed into a zeroed [H, D] float32 buffer by key, keys outside
  [0, H) dropped.  Under ``"mxu"`` + bfloat16 each gradient is rounded
  to bfloat16 before the float32 sum (ops/hot.py:166-170).
* ``"seg"`` ignores ``dtype``, as the reference's does.

The reference's one-hot matmuls sum in another order than an indexed
add; the results agree to float rounding.  ``hot_factors`` is the
reference's split H = h1 * h2, kept for parity (the port has no
matmul to shape with it).
"""

from __future__ import annotations

import torch

IMPLS = ("seg", "mxu")


def hot_factors(hot_size: int) -> tuple[int, int]:
    """Split H = h1 * h2 with h1 >= h2, both powers of two (the
    reference's level-1 contraction and level-2 select widths)."""
    log2 = hot_size.bit_length() - 1
    if hot_size != 1 << log2:
        raise ValueError(f"hot_size must be a power of two, got {hot_size}")
    h1 = 1 << ((log2 + 1) // 2)
    return h1, hot_size // h1


def rounds_to_bf16(impl: str, dtype) -> bool:
    """Whether the contract rounds the head and the hot gradients to
    bfloat16: only the one-hot ("mxu") form with a bfloat16 dtype."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "mxu" and dtype == torch.bfloat16


def to_bf16_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bfloat16 (nearest even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def hot_gather(w_hot: torch.Tensor, keys: torch.Tensor, *,
               dtype=torch.float32, impl: str = "mxu") -> torch.Tensor:
    """[M, D] rows of the [H, D] head ``w_hot`` for int keys [M]; keys
    outside [0, H) give zero rows."""
    h = w_hot.shape[0]
    if rounds_to_bf16(impl, dtype):
        w_hot = to_bf16_f32(w_hot)
    rows = w_hot[keys.long().clamp(0, h - 1)]
    ok = (keys >= 0) & (keys < h)
    return torch.where(ok[:, None], rows, torch.zeros_like(rows)).to(torch.float32)


def hot_scatter(keys: torch.Tensor, grads: torch.Tensor, hot_size: int, *,
                dtype=torch.float32, impl: str = "mxu") -> torch.Tensor:
    """[H, D] float32 sums of the per-occurrence ``grads`` [M, D] by
    key; keys outside [0, H) are dropped."""
    g = grads.to(torch.float32)
    if rounds_to_bf16(impl, dtype):
        g = to_bf16_f32(g)
    seg = torch.where((keys >= 0) & (keys < hot_size), keys.long(),
                      torch.full_like(keys.long(), hot_size))
    out = torch.zeros((hot_size + 1, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, seg, g)[:hot_size]
