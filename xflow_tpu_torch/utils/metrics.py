"""The reference's clamped sigmoid (base.h:54-63), on tensors.

x < -30 → 1e-6, x > 30 → 1.0, else 1/(1+exp(-x)).  The clamp is
asymmetric on purpose: it is the reference's, and scores have to match
it.  Logloss and the AUCs come with training (ROADMAP A3).
"""

from __future__ import annotations

import torch


def sigmoid_ref(x: torch.Tensor) -> torch.Tensor:
    p = 1.0 / (1.0 + torch.exp(-x))
    p = torch.where(x < -30.0, torch.full_like(p, 1e-6), p)
    p = torch.where(x > 30.0, torch.ones_like(p), p)
    return p
