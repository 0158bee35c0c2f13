"""Optimizer protocol (the reference's optim/base.py, on tensors).

An optimizer declares the auxiliary state that accompanies a parameter
table and how a row updates given the consolidated gradient for its
key.  ``update_rows`` is the plain form: it returns new tensors and
runs on any device.  The training step applies the same recurrence in
place over the whole table through K3 (ops/optim.py), whose plain
version calls ``update_rows``.
"""

from __future__ import annotations

from typing import Protocol

import torch


class Optimizer(Protocol):
    name: str

    def init_aux(self, param: torch.Tensor) -> dict[str, torch.Tensor]:
        """Auxiliary state tensors, same shape and device as ``param``."""
        ...

    def update_rows(
        self, rows: dict[str, torch.Tensor], g: torch.Tensor
    ) -> dict[str, torch.Tensor]:
        """Per-row update: ``rows`` maps "param" plus each aux name to
        [U, D] blocks, ``g`` is the consolidated gradient [U, D].  Must
        be well-defined for g=0 and idempotent there."""
        ...
