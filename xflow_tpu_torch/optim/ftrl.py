"""FTRL-proximal, the reference's production optimizer (a copy of the
reference's optim/ftrl.py on tensors).

Exact recurrence of the server push handler (ftrl.h:58-74), per key k
with incoming gradient g:

    n' = n + g^2
    sigma = (sqrt(n') - sqrt(n)) / alpha
    z' = z + g - sigma * w
    w' = 0                                   if |z'| <= lambda1
       = (sign(z')*lambda1 - z') / ((beta + sqrt(n')) / alpha + lambda2)
                                             otherwise

with ``sign(0) = 0``, and ``w' = w`` where ``n' == 0``: a row no
gradient has ever reached keeps its initialization (the reference's
lazy server-side v init, ftrl.h:113-120).  Defaults match ftrl.h:17-20.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FTRL:
    alpha: float = 5e-2
    beta: float = 1.0
    lambda1: float = 5e-5
    lambda2: float = 10.0
    name: str = "ftrl"

    def init_aux(self, param: torch.Tensor) -> dict[str, torch.Tensor]:
        return {"n": torch.zeros_like(param), "z": torch.zeros_like(param)}

    def update_rows(
        self, rows: dict[str, torch.Tensor], g: torch.Tensor
    ) -> dict[str, torch.Tensor]:
        w, n, z = rows["param"], rows["n"], rows["z"]
        n_new = n + g * g
        sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / self.alpha
        z_new = z + g - sigma * w
        shrink = (torch.sign(z_new) * self.lambda1 - z_new) / (
            (self.beta + torch.sqrt(n_new)) / self.alpha + self.lambda2
        )
        w_new = torch.where(
            torch.abs(z_new) <= self.lambda1, torch.zeros_like(shrink), shrink
        )
        # never-touched entries keep their init (module docstring)
        w_new = torch.where(n_new == 0.0, w, w_new)
        return {"param": w_new, "n": n_new, "z": z_new}
