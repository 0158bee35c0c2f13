"""Model protocol: a score over gathered sparse rows.

A model declares its parameter tables (the reference's "stores": LR
uses store 0 (w) only, FM stores 0+1 (w, v) — server.h:23-28,
lr_worker.h:38, fm_worker.h:37-38) and provides, for a batch whose rows
are already gathered to [B, K, D] blocks:

* ``logit(rows, batch) -> [B]`` — the pre-sigmoid score;
* ``grad_logit(rows, batch) -> {table: [B, K, D]}`` — d logit / d row
  entry, per occurrence.

Gradients are explicit, not autodiff, because the reference's FM
backward is *not* the true gradient of its forward (fm_worker.cc:82 vs
:140-142).  FFM is the reference's first ``AutodiffModel`` (its step
takes the autodiff gradient of ``softplus(logit) - y * logit``): the port writes
that gradient out as FFM's ``grad_logit`` and marks the model
``autodiff = True``, which makes the train step's residual the
unclamped sigmoid's (ops/train.py).  On the card the forward runs fused in K1 (ops/score.py) and
the forward + backward + scatter in K2 (ops/train.py); ``logit`` and
``grad_logit`` are their plain forms, held against the reference in the
tests.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol

import torch

# Batch as a dict of tensors: keys/slots/vals/mask [B,K], labels/weights [B].
BatchArrays = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TableSpec:
    name: str
    dim: int  # row width (1 for w; v_dim for latent factors)
    # Row-init distribution: "zeros" for w tables; "normal" is
    # N(0,1)*init_scale per entry (the reference's lazy server-side v
    # init, ftrl.h:113-120, drawn eagerly as the reference's
    # parallel/step.py::init_state does).
    init_kind: str = "zeros"  # {"zeros", "normal"}
    init_scale: float = 0.0
    # Whether the table's hot-plane rows take the hot table's path (the
    # reference's TableSpec.hot, models/base.py:48).  FFM's 156-wide v
    # opts out: its hot occurrences are plain float32 row reads and
    # writes of rows [0, H), so ``hot_dtype="bfloat16"`` never rounds
    # them, and the hot inner is refused for such a model.
    hot: bool = True

    def init(
        self,
        rows: int,
        generator: torch.Generator,
        device: torch.device,
    ) -> torch.Tensor:
        """A fresh float32 [rows, dim] table on ``device``.  The normal
        draw comes from ``generator`` (a device generator): it cannot
        reproduce the reference's JAX PRNG, so only its distribution
        matches the reference's."""
        shape = (rows, self.dim)
        if self.init_kind == "zeros":
            return torch.zeros(shape, dtype=torch.float32, device=device)
        if self.init_kind == "normal":
            t = torch.randn(
                shape, generator=generator, dtype=torch.float32, device=device
            )
            return t.mul_(self.init_scale)
        raise ValueError(f"unknown init_kind {self.init_kind!r}")


class Model(Protocol):
    name: str

    def tables(self) -> list[TableSpec]:
        ...

    def logit(self, rows: dict[str, torch.Tensor], batch: BatchArrays) -> torch.Tensor:
        ...

    def grad_logit(
        self, rows: dict[str, torch.Tensor], batch: BatchArrays
    ) -> dict[str, torch.Tensor]:
        ...
