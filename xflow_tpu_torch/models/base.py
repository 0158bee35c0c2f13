"""Model protocol: a score over gathered sparse rows.

A model declares its parameter tables (the reference's "stores": LR
uses store 0 (w) only, FM stores 0+1 (w, v) — server.h:23-28,
lr_worker.h:38, fm_worker.h:37-38) and provides, for a batch whose rows
are already gathered to [B, K, D] blocks, ``logit(rows, batch) -> [B]``.

This slice ports the forward only.  The explicit per-occurrence
gradients (``grad_logit``: the reference's FM backward is not the true
gradient of its forward, fm_worker.cc:82 vs :140-142) come with
training, ROADMAP A3/A9.  On the serving path the forward runs fused in
ops/score.py; ``logit`` is its plain form, held against the reference
in the tests.
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
    # init, ftrl.h:113-120).  Serving loads weights and never draws
    # them; training's init (ROADMAP A3) reads these.
    init_kind: str = "zeros"  # {"zeros", "normal"}
    init_scale: float = 0.0


class Model(Protocol):
    name: str

    def tables(self) -> list[TableSpec]:
        ...

    def logit(self, rows: dict[str, torch.Tensor], batch: BatchArrays) -> torch.Tensor:
        ...
