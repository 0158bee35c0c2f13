"""Evaluation metrics (a copy of the reference's utils/metrics.py):
the clamped sigmoid and log-loss on tensors, the AUCs in numpy.

* ``sigmoid_ref``: x < -30 → 1e-6, x > 30 → 1.0, else 1/(1+exp(-x))
  (base.h:54-63).  The clamp is asymmetric on purpose: it is the
  reference's, and scores have to match it.
* ``logloss`` / ``logloss_sum``: natural-log negative log-likelihood
  with probabilities clipped to [eps, 1-eps] (the reference's own
  divergence from base.h:97-98, per its SURVEY quirks ledger).
* ``auc_rank_sum`` is the reference algorithm (base.h:84-110);
  ``auc_midrank`` (midrank ties) is the REPORTING metric, which
  ``AucAccumulator`` computes.
"""

from __future__ import annotations

import numpy as np
import torch

LOGLOSS_EPS = 1e-6


def sigmoid_ref(x: torch.Tensor) -> torch.Tensor:
    p = 1.0 / (1.0 + torch.exp(-x))
    p = torch.where(x < -30.0, torch.full_like(p, 1e-6), p)
    p = torch.where(x > 30.0, torch.ones_like(p), p)
    return p


def logloss(
    labels: torch.Tensor, pctr: torch.Tensor, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Weighted mean negative log-likelihood (natural log)."""
    if weights is None:
        return logloss_sum(labels, pctr, torch.ones_like(pctr)) / pctr.numel()
    denom = torch.clamp(torch.sum(weights), min=1.0)
    return logloss_sum(labels, pctr, weights) / denom


def logloss_sum(
    labels: torch.Tensor, pctr: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Weighted SUM of negative log-likelihood (the accumulator form)."""
    p = torch.clamp(pctr, LOGLOSS_EPS, 1.0 - LOGLOSS_EPS)
    ll = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    return torch.sum(ll * weights)


def auc_rank_sum(labels: np.ndarray, pctr: np.ndarray) -> float:
    """Reference rank-sum AUC (base.h:84-110).  Returns NaN when all
    labels are one class (the reference prints only tp_n then)."""
    labels = np.asarray(labels)
    pctr = np.asarray(pctr)
    order = np.argsort(-pctr, kind="stable")  # pctr descending
    sorted_labels = labels[order]
    pos = sorted_labels > 0.5
    tp_cum = np.cumsum(pos)
    p = int(tp_cum[-1]) if len(tp_cum) else 0
    n = len(labels) - p
    if p == 0 or n == 0:
        return float("nan")
    area = float(tp_cum[~pos].sum())
    return area / (p * n)


def auc_midrank(labels: np.ndarray, pctr: np.ndarray) -> float:
    """Exact rank-sum AUC with midrank tie handling (Mann-Whitney U /
    (P*N)): every (pos, neg) pair sharing a pctr counts 1/2.  Returns
    NaN when all labels are one class."""
    labels = np.asarray(labels)
    pctr = np.asarray(pctr)
    pos_mask = labels > 0.5
    p = int(pos_mask.sum())
    n = len(labels) - p
    if p == 0 or n == 0:
        return float("nan")
    order = np.argsort(pctr, kind="stable")  # ascending
    sp = pctr[order]
    first = np.empty(len(sp), bool)  # True at each tie group's start
    first[0] = True
    first[1:] = sp[1:] != sp[:-1]
    starts = np.flatnonzero(first)
    ends = np.append(starts[1:], len(sp))
    # midrank of group g = mean of 1-based ranks starts[g]+1 .. ends[g]
    mid = (starts + 1 + ends) / 2.0
    ranks = np.empty(len(sp))
    ranks[order] = mid[np.cumsum(first) - 1]
    u = ranks[pos_mask].sum() - p * (p + 1) / 2.0
    return float(u / (p * n))


class AucAccumulator:
    """Streaming accumulator for (label, pctr) pairs across eval batches
    (the reference accumulates test_auc_vec under a mutex,
    lr_worker.cc:62-68, then computes once).  AUC uses midrank ties."""

    def __init__(self) -> None:
        self._labels: list[np.ndarray] = []
        self._pctr: list[np.ndarray] = []

    def add(self, labels: np.ndarray, pctr: np.ndarray, weights: np.ndarray | None = None):
        labels = np.asarray(labels)
        pctr = np.asarray(pctr)
        if weights is not None:
            keep = np.asarray(weights) > 0
            labels, pctr = labels[keep], pctr[keep]
        self._labels.append(labels)
        self._pctr.append(pctr)

    def count(self) -> int:
        return int(sum(len(a) for a in self._labels))

    def compute(self) -> tuple[float, float]:
        """Returns (logloss_ln, auc)."""
        labels, pctr = self.pairs()
        if len(labels) == 0:
            return float("nan"), float("nan")
        p = np.clip(pctr, LOGLOSS_EPS, 1.0 - LOGLOSS_EPS)
        ll = -np.mean(labels * np.log(p) + (1.0 - labels) * np.log(1.0 - p))
        return float(ll), auc_midrank(labels, pctr)

    def pairs(self) -> tuple[np.ndarray, np.ndarray]:
        labels = np.concatenate(self._labels) if self._labels else np.zeros(0)
        pctr = np.concatenate(self._pctr) if self._pctr else np.zeros(0)
        return labels, pctr
