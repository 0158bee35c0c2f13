"""Padded static-shape minibatch representation.

A copy of the reference's io/batch.py, less the hot-table steering
(``split_hot`` and ``remap_batch`` come with the hot table, ROADMAP
A8b).  A batch is a padded COO block: ``[B, K]`` arrays of table keys,
field ids (slots), values and a validity mask, plus per-example labels
and weights.  Pad feature entries carry ``mask=0`` and key 0; pad
examples carry ``weight=0``.  The optional hot section (``hot_*``,
``[B, Kh]``) is zero-width unless a caller fills it: the port's
loaders never do, but CompactBatch (io/compact.py) and the packed
cache (io/packed.py) carry it as the reference's do.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def narrow_keys_i32(keys: np.ndarray) -> np.ndarray:
    """THE sanctioned uint64→int32 key narrowing.

    Batch key planes are int32 (kernel gather indices), but the feature
    key space is uint64 (hashed fids, io/hashing.py): every narrowing is
    only safe AFTER reduction mod ``table_size`` (table_size_log2 <= 30,
    config.py).  Already-int32 input passes through free; anything
    wider is range-checked before the cast — reject, never wrap.
    """
    a = np.asarray(keys)
    if a.dtype == np.int32:
        return a
    if a.size and (
        int(a.min()) < np.iinfo(np.int32).min
        or int(a.max()) > np.iinfo(np.int32).max
    ):
        raise ValueError(
            "narrow_keys_i32: key exceeds int32 — reduce full 64-bit "
            "keys mod table_size before narrowing (reject, never wrap)"
        )
    return a.astype(np.int32)


@dataclasses.dataclass
class Batch:
    keys: np.ndarray  # int32 [B, K] — row index into the hashed weight table
    slots: np.ndarray  # int32 [B, K] — field/group id (reference fgid)
    vals: np.ndarray  # float32 [B, K] — feature value (all-1 in hash mode)
    mask: np.ndarray  # float32 [B, K] — 1 for real feature entries
    labels: np.ndarray  # float32 [B] — binary labels
    weights: np.ndarray  # float32 [B] — 1 for real examples, 0 for padding
    # optional hot section (keys < hot_size): [B, Kh], Kh = 0 when disabled
    hot_keys: np.ndarray | None = None
    hot_slots: np.ndarray | None = None
    hot_vals: np.ndarray | None = None
    hot_mask: np.ndarray | None = None

    def __post_init__(self) -> None:
        if self.hot_keys is None:
            b = self.keys.shape[0]
            self.hot_keys = np.zeros((b, 0), np.int32)
            self.hot_slots = np.zeros((b, 0), np.int32)
            self.hot_vals = np.zeros((b, 0), np.float32)
            self.hot_mask = np.zeros((b, 0), np.float32)

    @property
    def batch_size(self) -> int:
        return int(self.keys.shape[0])

    @property
    def max_nnz(self) -> int:
        return int(self.keys.shape[1])

    @property
    def hot_nnz(self) -> int:
        return int(self.hot_keys.shape[1])

    def num_real(self) -> int:
        return int(self.weights.sum())


@dataclasses.dataclass
class ParsedBlock:
    """CSR view of one parsed text block (pre-padding)."""

    labels: np.ndarray  # float32 [n]
    row_ptr: np.ndarray  # int64 [n+1]
    keys: np.ndarray  # int64 [nnz] — already reduced mod table_size
    slots: np.ndarray  # int32 [nnz]
    vals: np.ndarray  # float32 [nnz]

    @property
    def num_samples(self) -> int:
        return int(self.labels.shape[0])


def make_batch(
    keys: np.ndarray,
    slots: np.ndarray,
    vals: np.ndarray,
    mask: np.ndarray,
    labels: np.ndarray,
    weights: np.ndarray,
) -> Batch:
    """Build a Batch from padded [B, K] feature arrays — the single
    construction point shared by pack_batch and the synthetic-batch
    builders."""
    return Batch(
        keys=keys, slots=slots, vals=vals, mask=mask,
        labels=labels, weights=weights,
    )


def pad_batch_rows(batch: Batch, to: int) -> Batch:
    """Extend a Batch to ``to`` rows with zero-weight padding examples
    (mask/weights 0 — no-ops through predict).  Used by the serving
    engine to snap request batches onto its fixed bucket shapes."""
    extra = to - batch.batch_size
    if extra < 0:
        raise ValueError(
            f"pad_batch_rows: batch has {batch.batch_size} rows, "
            f"cannot shrink to {to}"
        )
    if extra == 0:
        return batch

    def pad(a: np.ndarray) -> np.ndarray:
        return np.concatenate(
            [a, np.zeros((extra,) + a.shape[1:], a.dtype)]
        )

    return Batch(
        keys=pad(batch.keys),
        slots=pad(batch.slots),
        vals=pad(batch.vals),
        mask=pad(batch.mask),
        labels=pad(batch.labels),
        weights=pad(batch.weights),
    )


def pack_batch(
    block: ParsedBlock,
    start: int,
    end: int,
    batch_size: int,
    max_nnz: int,
) -> Batch:
    """Pack samples [start, end) of a CSR block into one padded Batch.

    Rows with more than ``max_nnz`` features are truncated (the
    reference has no per-sample feature cap; SURVEY §7 hard part (b)).
    """
    n = end - start
    if not 0 < n <= batch_size:
        raise ValueError(
            f"pack_batch: {n} samples do not fit batch_size {batch_size}"
        )
    # Keys narrow to int32 batch arrays; reject, never wrap.  Scoped to
    # the packed slice so the check is O(slice nnz).
    lo, hi = int(block.row_ptr[start]), int(block.row_ptr[end])
    if hi > lo:
        kslice = block.keys[lo:hi]
        if kslice.min() < 0 or kslice.max() > np.iinfo(np.int32).max:
            raise ValueError(
                "pack_batch: a key exceeds int32 — table_size too large "
                "for the int32 batch arrays (full 64-bit keys must be "
                "reduced before packing)"
            )
    labels = np.zeros(batch_size, dtype=np.float32)
    weights = np.zeros(batch_size, dtype=np.float32)
    labels[:n] = block.labels[start:end]
    weights[:n] = 1.0

    starts = block.row_ptr[start:end]
    ends = block.row_ptr[start + 1 : end + 1]
    counts = np.minimum(ends - starts, max_nnz)
    # vectorized ragged→padded gather: position j of row i reads CSR slot
    # starts[i]+j while j < counts[i]
    j = np.arange(max_nnz, dtype=np.int64)[None, :]
    valid = j < counts[:, None]  # [n, K]
    src = np.where(valid, starts[:, None] + j, 0)

    def pad_gather(flat: np.ndarray, dtype) -> np.ndarray:
        out = np.zeros((batch_size, max_nnz), dtype=dtype)
        if len(flat):
            out[:n] = np.where(valid, flat[src], 0)
        return out

    keys = pad_gather(block.keys, np.int32)
    slots = pad_gather(block.slots, np.int32)
    vals = pad_gather(block.vals, np.float32)
    mask = np.concatenate(
        [
            valid.astype(np.float32),
            np.zeros((batch_size - n, max_nnz), np.float32),
        ]
    )
    return make_batch(keys, slots, vals, mask, labels, weights)
