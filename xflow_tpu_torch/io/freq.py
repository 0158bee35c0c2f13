"""Key-frequency statistics and the hot-head remap (a copy of the
reference's io/freq.py).

The hot table is rows [0, H) of each weight table.  Feature hashing
spreads keys uniformly, so the frequent keys are measured: sample the
head of the training data, count key frequencies, and build a
*permutation* of the hash space that maps the top-H keys to rows
[0, H) and everything else to [H, T) — a bijection, so collision
behaviour is unchanged; only row placement moves.

The remap is computed from a deterministic sample (the first
``sample_bytes`` of the global shard list, block-aligned), so every
host derives the identical permutation with no communication.  It is
part of the model: rows are addressed through it, so it travels with
an exported artifact (serve/artifact.py) and is applied before any
prediction, and it is persisted beside the checkpoints
(``checkpoint_dir/remap.npy``, trainer.py::_init_remap).

Keys are counted from libffm text or binary block-cache shards; packed
shards hold post-remap keys and are refused as the reference refuses
them.
"""

from __future__ import annotations

import os

import numpy as np

from xflow_tpu_torch.io import binary, packed
from xflow_tpu_torch.io.libffm import BlockReader


def count_keys(
    paths: list[str],
    parse_fn,
    table_size: int,
    sample_bytes: int,
    block_bytes: int = 2 << 20,
) -> np.ndarray:
    """Count key occurrences over up to ``sample_bytes`` of data taken
    from the front of ``paths`` in order.  Returns int64 [table_size]."""
    counts = np.zeros(table_size, dtype=np.int64)
    remaining = sample_bytes
    for path in paths:
        if remaining <= 0:
            break
        with open(path, "rb") as f:
            magic = f.read(len(binary.MAGIC))
            if magic == binary.MAGIC:
                # binary block cache: records already hold keys
                for block, off, noff in binary.iter_blocks(f, table_size):
                    if len(block.keys):
                        np.add.at(counts, block.keys, 1)
                    remaining -= noff - off
                    if remaining <= 0:
                        break
                continue
            if magic == packed.MAGIC:
                # packed caches hold POST-remap keys — counting them
                # cannot build a remap; parsing them as text would
                # silently produce garbage counts
                raise ValueError(
                    f"{path} is a packed-batch cache: key frequencies "
                    "must be counted from text or CSR-binary shards "
                    "(the remap is baked in at pack time — point "
                    "hot-table runs at the remap.npy used to build it)"
                )
            f.seek(0)
            for raw in BlockReader(f, block_bytes):
                block = parse_fn(raw)
                if len(block.keys):
                    # in-place accumulate: no O(table_size) temporary per
                    # block (bincount would allocate [T] each time)
                    np.add.at(counts, block.keys, 1)
                remaining -= len(raw)
                if remaining <= 0:
                    break
    return counts


def build_remap(counts: np.ndarray, hot_size: int) -> np.ndarray:
    """Permutation of [0, T): the hot_size most frequent keys map to
    [0, hot_size) in descending-frequency order; the rest keep their
    relative order in [hot_size, T).  Returns int32 [T]."""
    t = counts.shape[0]
    if not 0 < hot_size < t:
        raise ValueError(f"hot_size {hot_size} must be in (0, {t})")
    top = np.argpartition(counts, t - hot_size)[t - hot_size :]
    top = top[np.argsort(counts[top])[::-1]]  # descending frequency
    perm = np.empty(t, dtype=np.int32)
    perm[top] = np.arange(hot_size, dtype=np.int32)
    rest = np.ones(t, dtype=bool)
    rest[top] = False
    perm[rest] = np.arange(hot_size, t, dtype=np.int32)
    return perm


def hot_mass(counts: np.ndarray, remap: np.ndarray, hot_size: int) -> float:
    """Fraction of sampled occurrences the hot table captures."""
    total = counts.sum()
    if total == 0:
        return 0.0
    hot = counts[remap < hot_size].sum()
    return float(hot) / float(total)


def save_remap(path: str, remap: np.ndarray) -> None:
    tmp = path + ".tmp.npy"  # np.save appends .npy unless present
    np.save(tmp, remap)
    os.replace(tmp, path)


def load_remap(path: str) -> np.ndarray | None:
    if not os.path.exists(path):
        return None
    return np.load(path)
