"""Stable 64-bit feature hashing (MurmurHash64A).

The reference hashes feature-id string tokens with ``std::hash<string>``
(io.h:53, applied at load_data_from_disk.cc:151).  ``std::hash`` is
implementation-defined, so checkpoints/results would not be portable
across toolchains; we use MurmurHash64A (Austin Appleby, public domain)
instead — the same choice SURVEY §7 stage 2 calls for.  Golden vectors
from the canonical C implementation are pinned in tests/test_hashing.py
so any alternate implementation (e.g. a native parser) can be checked
for bit-exact parity.

Both a scalar reference implementation and a length-grouped vectorized
numpy implementation are provided; they agree bit-for-bit.
"""

from __future__ import annotations

import numpy as np

_M = 0xC6A4A7935BD1E995
_R = 47
_MASK = (1 << 64) - 1
DEFAULT_SEED = 0


def murmur64(data: bytes | str, seed: int = DEFAULT_SEED) -> int:
    """MurmurHash64A of ``data``; returns an unsigned 64-bit int."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    n = len(data)
    h = (seed ^ ((n * _M) & _MASK)) & _MASK
    nblocks = n // 8
    for i in range(nblocks):
        k = int.from_bytes(data[i * 8 : i * 8 + 8], "little")
        k = (k * _M) & _MASK
        k ^= k >> _R
        k = (k * _M) & _MASK
        h ^= k
        h = (h * _M) & _MASK
    tail = data[nblocks * 8 :]
    if tail:
        k = int.from_bytes(tail, "little")
        h ^= k
        h = (h * _M) & _MASK
    h ^= h >> _R
    h = (h * _M) & _MASK
    h ^= h >> _R
    return h


def _murmur64_fixed_len(buf: np.ndarray, seed: int) -> np.ndarray:
    """Vectorized MurmurHash64A for a [n, L] uint8 array of equal-length
    tokens (L = true byte length of every row)."""
    n, length = buf.shape
    m = np.uint64(_M)
    r = np.uint64(_R)
    h = np.full(n, (seed ^ ((length * _M) & _MASK)) & _MASK, dtype=np.uint64)
    nblocks = length // 8
    old = np.seterr(over="ignore")
    try:
        for i in range(nblocks):
            k = (
                buf[:, i * 8 : i * 8 + 8]
                .copy()
                .view(np.uint64)
                .reshape(n)
                .astype(np.uint64)
            )
            k *= m
            k ^= k >> r
            k *= m
            h ^= k
            h *= m
        tail_len = length - nblocks * 8
        if tail_len:
            k = np.zeros(n, dtype=np.uint64)
            for j in range(tail_len):
                k |= buf[:, nblocks * 8 + j].astype(np.uint64) << np.uint64(8 * j)
            h ^= k
            h *= m
        h ^= h >> r
        h *= m
        h ^= h >> r
    finally:
        np.seterr(**old)
    return h


def murmur64_batch(tokens: list[bytes], seed: int = DEFAULT_SEED) -> np.ndarray:
    """Vectorized MurmurHash64A over a list of byte tokens.

    Groups tokens by length and hashes each group with numpy; bit-exact
    with :func:`murmur64`.  Returns uint64 [len(tokens)].
    """
    out = np.empty(len(tokens), dtype=np.uint64)
    if not tokens:
        return out
    lengths = np.fromiter((len(t) for t in tokens), dtype=np.int64, count=len(tokens))
    for length in np.unique(lengths):
        idx = np.nonzero(lengths == length)[0]
        if length == 0:
            # h = seed ^ 0, then finalization mix.
            out[idx] = np.uint64(murmur64(b"", seed))
            continue
        buf = np.frombuffer(
            b"".join(tokens[i] for i in idx), dtype=np.uint8
        ).reshape(len(idx), int(length))
        out[idx] = _murmur64_fixed_len(buf, seed)
    return out
