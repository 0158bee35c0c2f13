"""Synthetic zipf-feature CTR traffic in libffm text — the repo's
generator (scripts/gen_synth.py), copied so the port needs nothing
outside its own package.

Lines are Criteo-shaped: 39 fields, ids drawn per field from a bounded
zipf(1.2) over 100,000 ids, every token exactly ``FF:XXXXXXX:1 ``.
Labels carry a planted logistic signal: each (field, id) has a hidden
weight w ~ N(0, w_scale) and label ~ Bernoulli(sigmoid(bias + Σw)), so
a correct trainer beats chance and the planted model itself is the
Bayes-optimal scorer (:func:`planted_pctr`).

Output bytes are those of scripts/gen_synth.py for the same arguments
(tests/test_torch_io.py holds the two side by side).
"""

from __future__ import annotations

import math
import os

import numpy as np

FIELDS = 39  # Criteo-style: 13 numeric + 26 categorical
VOCAB = 100_000  # ids per field; global id = field * VOCAB + local
TOKEN_W = 13  # b"FF:XXXXXXX:1 "
LINE_W = 2 + FIELDS * TOKEN_W  # label + tab + tokens (last byte -> \n)


def hidden_weights(seed: int, w_scale: float = 0.22) -> np.ndarray:
    """The planted model: float32 [FIELDS, VOCAB], deterministic in seed."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    return rng.normal(0.0, w_scale, (FIELDS, VOCAB)).astype(np.float32)


_ALIAS_CACHE: dict[float, tuple[np.ndarray, np.ndarray]] = {}
_HI_DIGITS = None  # [10000, 4] uint8 ascii digits
_LO_DIGITS = None  # [1000, 3]


def _zipf_alias(a: float) -> tuple[np.ndarray, np.ndarray]:
    """Walker alias tables for the bounded zipf over ranks [0, VOCAB)
    (P(r) ∝ (r+1)^-a): exact O(1) sampling per draw."""
    tabs = _ALIAS_CACHE.get(a)
    if tabs is None:
        pmf = np.arange(1, VOCAB + 1, dtype=np.float64) ** -a
        pmf /= pmf.sum()
        scaled = pmf * VOCAB
        prob = np.ones(VOCAB)
        alias = np.arange(VOCAB, dtype=np.int32)
        small = [i for i in range(VOCAB) if scaled[i] < 1.0]
        large = [i for i in range(VOCAB) if scaled[i] >= 1.0]
        scaled = scaled.copy()
        while small and large:
            s, l = small.pop(), large.pop()
            prob[s] = scaled[s]
            alias[s] = l
            scaled[l] += scaled[s] - 1.0
            (small if scaled[l] < 1.0 else large).append(l)
        tabs = (prob, alias)
        _ALIAS_CACHE[a] = tabs
    return tabs


def _zipf_draw(
    rng: np.random.Generator, shape: tuple[int, ...], a: float
) -> np.ndarray:
    prob, alias = _zipf_alias(a)
    k = (rng.random(shape) * VOCAB).astype(np.int32)
    return np.where(rng.random(shape) < prob[k], k, alias[k]).astype(np.int32)


def _digit_tables():
    global _HI_DIGITS, _LO_DIGITS
    if _HI_DIGITS is None:
        hi = np.arange(10000, dtype=np.int32)
        _HI_DIGITS = np.stack(
            [48 + (hi // 10 ** (3 - d)) % 10 for d in range(4)], axis=1
        ).astype(np.uint8)
        _LO_DIGITS = _HI_DIGITS[:1000, 1:].copy()
    return _HI_DIGITS, _LO_DIGITS


def _chunk_bytes(
    rng: np.random.Generator,
    n: int,
    w: np.ndarray,
    bias: float,
    zipf_a: float,
) -> bytes:
    ids = _zipf_draw(rng, (n, FIELDS), zipf_a)
    logit = w[np.arange(FIELDS)[None, :], ids].sum(axis=1) + bias
    p = 1.0 / (1.0 + np.exp(-logit))
    labels = (rng.random(n) < p).astype(np.uint8)

    hi_d, lo_d = _digit_tables()
    buf = np.empty((n, LINE_W), dtype=np.uint8)
    buf[:, 0] = 48 + labels
    buf[:, 1] = 9  # tab
    tok = buf[:, 2:].reshape(n, FIELDS, TOKEN_W)
    fgid = np.arange(FIELDS, dtype=np.int32)[None, :]
    tok[:, :, 0] = 48 + fgid // 10
    tok[:, :, 1] = 48 + fgid % 10
    tok[:, :, 2] = 58  # ':'
    gid = fgid * VOCAB + ids  # 7 digits: 4 high + 3 low via lookup
    tok[:, :, 3:7] = hi_d[gid // 1000]
    tok[:, :, 7:10] = lo_d[gid % 1000]
    tok[:, :, 10] = 58  # ':'
    tok[:, :, 11] = 49  # '1'
    tok[:, :, 12] = 32  # ' '
    buf[:, -1] = 10  # '\n'
    return buf.tobytes()


def generate_shard(
    path: str,
    num_examples: int,
    seed: int = 7,
    bias: float = -1.0,
    zipf_a: float = 1.2,
    chunk: int = 131072,
    model_seed: int | None = None,
) -> dict:
    """Write one shard; returns {"bytes": ..., "examples": ...}.
    ``model_seed`` selects the planted model, ``seed`` the example
    stream (defaults to ``seed``)."""
    w = hidden_weights(seed if model_seed is None else model_seed)
    rng = np.random.default_rng(seed)
    written = 0
    with open(path, "wb", buffering=1 << 22) as f:
        while written < num_examples:
            n = min(chunk, num_examples - written)
            f.write(_chunk_bytes(rng, n, w, bias, zipf_a))
            written += n
    return {"bytes": os.path.getsize(path), "examples": num_examples}


def generate_dataset(
    prefix: str,
    num_train: int,
    num_test: int = 0,
    train_shards: int = 1,
    seed: int = 7,
    **kw,
) -> dict:
    """Write ``<prefix>.train-%05d`` shards (+ ``<prefix>.test-00000``);
    train and test draw from one planted model (different streams)."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    per = math.ceil(num_train / train_shards)
    info: dict = {"train": [], "test": None}
    done = 0
    for s in range(train_shards):
        n = min(per, num_train - done)
        info["train"].append(
            generate_shard(
                f"{prefix}.train-{s:05d}", n, seed=seed + s,
                model_seed=seed, **kw,
            )
        )
        done += n
    if num_test:
        info["test"] = generate_shard(
            f"{prefix}.test-00000", num_test, seed=seed + 10_000,
            model_seed=seed, **kw,
        )
    return info


def read_shard(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Decode a shard this generator wrote back into (labels u8 [n],
    per-field local ids i32 [n, FIELDS]) from its fixed-width bytes."""
    buf = np.fromfile(path, dtype=np.uint8).reshape(-1, LINE_W)
    tok = buf[:, 2:].reshape(len(buf), FIELDS, TOKEN_W)
    digits = tok[:, :, 3:10].astype(np.int32) - 48
    gid = digits @ (10 ** np.arange(6, -1, -1, dtype=np.int32))
    ids = gid - np.arange(FIELDS, dtype=np.int32)[None, :] * VOCAB
    return buf[:, 0] - 48, ids.astype(np.int32)


def planted_pctr(ids: np.ndarray, seed: int = 7, bias: float = -1.0) -> np.ndarray:
    """The planted model's click probability for per-field ids [n,
    FIELDS] (the dataset's ``model_seed``): the Bayes-optimal scorer."""
    w = hidden_weights(seed)
    logit = w[np.arange(FIELDS)[None, :], ids].sum(axis=1) + bias
    return 1.0 / (1.0 + np.exp(-logit))
