"""Parse-function factory (the reference's io/loader.py
``make_parse_fn``).  The shard loader, prefetching and fan-out come
with ROADMAP A2; the native parser with it."""

from __future__ import annotations

from typing import Callable

from xflow_tpu_torch.io.batch import ParsedBlock
from xflow_tpu_torch.io.libffm import parse_block

ParseFn = Callable[[bytes], ParsedBlock]


def make_parse_fn(
    table_size: int,
    hash_mode: bool = True,
    hash_seed: int = 0,
) -> ParseFn:
    """``bytes -> ParsedBlock`` closure over the parse settings, on the
    pure-Python parser (the reference pins its native parser equal to
    it)."""
    return lambda data: parse_block(data, table_size, hash_mode, hash_seed)
