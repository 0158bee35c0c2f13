"""Binary block cache: pre-parsed, pre-hashed CSR shards (a copy of
the reference's io/binary.py; each package reads the other's shards,
and their converters write the same bytes).

Convert each text shard ONCE to a binary file of raw CSR block arrays,
and training streams those with no tokenizing, hashing or float
parsing.  The records carry no wire of their own: the loader assembles
batches from them exactly as from parsed text blocks.

Format (little-endian, self-describing blocks):

    magic   8 bytes  b"XFBC0001"
    hlen    u32      header JSON length
    header  bytes    {"version": 1, "hash_mode": bool, "hash_seed": int,
                      "examples": int, "nnz": int, "blocks": int}
    then until EOF, one record per parsed text block:
      n_rows u64 | nnz u64
      labels  f32[n_rows]
      row_ptr i64[n_rows+1]
      keys    i64[nnz]   FULL keys: the 64-bit murmur hash
                         (two's-complement view) in hash mode, the raw
                         fid in numeric mode — NOT reduced mod
                         table_size, so one cache serves any table size
                         (reduction happens at load, bit-identical to
                         the text parser's)
      slots   i32[nnz]
      vals    f32[nnz]

A resume offset in a binary shard is the byte offset of a record start
(the first record's offset doubles as "start of data"), so the loader's
(batch, resume_offset) contract is unchanged between text and binary
shards — ShardLoader sniffs the magic and picks the block source.

Convert via the CLI:

    python -m xflow_tpu_torch.io.binary --train PREFIX --out PREFIX.bin
                                        [--no-hash] [--seed N] [--block-mib N]
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Iterator

import numpy as np

from xflow_tpu_torch.io import container
from xflow_tpu_torch.io.batch import ParsedBlock

MAGIC = b"XFBC0001"
_REC_HDR = struct.Struct("<QQ")  # n_rows, nnz
# sanity ceiling on record header counts: a u64 count near 2^64 (bit
# rot / inflation attack) would push read sizes past sys.maxsize and
# crash with an untyped OverflowError instead of a typed refusal
_MAX_REC_COUNT = 1 << 48


def is_binary_shard(path: str) -> bool:
    return container.sniff(path, MAGIC)


def read_header(f: BinaryIO) -> tuple[dict, int]:
    """Returns (header dict, byte offset of the first record)."""
    return container.read_header(f, MAGIC, "binary shard")


def reduce_keys(raw: np.ndarray, table_size: int, hash_mode: bool) -> np.ndarray:
    """Reduce full stored keys mod table_size, bit-identical to
    libffm.parse_block's reduction: uint64 arithmetic for hashes,
    numpy int64 mod (sign of divisor) for numeric fids."""
    if hash_mode:
        return (raw.view(np.uint64) % np.uint64(table_size)).astype(np.int64)
    return raw % np.int64(table_size)


def _write_record(f: BinaryIO, block: ParsedBlock) -> None:
    n, nnz = block.num_samples, int(block.row_ptr[-1])
    f.write(_REC_HDR.pack(n, nnz))
    f.write(np.ascontiguousarray(block.labels, np.float32).tobytes())
    f.write(np.ascontiguousarray(block.row_ptr, np.int64).tobytes())
    f.write(np.ascontiguousarray(block.keys, np.int64).tobytes())
    f.write(np.ascontiguousarray(block.slots, np.int32).tobytes())
    f.write(np.ascontiguousarray(block.vals, np.float32).tobytes())


def _read_exact(f: BinaryIO, nbytes: int) -> bytes:
    buf = f.read(nbytes)
    if len(buf) != nbytes:
        raise ValueError(
            f"truncated binary shard: wanted {nbytes} bytes, got {len(buf)}"
        )
    return buf


def read_record(f: BinaryIO) -> ParsedBlock | None:
    """Read one record at the current offset; None at EOF."""
    hdr = f.read(_REC_HDR.size)
    if not hdr:
        return None
    if len(hdr) != _REC_HDR.size:
        raise ValueError("truncated binary shard record header")
    n, nnz = _REC_HDR.unpack(hdr)
    if n > _MAX_REC_COUNT or nnz > _MAX_REC_COUNT:
        raise ValueError(
            f"binary shard record header counts out of range "
            f"(n_rows={n} nnz={nnz}) — corrupt record"
        )
    labels = np.frombuffer(_read_exact(f, 4 * n), np.float32)
    row_ptr = np.frombuffer(_read_exact(f, 8 * (n + 1)), np.int64)
    keys = np.frombuffer(_read_exact(f, 8 * nnz), np.int64)
    slots = np.frombuffer(_read_exact(f, 4 * nnz), np.int32)
    vals = np.frombuffer(_read_exact(f, 4 * nnz), np.float32)
    return ParsedBlock(
        labels=labels, row_ptr=row_ptr, keys=keys, slots=slots, vals=vals
    )


def iter_blocks(
    f: BinaryIO,
    table_size: int,
    start_offset: int = 0,
    expect_hash_mode: bool | None = None,
    expect_hash_seed: int | None = None,
) -> Iterator[tuple[ParsedBlock, int, int]]:
    """Yield (block, offset, next_offset) records with keys reduced to
    [0, table_size) — the binary twin of the loader's text block
    source.  ``start_offset`` <= first-record-offset starts from the
    beginning; larger values must be a record boundary (a resume offset
    this iterator previously yielded)."""
    f.seek(0)
    meta, data_start = read_header(f)
    if expect_hash_mode is not None and bool(meta["hash_mode"]) != bool(
        expect_hash_mode
    ):
        raise ValueError(
            f"binary shard was converted with hash_mode="
            f"{meta['hash_mode']}, loader expects {expect_hash_mode}"
        )
    if (
        expect_hash_seed is not None
        and meta["hash_mode"]
        and int(meta["hash_seed"]) != int(expect_hash_seed)
    ):
        raise ValueError(
            f"binary shard was hashed with seed {meta['hash_seed']}, "
            f"loader expects {expect_hash_seed}"
        )
    offset = max(int(start_offset), data_start)
    if offset > data_start:
        # Records are variable-size, so validate the resume offset by
        # hopping record headers from the start (16 bytes read per
        # record — trivial at multi-MiB records).  A misaligned offset
        # (e.g. a cursor saved against the TEXT version of this shard)
        # would otherwise read garbage sizes; the packed format rejects
        # this with modulo arithmetic, this format by walking.
        pos = data_start
        while pos < offset:
            f.seek(pos)
            hdr = f.read(_REC_HDR.size)
            if len(hdr) != _REC_HDR.size:
                raise ValueError(
                    f"start_offset {start_offset} is past the shard end"
                )
            n, nnz = _REC_HDR.unpack(hdr)
            # labels f32[n] + row_ptr i64[n+1] + keys i64 + slots i32
            # + vals f32 (see _write_record)
            pos += _REC_HDR.size + 4 * n + 8 * (n + 1) + 16 * nnz
        if pos != offset:
            raise ValueError(
                f"start_offset {start_offset} is not a record boundary "
                "(cursor from a different file/format?)"
            )
    f.seek(offset)
    hash_mode = bool(meta["hash_mode"])
    while True:
        block = read_record(f)
        if block is None:
            return
        next_offset = f.tell()
        if len(block.keys):
            block.keys = reduce_keys(block.keys, table_size, hash_mode)
        yield block, offset, next_offset
        offset = next_offset


def shard_example_count(path: str) -> int:
    # metadata peek: the header's totals
    with open(path, "rb") as f:
        meta, _ = read_header(f)
        return int(meta["examples"])


def convert_shard(
    src: str,
    dst: str,
    hash_mode: bool = True,
    hash_seed: int = 0,
    block_mib: float = 8,
    parse_fn=None,
) -> dict:
    """Parse one libffm text shard and write the binary cache file
    (atomic: temp + rename).  Returns the header dict.  ``block_mib``
    sets the text-block granularity, which becomes the cache's resume
    granularity (same block-carry semantics as training on text,
    BlockReader)."""
    from xflow_tpu_torch.io.libffm import BlockReader
    from xflow_tpu_torch.io.loader import make_parse_fn

    if parse_fn is None:
        # table_size=0: store FULL keys (module docstring)
        parse_fn = make_parse_fn(0, hash_mode, hash_seed)
    examples = 0
    nnz = 0
    blocks = 0
    tmp = f"{dst}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    try:
        with open(src, "rb") as fin, open(tmp, "wb") as fout:
            meta = {
                "version": 1,
                "hash_mode": bool(hash_mode),
                "hash_seed": int(hash_seed),
            }
            hdr_len = container.write_placeholder_header(
                fout, MAGIC, meta, ("examples", "nnz", "blocks")
            )
            for raw in BlockReader(fin, max(1, int(block_mib * (1 << 20)))):
                block = parse_fn(raw)
                if block.num_samples == 0:
                    continue
                _write_record(fout, block)
                examples += block.num_samples
                nnz += int(block.row_ptr[-1])
                blocks += 1
            meta.update(examples=examples, nnz=nnz, blocks=blocks)
            container.rewrite_header(fout, MAGIC, meta, hdr_len)
        os.replace(tmp, dst)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return meta


def convert_prefix(
    train_prefix: str,
    out_prefix: str,
    hash_mode: bool = True,
    hash_seed: int = 0,
    block_mib: float = 8,
    log=print,
) -> list[str]:
    """Convert every ``prefix-%05d`` shard (or a single file) to
    ``out_prefix-%05d`` binary shards; returns the output paths."""
    from xflow_tpu_torch.trainer import find_shards

    outs = []
    for i, src in enumerate(find_shards(train_prefix)):
        dst = (
            f"{out_prefix}-{i:05d}"
            if src != train_prefix
            else out_prefix
        )
        meta = convert_shard(src, dst, hash_mode, hash_seed, block_mib)
        log(
            f"{src} -> {dst}: {meta['examples']} examples, "
            f"{meta['nnz']} nnz, {meta['blocks']} blocks"
        )
        outs.append(dst)
    return outs


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="xflow_tpu_torch.io.binary",
        description="convert libffm text shards to the binary block cache",
    )
    p.add_argument("--train", required=True, help="text shard prefix")
    p.add_argument("--out", required=True, help="output shard prefix")
    p.add_argument("--no-hash", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--block-mib", type=float, default=8)
    a = p.parse_args(argv)
    convert_prefix(
        a.train, a.out, not a.no_hash, a.seed, a.block_mib
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
