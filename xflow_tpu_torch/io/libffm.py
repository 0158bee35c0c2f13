"""libffm text parsing with block streaming — the pure-Python parser.

A copy of the reference's io/libffm.py (``BlockReader``,
``parse_block``, ``parse_file``, ``open_block_stream``); the native
parser comes with ROADMAP A2.  Behaviour follows the reference's
production loader (load_data_from_disk.cc:103-210):

* blocks of ~block_bytes carry the partial last line over to the next
  read (:108-124);
* a line is ``label<SEP>fgid:fid:val ...`` — whitespace-separated
  feature tokens after the label;
* the label is binarized ``y > 1e-7 → 1`` (:131-134);
* ``fgid`` parses as an integer field/group id;
* in hash mode the ``fid`` token is hashed **as a string**
  (MurmurHash64A, io/hashing.py) and the value field is discarded;
* in numeric mode ``fid`` parses as an integer and ``val`` as a float
  and both are kept.

Malformed tokens are skipped rather than undefined behaviour.
"""

from __future__ import annotations

import io as _stdio
from typing import BinaryIO, Iterator

import numpy as np

from xflow_tpu_torch.io.batch import ParsedBlock
from xflow_tpu_torch.io.hashing import murmur64_batch

LABEL_THRESHOLD = 1e-7  # reference: load_data_from_disk.cc:131-134


class BlockReader:
    """Streams a binary file in ~block_bytes chunks of whole lines,
    carrying the partial last line between reads (reference
    load_data_from_disk.cc:108-124)."""

    def __init__(self, f: BinaryIO, block_bytes: int):
        self._f = f
        self._block_bytes = max(int(block_bytes), 1)
        self._carry = b""

    def __iter__(self) -> Iterator[bytes]:
        while True:
            chunk = self._f.read(self._block_bytes)
            if not chunk:
                if self._carry:
                    carry, self._carry = self._carry, b""
                    yield carry
                return
            buf = self._carry + chunk
            cut = buf.rfind(b"\n")
            if cut == -1:
                self._carry = buf
                continue
            self._carry = buf[cut + 1 :]
            yield buf[: cut + 1]


def parse_block(
    data: bytes,
    table_size: int,
    hash_mode: bool = True,
    hash_seed: int = 0,
) -> ParsedBlock:
    """Parse one block of libffm lines into a CSR ParsedBlock.

    Keys are reduced modulo ``table_size`` (the device table is a
    dense array, unlike the reference's unbounded server-side hash map,
    ftrl.h:84).  ``table_size=0`` keeps FULL keys — the 64-bit hash
    (two's-complement int64 view) in hash mode, the raw fid in numeric
    mode — for the binary block cache (io/binary.py, table-size-
    independent) and collision accounting.
    """
    labels: list[float] = []
    row_ptr: list[int] = [0]
    slots: list[int] = []
    vals: list[float] = []
    tokens: list[bytes] = []  # fid tokens (hash mode)
    fids: list[int] = []  # numeric fids (no-hash mode)

    for line in data.split(b"\n"):
        line = line.strip()
        if not line:
            continue
        parts = line.split()
        try:
            y = float(parts[0])
        except ValueError:
            continue
        labels.append(1.0 if y > LABEL_THRESHOLD else 0.0)
        for tok in parts[1:]:
            pieces = tok.split(b":")
            if len(pieces) != 3:
                continue
            try:
                fgid = int(pieces[0])
            except ValueError:
                continue
            if not -(2**31) <= fgid < 2**31:
                continue  # slot arrays are int32; reject, never wrap
            if hash_mode:
                tokens.append(pieces[1])
                vals.append(1.0)  # value field discarded: binary features
            else:
                try:
                    fid = int(pieces[1])
                    val = float(pieces[2])
                except ValueError:
                    continue
                if not -(2**63) <= fid < 2**63:
                    continue  # keys are int64; reject, never wrap
                # reject values not finite IN FLOAT32: inf/nan literals
                # and "1e999"/"1e39"-style overflows the float32 cast
                # would silently turn into inf (round-1 weak point 8).
                # (2-2^-24)*2^127 is the exact round-to-nearest overflow
                # boundary; `not <` also rejects nan.  Native parser
                # matches exactly (parser.cc isfinite after narrowing).
                if not abs(val) < 3.4028235677973366e38:
                    continue
                fids.append(fid)
                vals.append(val)
            slots.append(fgid)
        row_ptr.append(len(slots))

    if hash_mode:
        hashed = murmur64_batch(tokens, seed=hash_seed)
        if table_size:
            keys = (hashed % np.uint64(table_size)).astype(np.int64)
        else:
            keys = hashed.view(np.int64)
    else:
        keys = np.asarray(fids, dtype=np.int64)
        if table_size:
            keys = keys % table_size

    return ParsedBlock(
        labels=np.asarray(labels, dtype=np.float32),
        row_ptr=np.asarray(row_ptr, dtype=np.int64),
        keys=keys,
        slots=np.asarray(slots, dtype=np.int32),
        vals=np.asarray(vals, dtype=np.float32),
    )


def parse_file(
    path: str, table_size: int, hash_mode: bool = True, hash_seed: int = 0
) -> ParsedBlock:
    """Parse an entire file at once (reference ``load_all_*`` loaders,
    load_data_from_disk.cc:11-33,59-79)."""
    with open(path, "rb") as f:
        return parse_block(f.read(), table_size, hash_mode, hash_seed)


def open_block_stream(path: str, block_mib: int) -> BlockReader:
    """A BlockReader over ``path`` in ``block_mib`` MiB blocks: a
    bare-stream helper for tools and tests (ShardLoader opens its
    own)."""
    f: BinaryIO = open(path, "rb", buffering=_stdio.DEFAULT_BUFFER_SIZE)
    return BlockReader(f, block_mib << 20)
