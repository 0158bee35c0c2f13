"""libffm text parsing — the pure-Python parser.

A copy of the reference's io/libffm.py ``parse_block``; the native
parser and the block streaming reader come with ROADMAP A2.  Behaviour
follows the reference's production loader
(load_data_from_disk.cc:103-210):

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

import numpy as np

from xflow_tpu_torch.io.batch import ParsedBlock
from xflow_tpu_torch.io.hashing import murmur64_batch

LABEL_THRESHOLD = 1e-7  # reference: load_data_from_disk.cc:131-134


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
