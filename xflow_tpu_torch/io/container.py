"""Shared container framing for the on-disk cache formats (the
reference's io/container.py; io/packed.py's batches and io/binary.py's
CSR blocks): an 8-byte magic, a u32 JSON-header
length, the JSON header, then format-specific records.

Writers stream records after a placeholder header (totals pinned to
2^63 so the real values — which can only be shorter — rewrite in place
without moving the data), then call rewrite_header once the totals are
known.  Readers go through read_header, which also enforces the
format's version."""

from __future__ import annotations

import json
import struct
from typing import BinaryIO

_HLEN = struct.Struct("<I")


def sniff(path: str, magic: bytes) -> bool:
    # magic peek for format dispatch
    with open(path, "rb") as f:
        return f.read(len(magic)) == magic


def read_header(
    f: BinaryIO, magic: bytes, what: str, version: int | tuple = 1
) -> tuple[dict, int]:
    """Returns (header dict, byte offset of the first record).
    ``version`` may be a tuple when a format spans several on-disk
    versions the caller knows how to read (io/packed.py v1/v2)."""
    got = f.read(len(magic))
    if got != magic:
        raise ValueError(f"not a {what} (bad magic)")
    raw = f.read(_HLEN.size)
    if len(raw) != _HLEN.size:
        raise ValueError(f"truncated {what} header")
    (hlen,) = _HLEN.unpack(raw)
    body = f.read(hlen)
    if len(body) != hlen:
        raise ValueError(f"truncated {what} header")
    meta = json.loads(body)
    versions = version if isinstance(version, tuple) else (version,)
    if meta.get("version") not in versions:
        raise ValueError(
            f"unsupported {what} version {meta.get('version')!r} "
            f"(expected {' or '.join(map(str, versions))})"
        )
    return meta, len(magic) + _HLEN.size + hlen


def write_placeholder_header(
    f: BinaryIO, magic: bytes, meta: dict, total_keys: tuple[str, ...]
) -> int:
    """Write ``meta`` with every key in ``total_keys`` pinned to 2^63
    (the widest value it can take); returns the header's byte length for
    the later rewrite."""
    padded = {**meta, **{k: 2**63 for k in total_keys}}
    raw = json.dumps(padded).encode()
    f.write(magic + _HLEN.pack(len(raw)) + raw)
    return f.tell()


def rewrite_header(
    f: BinaryIO, magic: bytes, meta: dict, hdr_len: int
) -> None:
    """Rewrite the header in place with final totals, space-padding the
    JSON to exactly the placeholder's length (json.loads ignores
    trailing whitespace)."""
    raw = json.dumps(meta).encode()
    pad = hdr_len - len(magic) - _HLEN.size - len(raw)
    if pad < 0:
        raise ValueError(
            "final header longer than placeholder — totals grew?"
        )
    raw += b" " * pad
    f.seek(0)
    f.write(magic + _HLEN.pack(len(raw)) + raw)
