"""Packed-batch cache: device-ready batches on disk (the reference's
io/packed.py, in its on-disk format: the port reads the reference's
shards and the reference reads the port's).

Reading a packed shard is a header-driven buffer slice: no parse, no
batch assembly.  A cache bakes in batch_size, max_nnz, table_size, the
hash settings, the hot geometry and the hot remap (keys are stored
POST-remap, steered into hot/cold sections; the header carries the
remap's sha256), and the loader refuses a cache built for another
geometry or remap.  A hot model packs with the remap its trainer saved
as ``checkpoint_dir/remap.npy``, and trains from the shards with that
same directory.

Format (little-endian):

    magic   8 bytes  b"XFPB0001"
    hlen    u32, header JSON:
      {"version": 1 | 2, "batch_size": B, "cold_nnz": K, "hot_nnz": Kh,
       "hot_size": H, "table_size": T, "hash_mode": bool,
       "hash_seed": int, "remap_sha256": hex|null, "batches": n,
       "examples": n, v2: "dict_cap", "granule_div", "granule_min",
       "key_bytes", "hx16"}

v1 records have constant size, the concatenation of
      keys i32[B,K] | slots i32[B,K] | vals f32[B,K] | mask f32[B,K]
      | hot_keys i32[B,Kh] | hot_slots i32[B,Kh] | hot_vals f32[B,Kh]
      | hot_mask f32[B,Kh] | labels f32[B] | weights f32[B];
v2 records (the default wherever compaction applies) are CompactBatch
planes (io/compact.py) behind a fixed counts header, so a dictionary-
wire trainer ships them as they are, with no per-batch host work.

Tail safety: every writer streams into ``<dst>.tmp.<pid>``, fsyncs and
``os.replace``s on finalize, so no reader sees a half-written shard.

Convert text or binary block-cache shards from the command line:

    python -m xflow_tpu_torch.io.packed --train PREFIX --out PREFIX.pk \
        --batch-size N --max-nnz K --table-size-log2 T \
        [--hot-size-log2 H --hot-nnz Kh --remap remap.npy] [--no-hash] [...]
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import BinaryIO, Iterator

import numpy as np

from xflow_tpu_torch.chaos import failpoint
from xflow_tpu_torch.io import container
from xflow_tpu_torch.io.batch import Batch

MAGIC = b"XFPB0001"

# v2: records hold CompactBatch planes (io/compact.py) instead of the
# padded [B, K] arrays, and the reader hands the trainer pre-compacted
# batches.  Records are variable-size (content-sized planes under plane_cap
# bucketing), each prefixed by a fixed binary counts header; resume
# offsets are validated by walking the record chain (a packed shard
# holds ~examples/B records — double digits — so the walk is free).
_REC_HEADER = struct.Struct("<8q")  # n_real n_cold n_dict n_dict_occ
#                                     n_hot n_h8 slots_code rec_bytes


def remap_digest(remap: np.ndarray | None) -> str | None:
    if remap is None:
        return None
    return hashlib.sha256(
        np.ascontiguousarray(remap, np.int32).tobytes()
    ).hexdigest()


def is_packed_shard(path: str) -> bool:
    return container.sniff(path, MAGIC)


def read_header(f: BinaryIO) -> tuple[dict, int]:
    return container.read_header(f, MAGIC, "packed shard", version=(1, 2))


def _layout(meta: dict) -> tuple[list[tuple[str, tuple, np.dtype]], int]:
    """(field, shape, dtype) per record section, and the record size."""
    b = meta["batch_size"]
    k = meta["cold_nnz"]
    kh = meta["hot_nnz"]
    fields = [
        ("keys", (b, k), np.dtype(np.int32)),
        ("slots", (b, k), np.dtype(np.int32)),
        ("vals", (b, k), np.dtype(np.float32)),
        ("mask", (b, k), np.dtype(np.float32)),
        ("hot_keys", (b, kh), np.dtype(np.int32)),
        ("hot_slots", (b, kh), np.dtype(np.int32)),
        ("hot_vals", (b, kh), np.dtype(np.float32)),
        ("hot_mask", (b, kh), np.dtype(np.float32)),
        ("labels", (b,), np.dtype(np.float32)),
        ("weights", (b,), np.dtype(np.float32)),
    ]
    size = sum(int(np.prod(s)) * d.itemsize for _, s, d in fields)
    return fields, size


def check_compat(
    meta: dict,
    *,
    batch_size: int,
    cold_nnz: int,
    hot_nnz: int,
    hot_size: int,
    table_size: int,
    hash_mode: bool,
    hash_seed: int,
    remap: np.ndarray | None,
) -> None:
    """Raise unless the cache was built for exactly this batch config."""
    want = {
        "batch_size": batch_size,
        "cold_nnz": cold_nnz,
        "hot_nnz": hot_nnz,
        "hot_size": hot_size,
        "table_size": table_size,
        "hash_mode": bool(hash_mode),
        "remap_sha256": remap_digest(remap),
    }
    for key, val in want.items():
        if meta.get(key) != val:
            raise ValueError(
                f"packed shard built with {key}={meta.get(key)!r}, "
                f"loader expects {val!r} — rebuild the cache "
                "(python -m xflow_tpu_torch.io.packed)"
            )
    if meta["hash_mode"] and int(meta["hash_seed"]) != int(hash_seed):
        raise ValueError(
            f"packed shard hashed with seed {meta['hash_seed']}, "
            f"loader expects {hash_seed}"
        )


def write_shard(
    dst: str, meta: dict, batches: Iterator[Batch]
) -> dict:
    """Stream ``batches`` into a packed shard (atomic temp + rename).
    ``meta`` must hold the config keys of check_compat; totals are
    filled in here."""
    fields, _ = _layout(meta)
    # chaos site: a writer fault mid-shard (the tmp + fsync +
    # os.replace tail safety below)
    failpoint("packed.write")
    tmp = f"{dst}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    n_batches = 0
    examples = 0
    try:
        with open(tmp, "wb") as f:
            header = {"version": 1, **meta}
            hdr_len = container.write_placeholder_header(
                f, MAGIC, header, ("batches", "examples")
            )
            for batch in batches:
                for name, shape, dtype in fields:
                    arr = getattr(batch, name)
                    if arr.shape != shape or arr.dtype != dtype:
                        raise ValueError(
                            f"batch field {name}: {arr.shape}/{arr.dtype} "
                            f"!= cache layout {shape}/{dtype}"
                        )
                    f.write(np.ascontiguousarray(arr).tobytes())
                n_batches += 1
                examples += batch.num_real()
            header.update({"batches": n_batches, "examples": examples})
            container.rewrite_header(f, MAGIC, header, hdr_len)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, dst)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    header.pop("version")
    return header


def write_shard_v2(
    dst: str, meta: dict, batches: Iterator[Batch]
) -> dict:
    """Stream ``batches`` through host compaction (io/compact.py) into
    a v2 packed shard of CompactBatch records (atomic temp + rename).
    ``meta`` must hold the config keys of check_compat; wire parameters
    and totals are filled in here."""
    from xflow_tpu_torch.io import compact as C

    failpoint("packed.write")
    tmp = f"{dst}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    key_bytes = 3 if meta["table_size"] <= 1 << 24 else 4
    hx16 = meta["hot_size"] > 1 << 12
    header = {
        "version": 2,
        **meta,
        "dict_cap": C.DICT_CAP,
        "granule_div": C.GRANULE_DIV,
        "granule_min": C.GRANULE_MIN,
        "key_bytes": key_bytes,
        "hx16": hx16,
    }
    n_batches = 0
    examples = 0
    try:
        with open(tmp, "wb") as f:
            hdr_len = container.write_placeholder_header(
                f, MAGIC, header, ("batches", "examples")
            )
            for batch in batches:
                cb = C.CompactBatch.from_batch(
                    batch,
                    meta["table_size"],
                    meta["hot_size"],
                    check=n_batches == 0,
                    strict_layout=True,
                )
                specs = C.plane_specs(
                    batch_size=cb.batch_size,
                    cold_nnz=cb.cold_nnz,
                    hot_nnz_cap=cb.hot_nnz_cap,
                    key_bytes=cb.key_bytes,
                    hx16=cb.hx16,
                    slots_code=cb.slots_code,
                    n_cold=cb.n_cold,
                    n_dict=cb.n_dict,
                    n_dict_occ=cb.n_dict_occ,
                    n_hot=cb.n_hot,
                    n_h8=cb.n_h8,
                )
                if cb.key_bytes != key_bytes or cb.hx16 != hx16:
                    raise ValueError(
                        "compact batch wire parameters drifted from "
                        "the shard header — geometry mismatch?"
                    )
                blobs = []
                for name, shape, dtype in specs:
                    arr = getattr(cb, name)
                    if arr.shape != shape or arr.dtype != dtype:
                        raise ValueError(
                            f"record plane {name}: {arr.shape}/"
                            f"{arr.dtype} != spec {shape}/{dtype}"
                        )
                    blobs.append(np.ascontiguousarray(arr).tobytes())
                body = b"".join(blobs)
                f.write(_REC_HEADER.pack(
                    cb.n_real, cb.n_cold, cb.n_dict, cb.n_dict_occ,
                    cb.n_hot, cb.n_h8, cb.slots_code,
                    _REC_HEADER.size + len(body),
                ))
                f.write(body)
                n_batches += 1
                examples += cb.n_real
            header.update({"batches": n_batches, "examples": examples})
            container.rewrite_header(f, MAGIC, header, hdr_len)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, dst)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    header.pop("version")
    return header


def _iter_records_v2(f: BinaryIO, meta: dict, start_offset: int):
    """Yield (CompactBatch, offset, next_offset) over a v2 shard.
    Record planes are read-only zero-copy views of the mmap; the mmap
    outlives ``f`` (numpy views hold it via .base)."""
    import mmap

    from xflow_tpu_torch.io import compact as C

    f.seek(0)
    _, data_start = read_header(f)
    # schema-check the JSON meta BEFORE any arithmetic consumes it: a
    # corrupt header (fuzzed/bit-rotted JSON values of the wrong type)
    # must be a typed refusal, not a TypeError deep in plane sizing
    try:
        b = int(meta["batch_size"])
        kc = int(meta["cold_nnz"])
        kh = int(meta["hot_nnz"])
        dict_cap = int(meta["dict_cap"])
        key_bytes = int(meta["key_bytes"])
        hx16 = bool(meta["hx16"])
        gdiv = int(meta["granule_div"])
        gmin = int(meta["granule_min"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(
            f"packed shard header meta malformed: {e!r}"
        ) from e
    if b <= 0 or kc < 0 or kh < 0 or dict_cap < 0 or gdiv <= 0 \
            or gmin < 0 or key_bytes not in (3, 4):
        raise ValueError(
            "packed shard header meta out of range "
            f"(batch_size={b} cold_nnz={kc} hot_nnz={kh} "
            f"dict_cap={dict_cap} key_bytes={key_bytes} "
            f"granule_div={gdiv} granule_min={gmin})"
        )
    try:
        mm: memoryview | bytes | mmap.mmap = mmap.mmap(
            f.fileno(), 0, access=mmap.ACCESS_READ
        )
        if hasattr(mmap, "MADV_SEQUENTIAL"):
            mm.madvise(mmap.MADV_SEQUENTIAL)
    except (ValueError, OSError):
        f.seek(0)
        mm = f.read()  # unmmapable stream: buffer it
    end = len(mm)
    offset = data_start
    start_offset = max(int(start_offset), data_start)
    if start_offset > end:
        raise ValueError(
            f"resume offset {start_offset} is past the packed shard "
            f"end {end} — was the cache rebuilt since the checkpoint?"
        )
    boundary_ok = start_offset == data_start
    while offset < end:
        if offset + _REC_HEADER.size > end:
            raise ValueError("truncated packed shard record")
        (
            n_real, n_cold, n_dict, n_dict_occ, n_hot, n_h8,
            slots_code, rec_bytes,
        ) = _REC_HEADER.unpack_from(mm, offset)
        if rec_bytes <= 0 or offset + rec_bytes > end:
            raise ValueError("truncated packed shard record")
        next_offset = offset + rec_bytes
        if offset == start_offset:
            boundary_ok = True
        if offset >= start_offset:
            if not boundary_ok:
                raise ValueError(
                    f"start_offset {start_offset} is not a record "
                    "boundary"
                )
            # range-check every header count against the shard meta
            # BEFORE sizing planes: a corrupt/adversarial header must
            # raise here, not address planes out of bounds or hand the
            # model a silently-wrong batch (wirefuzz pins this)
            ok = (
                0 <= n_real <= b
                and 0 <= n_cold <= b * kc
                and 0 <= n_dict_occ <= n_cold
                and 0 <= n_dict <= n_dict_occ
                and n_dict <= dict_cap
                and 0 <= n_hot <= b * kh
                and 0 <= n_h8 <= n_hot
                and 0 <= slots_code < len(C._SLOT_DTYPES)
            )
            if not ok:
                raise ValueError(
                    "packed shard record header counts out of range "
                    f"(n_real={n_real} n_cold={n_cold} n_dict={n_dict} "
                    f"n_dict_occ={n_dict_occ} n_hot={n_hot} n_h8={n_h8} "
                    f"slots_code={slots_code} vs batch_size={b} "
                    f"cold_nnz={kc} hot_nnz={kh}) — corrupt record"
                )
            counts = {
                "n_real": n_real, "n_cold": n_cold, "n_dict": n_dict,
                "n_dict_occ": n_dict_occ, "n_hot": n_hot,
                "n_h8": n_h8, "slots_code": slots_code,
            }
            specs = C.plane_specs(
                batch_size=b,
                cold_nnz=kc,
                hot_nnz_cap=kh,
                key_bytes=key_bytes,
                hx16=hx16,
                slots_code=slots_code,
                dict_cap=dict_cap,
                granule_div=gdiv,
                granule_min=gmin,
                **{k: counts[k] for k in (
                    "n_cold", "n_dict", "n_dict_occ", "n_hot", "n_h8"
                )},
            )
            pos = offset + _REC_HEADER.size
            planes = {}
            for name, shape, dtype in specs:
                count = int(np.prod(shape))
                planes[name] = np.frombuffer(
                    mm, dtype, count=count, offset=pos
                ).reshape(shape)
                pos += count * dtype.itemsize
            if pos > next_offset:
                raise ValueError("packed shard record size mismatch")
            yield C.from_planes(meta, counts, planes), offset, next_offset
        offset = next_offset
    if not boundary_ok and start_offset != offset:
        raise ValueError(
            f"start_offset {start_offset} is not a record boundary"
        )


def iter_compact_batches(
    f: BinaryIO, start_offset: int = 0
):
    """Yield (CompactBatch, offset, next_offset) from a v2 shard (raises
    on v1 — those records hold padded arrays, not compact planes)."""
    f.seek(0)
    meta, _ = read_header(f)
    if meta.get("version", 1) != 2:
        raise ValueError("iter_compact_batches requires a v2 packed shard")
    yield from _iter_records_v2(f, meta, start_offset)


def iter_batches(
    f: BinaryIO, start_offset: int = 0
) -> Iterator[tuple[Batch, int, int]]:
    """Yield (batch, offset, next_offset).  Batch arrays are read-only
    zero-copy views of each record's buffer — the whole point of this
    format; copy before mutating.

    Records are mmap-backed: a consumer that only touches some fields
    (the compact wire reads keys/mask/labels and skips vals/slots —
    half the record) never pages the rest in, which roughly doubles the
    measured host feed rate over the old read()-a-record path.  The
    mmap outlives ``f`` (numpy views hold it via .base), so batches may
    be used after the file is closed.

    v2 shards hold CompactBatch records; this interface expands them
    to padded Batches (byte-exact — io/compact.py) so every consumer
    of the v1 contract keeps working.  Consumers that can feed the
    dict wire directly use ``iter_compact_batches`` and skip both the
    expansion and the re-compaction (ShardLoader emit_compact)."""
    import mmap

    f.seek(0)
    meta, data_start = read_header(f)
    if meta.get("version", 1) == 2:
        for cb, off, noff in _iter_records_v2(f, meta, start_offset):
            yield cb.expand(), off, noff
        return
    fields, rec_size = _layout(meta)
    offset = max(int(start_offset), data_start)
    if (offset - data_start) % rec_size:
        raise ValueError(
            f"start_offset {start_offset} is not a record boundary"
        )
    try:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        if hasattr(mmap, "MADV_SEQUENTIAL"):
            mm.madvise(mmap.MADV_SEQUENTIAL)
    except (ValueError, OSError):
        mm = None  # unmmapable stream (pipe, empty file): read() path

    def record(buf, base):
        pos = base
        kw = {}
        for name, shape, dtype in fields:
            kw[name] = np.frombuffer(
                buf, dtype, count=int(np.prod(shape)), offset=pos
            ).reshape(shape)
            pos += int(np.prod(shape)) * dtype.itemsize
        return Batch(**kw)

    if mm is not None:
        end = len(mm)
        if offset > end:
            # A resume cursor past EOF means the cache was rebuilt
            # shorter since the checkpoint — distinguish it from a
            # partial trailing record, and fail the same way the CSR
            # cache does (binary.py 'start_offset ... past the shard
            # end') rather than silently dropping the shard remainder.
            raise ValueError(
                f"resume offset {offset} is past the packed shard end "
                f"{end} — was the cache rebuilt since the checkpoint?"
            )
        while offset + rec_size <= end:
            yield record(mm, offset), offset, offset + rec_size
            offset += rec_size
        if offset < end:
            raise ValueError("truncated packed shard record")
        return
    f.seek(offset)
    while True:
        buf = f.read(rec_size)
        if not buf:
            return
        if len(buf) != rec_size:
            raise ValueError("truncated packed shard record")
        yield record(buf, 0), offset, offset + rec_size
        offset += rec_size


def shard_example_count(path: str) -> int:
    # metadata peek: the header's totals
    with open(path, "rb") as f:
        meta, _ = read_header(f)
        return int(meta["examples"])


def split_shard_v2(
    src: str, dst_prefix: str, num_shards: int
) -> list[str]:
    """Split one packed-v2 shard into up to ``num_shards`` contiguous
    sub-shards ``<dst_prefix>-%05d`` — the corpus shape the input
    fan-out (io/fanout.py) distributes across reader streams.

    Records are self-contained (each carries its counts header and its
    planes), so the split is a raw byte copy over the validated record
    walk: no decode, no re-encode, and the concatenation of the
    sub-shards' record streams is byte-identical to the source's.  Each
    sub-shard gets the source header with its own batches/examples
    totals; writers use the shared tail-safe tmp+fsync+os.replace
    protocol.  Returns the written paths (fewer than ``num_shards``
    when the source has fewer records)."""
    import mmap

    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    failpoint("packed.write")
    with open(src, "rb") as f:
        meta, data_start = read_header(f)
        if meta.get("version", 1) != 2:
            raise ValueError("split_shard_v2 requires a v2 packed shard")
        try:
            # O(record) resident memory at any shard size (the same
            # mmap discipline as the readers); only unmmapable streams
            # pay a full buffer
            blob: mmap.mmap | bytes = mmap.mmap(
                f.fileno(), 0, access=mmap.ACCESS_READ
            )
        except (ValueError, OSError):
            f.seek(0)
            blob = f.read()
        # record spans via the same walk _iter_records_v2 validates
        spans: list[tuple[int, int, int]] = []  # (offset, next, n_real)
        offset = data_start
        end = len(blob)
        while offset < end:
            if offset + _REC_HEADER.size > end:
                raise ValueError("truncated packed shard record")
            fields = _REC_HEADER.unpack_from(blob, offset)
            n_real, rec_bytes = fields[0], fields[7]
            if rec_bytes <= 0 or offset + rec_bytes > end:
                raise ValueError("truncated packed shard record")
            spans.append((offset, offset + rec_bytes, n_real))
            offset += rec_bytes
        n_out = max(1, min(num_shards, len(spans)))
        per = -(-len(spans) // n_out) if spans else 0
        paths = []
        for i in range(n_out):
            chunk = spans[i * per: (i + 1) * per]
            if not chunk:
                break
            dst = f"{dst_prefix}-{i:05d}"
            tmp = f"{dst}.tmp.{os.getpid()}"
            header = dict(meta)
            try:
                with open(tmp, "wb") as out:
                    hdr_len = container.write_placeholder_header(
                        out, MAGIC, header, ("batches", "examples")
                    )
                    for lo, hi, _ in chunk:
                        out.write(blob[lo:hi])
                    header.update({
                        "batches": len(chunk),
                        "examples": int(sum(r for _, _, r in chunk)),
                    })
                    container.rewrite_header(out, MAGIC, header, hdr_len)
                    out.flush()
                    os.fsync(out.fileno())
                os.replace(tmp, dst)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            paths.append(dst)
    return paths


def convert_shard(
    src: str,
    dst: str,
    *,
    batch_size: int,
    max_nnz: int,
    table_size: int,
    hot_size: int = 0,
    hot_nnz: int = 0,
    hash_mode: bool = True,
    hash_seed: int = 0,
    block_mib: float = 8,
    remap: np.ndarray | None = None,
    parse_fn=None,
    fmt: str = "auto",
) -> dict:
    """Pack one shard (text or CSR-binary — ShardLoader sniffs) into
    device-ready batches, remapped and steered for a hot geometry.
    ``fmt``: "v1" = padded-array records, "v2" = compacted records
    (io/compact.py — smaller, and pre-compacted for the dictionary
    wire), "auto" = v2 whenever the compaction invariants hold (hash
    mode; u8 per-row counts; hot ids fit the tiered encoding)."""
    from xflow_tpu_torch.io.loader import ShardLoader

    loader = ShardLoader(
        src, batch_size=batch_size, max_nnz=max_nnz, table_size=table_size,
        block_mib=max(1, int(block_mib)), hash_mode=hash_mode,
        hash_seed=hash_seed, parse_fn=parse_fn, remap=remap,
        hot_size=hot_size, hot_nnz=hot_nnz,
    )
    loader.block_bytes = max(1, int(block_mib * (1 << 20)))
    meta = {
        "batch_size": batch_size,
        "cold_nnz": max_nnz,
        "hot_nnz": hot_nnz if hot_size else 0,
        "hot_size": hot_size,
        "table_size": table_size,
        "hash_mode": bool(hash_mode),
        "hash_seed": int(hash_seed),
        "remap_sha256": remap_digest(remap),
    }
    if fmt not in ("auto", "v1", "v2"):
        raise ValueError(f"unknown packed format {fmt!r}")
    v2_ok = (
        bool(hash_mode)
        and max_nnz <= 255
        and (hot_nnz if hot_size else 0) <= 255
        and (not hot_size or hot_size <= 1 << 16)
    )
    if fmt == "v2" and not v2_ok:
        raise ValueError(
            "packed v2 requires hash_mode, max_nnz/hot_nnz <= 255 "
            "and hot_size <= 2^16"
        )
    writer = write_shard_v2 if (fmt == "v2" or (fmt == "auto" and v2_ok)) \
        else write_shard
    return writer(dst, meta, (b for b, _ in loader.iter_batches()))


def main(argv=None) -> int:
    import argparse

    from xflow_tpu_torch.io import freq
    from xflow_tpu_torch.io.loader import make_parse_fn
    from xflow_tpu_torch.trainer import find_shards

    p = argparse.ArgumentParser(
        prog="xflow_tpu_torch.io.packed",
        description="pack shards into device-ready batch caches",
    )
    p.add_argument("--train", required=True, help="text/CSR shard prefix")
    p.add_argument("--out", required=True, help="output shard prefix")
    p.add_argument("--batch-size", type=int, required=True)
    p.add_argument("--max-nnz", type=int, required=True)
    p.add_argument("--table-size-log2", type=int, required=True)
    p.add_argument("--hot-size-log2", type=int, default=0)
    p.add_argument("--hot-nnz", type=int, default=0)
    p.add_argument("--remap", help=".npy hot remap (the trainer's remap.npy)")
    p.add_argument("--no-hash", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--block-mib", type=float, default=8)
    p.add_argument(
        "--format", choices=("auto", "v1", "v2"), default="auto",
        help="record format: v2 = compacted records (the default where "
        "eligible)",
    )
    a = p.parse_args(argv)
    remap = freq.load_remap(a.remap) if a.remap else None
    if a.hot_size_log2 and remap is None:
        p.error("--hot-size-log2 requires --remap (trainer's remap.npy)")
    table_size = 1 << a.table_size_log2
    parse_fn = make_parse_fn(table_size, not a.no_hash, a.seed)
    for i, src in enumerate(find_shards(a.train)):
        dst = f"{a.out}-{i:05d}" if src != a.train else a.out
        meta = convert_shard(
            src, dst, batch_size=a.batch_size, max_nnz=a.max_nnz,
            table_size=table_size,
            hot_size=(1 << a.hot_size_log2) if a.hot_size_log2 else 0,
            hot_nnz=a.hot_nnz, hash_mode=not a.no_hash, hash_seed=a.seed,
            block_mib=a.block_mib, remap=remap, parse_fn=parse_fn, fmt=a.format,
        )
        print(f"{src} -> {dst}: {meta['examples']} examples in "
              f"{meta['batches']} batches")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
