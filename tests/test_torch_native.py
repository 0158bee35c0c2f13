"""The port's native parser (xflow_tpu_torch/native, its own build of a
byte-equal copy of the reference's parser.cc) against the reference's
native parser and the port's Python parser, on the cases of
tests/test_native.py: every ParsedBlock and Batch array byte-equal
(same dtype, same values) on structured, malformed, reference-format,
fuzzed, extreme and non-finite input, in both hash modes; murmur64
and the hash seed; the key-range guards; make_parse_fn preferring the
native parser; prefetch and parallel parse equal to sequential parse;
the native pack equal to pack_batch."""

import os

import numpy as np
import pytest

from xflow_tpu import native as ref_native
from xflow_tpu.io.batch import ParsedBlock as RefParsedBlock
from xflow_tpu.io.batch import pack_batch as ref_pack_batch
from xflow_tpu_torch import native
from xflow_tpu_torch.io.batch import ParsedBlock, pack_batch
from xflow_tpu_torch.io.hashing import murmur64
from xflow_tpu_torch.io.libffm import parse_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE = 1 << 16
BLOCK_FIELDS = ("labels", "row_ptr", "keys", "slots", "vals")
BATCH_FIELDS = ("keys", "slots", "vals", "mask", "labels", "weights",
                "hot_keys", "hot_slots", "hot_vals", "hot_mask")


def _same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


def _three_way(data, table=TABLE, hash_mode=True, seed=0):
    """The port's native block, byte-equal to the reference's native
    block and to the port's Python block."""
    ours = native.native_parse_block(data, table, hash_mode, seed)
    _same(ours, ref_native.native_parse_block(data, table, hash_mode, seed), BLOCK_FIELDS)
    _same(ours, parse_block(data, table, hash_mode, seed), BLOCK_FIELDS)
    return ours


def test_parser_source_is_the_references():
    with open(os.path.join(REPO, "xflow_tpu", "native", "src", "parser.cc"), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "xflow_tpu_torch", "native", "src", "parser.cc"), "rb") as f:
        assert f.read() == want


def test_library_builds_into_the_ports_build_dir():
    from xflow_tpu_torch.native.build import BUILD_DIR, library_path

    assert native.available()
    path = library_path()
    assert path.exists() and path.parent == BUILD_DIR
    assert BUILD_DIR.name == "_build" and BUILD_DIR.parent.name == "xflow_tpu_torch"


@pytest.mark.parametrize("hash_mode", [True, False])
def test_parity_structured(hash_mode):
    data = (
        b"1\t0:123:0.5 2:456:1.0\n"
        b"0\t1:123:0.25\n"
        b"0.5 3:9:2.5 4:-7:1e-3\n"
        b"1e-8\t0:1:1\n"
        b"-3\t0:2:1\n"
        b"\n"
        b"2 5:77:0.125"  # no trailing newline
    )
    _three_way(data, hash_mode=hash_mode)


@pytest.mark.parametrize("hash_mode", [True, False])
def test_parity_malformed(hash_mode):
    data = (
        b"1\t0:1:1 garbage x:y:z:extra 2:3 :: a:b:c 1:tok:val trailing\n"
        b"notalabel\t0:1:1\n"
        b"nan\t0:1:1\n"
        b"inf\t0:1:1\n"
        b"0\t1:5:1\n"
        b"   \n"
        b"1\n"
    )
    _three_way(data, hash_mode=hash_mode)


@pytest.mark.parametrize("hash_mode", [True, False])
def test_parity_reference_format(hash_mode):
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(300):
        feats = " ".join(
            f"{f}:{rng.integers(0, 10000)}:{rng.random():.4f}" for f in range(18)
        )
        lines.append(f"{rng.integers(0, 2)}\t{feats}\n")
    _three_way("".join(lines).encode(), hash_mode=hash_mode)


def test_parity_fuzz():
    # underscore excluded: Python's int()/float() accept "1_0" digit
    # grouping, a documented non-goal of the native parser
    rng = np.random.default_rng(1)
    alphabet = b"0123456789:.eE+- \tabcxyz\n"
    for _ in range(20):
        raw = bytes(alphabet[i] for i in rng.integers(0, len(alphabet), size=2000))
        for hash_mode in (True, False):
            _three_way(raw, hash_mode=hash_mode)


def test_parity_extreme_tokens():
    long_label = b"0." + b"0" * 70 + b"1"  # > 64 chars, valid float
    data = (
        long_label + b"\t0:1:1\n"
        b"1\t0:99999999999999999999:1\n"  # fid > int64: token skipped
        b"1\t99999999999:5:1\n"  # fgid > int32: token skipped
        b"1\t-2147483648:5:1 2147483647:6:1\n"  # int32 bounds kept
        b"1\t0:7:7.038531e-26 0:8:1.1754944e-38\n"  # double-rounding probes
        b"1\t0:9:" + b"1" * 80 + b".5\n"  # long val token
    )
    for hash_mode in (True, False):
        _three_way(data, hash_mode=hash_mode)
    block = _three_way(data, hash_mode=False)
    assert block.num_samples == 6
    assert list(np.diff(block.row_ptr)[1:4]) == [0, 0, 2]


def test_parity_nonfinite_vals():
    data = (
        b"1\t0:1:1e999 1:2:-1e999 2:3:inf 3:4:-inf 4:5:nan 5:6:1e39\n"
        b"0\t0:7:0.5 1:8:-3.25 2:9:3.3e38\n"
        b"1\t0:10:1e-50 1:11:-0.0\n"
    )
    block = _three_way(data, table=1 << 12, hash_mode=False)
    assert np.isfinite(block.vals).all()
    assert list(np.diff(block.row_ptr)) == [0, 3, 2]


def test_native_murmur_and_hash_seed():
    rng = np.random.default_rng(2)
    for n in list(range(0, 33)) + [100, 1000]:
        tok = bytes(rng.integers(0, 256, size=n).astype(np.uint8))
        for seed in (0, 42):
            got = native.native_murmur64(tok, seed)
            assert got == murmur64(tok, seed) == ref_native.native_murmur64(tok, seed)
    _three_way(b"1\t0:sometoken:1\n", seed=99)


def test_native_key_range_guards():
    for table in (1 << 32, -4):
        with pytest.raises(ValueError, match="table_size"):
            native.native_parse_block(b"1\t0:5:1\n", table)

    def block(key):
        return ParsedBlock(
            labels=np.asarray([1.0], np.float32), row_ptr=np.asarray([0, 1], np.int64),
            keys=np.asarray([key], np.int64), slots=np.asarray([0], np.int32),
            vals=np.asarray([1.0], np.float32),
        )

    with pytest.raises(ValueError, match="int32"):
        native.native_pack_batch(block(1 << 33), 0, 1, 4, 4)
    with pytest.raises(ValueError, match="int32"):
        native.native_pack_batch(block(-1), 0, 1, 4, 4)
    got = native.native_pack_batch(block((1 << 31) - 1), 0, 1, 4, 4)
    assert got.keys[0, 0] == (1 << 31) - 1


def _random_csr(rng, n_rows, max_nnz_per_row, table_size):
    counts = rng.integers(0, max_nnz_per_row + 1, n_rows)
    row_ptr = np.zeros(n_rows + 1, np.int64)
    row_ptr[1:] = np.cumsum(counts)
    nnz = int(row_ptr[-1])
    return dict(
        labels=rng.integers(0, 2, n_rows).astype(np.float32), row_ptr=row_ptr,
        keys=rng.integers(0, table_size, nnz).astype(np.int64),
        slots=rng.integers(0, 32, nnz).astype(np.int32),
        vals=rng.random(nnz).astype(np.float32),
    )


def test_native_pack_parity():
    """xf_pack_batch without the hot table: padding and truncation
    byte-equal to the port's pack_batch and to the reference's native
    and numpy packs."""
    rng = np.random.default_rng(42)
    for _ in range(5):
        raw = _random_csr(rng, 57, 12, 512)
        block, ref_block = ParsedBlock(**raw), RefParsedBlock(**raw)
        for start, end in [(0, 57), (0, 16), (40, 57), (5, 6)]:
            b = 16 if end - start <= 16 else 64
            got = native.native_pack_batch(block, start, end, b, 6)
            _same(got, pack_batch(block, start, end, b, 6), BATCH_FIELDS)
            _same(got, ref_native.native_pack_batch(ref_block, start, end, b, 6),
                  BATCH_FIELDS)
            _same(got, ref_pack_batch(ref_block, start, end, b, 6), BATCH_FIELDS)


def test_make_parse_fn_prefers_native(toy_dataset, monkeypatch):
    from xflow_tpu_torch.io import loader as loader_mod
    from xflow_tpu_torch.io.loader import ShardLoader, make_parse_fn, parser_name

    data = open(toy_dataset.train_prefix + "-00000", "rb").read()
    assert parser_name(True) == "native" and parser_name(False) == "python"
    calls = []
    parse = native.native_parse_block
    monkeypatch.setattr(loader_mod.native, "native_parse_block",
                        lambda *a: calls.append(1) or parse(*a))
    fn = make_parse_fn(TABLE, True, 0, prefer_native=True)
    _same(fn(data), parse_block(data, TABLE, True, 0), BLOCK_FIELDS)
    assert calls == [1]
    make_parse_fn(TABLE, True, 0, prefer_native=False)(data)
    assert calls == [1]
    loader = ShardLoader(toy_dataset.train_prefix + "-00000", batch_size=32,
                         max_nnz=16, table_size=TABLE, parse_fn=fn)
    assert loader._native_pack
    total = sum(b.num_real() for b, _ in loader.iter_batches())
    assert total == toy_dataset.lines_per_shard


def _loader(toy_dataset, parse_fn=None, block_mib=1):
    from xflow_tpu_torch.io.loader import ShardLoader

    return ShardLoader(toy_dataset.train_prefix + "-00000", batch_size=32, max_nnz=16,
                       table_size=TABLE, block_mib=block_mib, parse_fn=parse_fn)


def test_native_loader_batches_equal_python_loader(toy_dataset):
    from xflow_tpu.io.loader import ShardLoader as RefShardLoader
    from xflow_tpu.io.loader import make_parse_fn as ref_make_parse_fn
    from xflow_tpu_torch.io.loader import make_parse_fn

    nat = list(_loader(toy_dataset, make_parse_fn(TABLE, prefer_native=True)).iter_batches())
    py = list(_loader(toy_dataset, make_parse_fn(TABLE, prefer_native=False)).iter_batches())
    ref = list(RefShardLoader(toy_dataset.train_prefix + "-00000", batch_size=32,
                              max_nnz=16, table_size=TABLE,
                              parse_fn=ref_make_parse_fn(TABLE)).iter_batches())
    assert len(nat) == len(py) == len(ref) > 2
    for (a, ra), (b, rb), (c, rc) in zip(nat, py, ref):
        _same(a, b, BATCH_FIELDS)
        _same(a, c, BATCH_FIELDS)
        assert ra == rb == rc


@pytest.mark.parametrize("mode", ["prefetch", "parallel"])
def test_prefetch_and_parallel_parse_match_sequential(toy_dataset, mode):
    """With the native parser (which releases the GIL) on worker
    threads, batches and resume offsets arrive in sequential order."""
    from xflow_tpu_torch.io.loader import make_parse_fn

    loader = _loader(toy_dataset, make_parse_fn(TABLE), block_mib=1)
    loader.block_bytes = 2048  # many blocks
    seq = list(loader.iter_batches())
    if mode == "prefetch":
        with loader.prefetch(3, parse_workers=4) as it:
            other = list(it)
    else:
        other = list(loader.iter_batches(parse_workers=4))
    assert len(seq) == len(other) > 2
    for (a, ra), (b, rb) in zip(seq, other):
        _same(a, b, BATCH_FIELDS)
        assert ra == rb
