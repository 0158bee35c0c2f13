"""The port's host input path (io/ and the compact wire) against the
reference: hashing, the Python parser, padding and the wire planes must
be byte-equal."""

import numpy as np
import pytest

from xflow_tpu.io import batch as ref_batch
from xflow_tpu.io.hashing import murmur64 as ref_murmur64
from xflow_tpu.io.hashing import murmur64_batch as ref_murmur64_batch
from xflow_tpu.io.libffm import parse_block as ref_parse_block
from xflow_tpu.parallel.step import compact_wire_np as ref_compact_wire_np
from xflow_tpu_torch.io import batch as port_batch
from xflow_tpu_torch.io.hashing import murmur64, murmur64_batch
from xflow_tpu_torch.io.libffm import parse_block
from xflow_tpu_torch.io.loader import make_parse_fn
from xflow_tpu_torch.parallel.step import compact_wire_np

PLANES = ("keys", "slots", "vals", "mask", "labels", "weights")


def _assert_planes_equal(ours, ref, planes=PLANES):
    for name in planes:
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        assert a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_murmur64_matches_reference_on_random_tokens():
    rng = np.random.default_rng(3)
    tokens = [
        rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
        for n in rng.integers(0, 40, size=600)
    ]
    got = murmur64_batch(tokens, seed=11)
    want = ref_murmur64_batch(tokens, seed=11)
    assert got.dtype == want.dtype == np.uint64
    assert np.array_equal(got, want)
    for t in tokens[:50]:
        assert murmur64(t, 11) == ref_murmur64(t, 11)


@pytest.mark.parametrize("hash_mode", [True, False], ids=["hash", "numeric"])
def test_parse_and_pack_planes_byte_equal(toy_dataset, hash_mode):
    data = open(toy_dataset.train_prefix + "-00000", "rb").read()
    # a malformed line and a malformed token are skipped the same way
    data += b"garbage line\n1\t3:x:1 bad 4:7:2.5\n"
    table = 1 << 14
    ours = make_parse_fn(table, hash_mode, 5)(data)
    ref = ref_parse_block(data, table, hash_mode, 5)
    for name in ("labels", "row_ptr", "keys", "slots", "vals"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    n = ours.num_samples
    for start, end, bsz, nnz in ((0, 64, 64, 24), (64, 100, 64, 8), (0, n, n, 40)):
        _assert_planes_equal(
            port_batch.pack_batch(ours, start, end, bsz, nnz),
            ref_batch.pack_batch(ref, start, end, bsz, nnz),
        )


def test_parse_block_full_keys_and_empty():
    data = b"1\t1:abc:1 2:def:1\n0\t3:ghi:1\n"
    assert np.array_equal(parse_block(data, 0).keys, ref_parse_block(data, 0).keys)
    assert parse_block(b"", 1024).num_samples == 0


def test_pad_batch_rows_and_compact_wire_equal(toy_dataset):
    data = open(toy_dataset.test_prefix + "-00000", "rb").read()
    table = 1 << 12
    block = parse_block(data, table)
    ours = port_batch.pack_batch(block, 0, 37, 37, 24)
    ref = ref_batch.pack_batch(ref_parse_block(data, table), 0, 37, 37, 24)
    _assert_planes_equal(
        port_batch.pad_batch_rows(ours, 64), ref_batch.pad_batch_rows(ref, 64)
    )
    assert port_batch.pad_batch_rows(ours, 37) is ours
    with pytest.raises(ValueError, match="cannot shrink"):
        port_batch.pad_batch_rows(ours, 8)
    got, want = compact_wire_np(ours), ref_compact_wire_np(ref)
    assert set(got) == set(want)
    for name in got:
        assert got[name].dtype == want[name].dtype
        assert np.array_equal(got[name], want[name]), name


def test_narrow_keys_i32_rejects_like_reference():
    ok = np.array([0, 5, 2**31 - 1], np.int64)
    assert np.array_equal(
        port_batch.narrow_keys_i32(ok), ref_batch.narrow_keys_i32(ok)
    )
    for bad in (np.array([2**31], np.int64), np.array([-(2**31) - 1], np.int64)):
        with pytest.raises(ValueError, match="exceeds int32"):
            port_batch.narrow_keys_i32(bad)
        with pytest.raises(ValueError, match="exceeds int32"):
            ref_batch.narrow_keys_i32(bad)
