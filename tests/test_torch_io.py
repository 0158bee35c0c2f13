"""The port's host input path (io/ and the compact wire) against the
reference: hashing, the Python parser, the block reader, the shard
loader's batches and resume offsets, padding and the wire planes must
be byte-equal."""

import json

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


def _loader_pairs(path, hash_mode, block_bytes, parse_workers=0, depth=0):
    """(planes, resume) per batch from the reference's ShardLoader (its
    Python parser) and the port's, both with ``block_bytes`` blocks."""
    from xflow_tpu.io.loader import ShardLoader as RefLoader
    from xflow_tpu.io.loader import make_parse_fn as ref_make_parse_fn
    from xflow_tpu_torch.io.loader import ShardLoader

    table = 1 << 12
    ref = RefLoader(path, 64, 24, table, hash_mode=hash_mode, hash_seed=3,
                    parse_fn=ref_make_parse_fn(table, hash_mode, 3, prefer_native=False))
    ours = ShardLoader(path, 64, 24, table, hash_mode=hash_mode, hash_seed=3)
    ref.block_bytes = ours.block_bytes = block_bytes
    want = list(ref.iter_batches(0, parse_workers))
    it = ours.prefetch(depth, 0, parse_workers)
    with it:
        got = list(it)
    return got, want


@pytest.mark.parametrize("hash_mode", [True, False], ids=["hash", "numeric"])
@pytest.mark.parametrize("block_bytes, workers, depth", [
    (1000, 0, 0),  # blocks of ~8 lines: every batch spans blocks
    (777, 3, 2),  # parse workers and the prefetch thread
    (1 << 20, 0, 2),  # one block per shard
])
def test_shard_loader_batches_equal_reference(toy_dataset, hash_mode, block_bytes,
                                              workers, depth):
    path = toy_dataset.train_prefix + "-00001"
    got, want = _loader_pairs(path, hash_mode, block_bytes, workers, depth)
    assert len(got) == len(want) == 4  # 200 lines: 3 full batches + 8
    for (gb, gr), (wb, wr) in zip(got, want):
        assert gr == wr
        _assert_planes_equal(gb, wb)


def test_block_reader_and_parse_file_equal_reference(toy_dataset, tmp_path):
    import io

    from xflow_tpu.io.libffm import BlockReader as RefBlockReader
    from xflow_tpu.io.libffm import parse_file as ref_parse_file
    from xflow_tpu_torch.io.libffm import BlockReader, open_block_stream, parse_file

    data = open(toy_dataset.test_prefix + "-00000", "rb").read() + b"1\t1:x:1"  # no final newline
    for size in (1, 100, 4096):
        assert list(BlockReader(io.BytesIO(data), size)) == list(
            RefBlockReader(io.BytesIO(data), size)
        )
    path = str(tmp_path / "shard")
    open(path, "wb").write(data)
    a, b = parse_file(path, 1 << 10), ref_parse_file(path, 1 << 10)
    assert np.array_equal(a.keys, b.keys) and np.array_equal(a.row_ptr, b.row_ptr)
    assert b"".join(open_block_stream(path, 1)) == data


def test_shard_loader_quarantines_unparseable_blocks(tmp_path):
    from xflow_tpu.obs.schema import validate_rows
    from xflow_tpu_torch.io.loader import QuarantineExceeded, ShardLoader
    from xflow_tpu_torch.obs import Obs
    from xflow_tpu_torch.utils.logging import MetricsLogger

    lines = [f"{i % 2}\t1:{i}:1 2:{i + 7}:1\n" for i in range(40)]
    lines[25] = "BAD\n"
    path = str(tmp_path / "shard")
    open(path, "w").write("".join(lines))

    def parse(raw):
        if b"BAD" in raw:
            raise ValueError("corrupt block")
        return parse_block(raw, 1 << 10)

    metrics = str(tmp_path / "m.jsonl")
    with MetricsLogger(metrics) as logger:
        obs = Obs(metrics_logger=logger)
        loader = ShardLoader(path, 8, 4, 1 << 10, parse_fn=parse, obs=obs,
                             io_retry_backoff_s=0.0, max_quarantined_frac=0.5)
        loader.block_bytes = 60  # a few lines per block
        batches = list(loader.iter_batches())
    seen = sum(b.num_real() for b, _ in batches)
    assert 0 < 40 - seen <= 4  # the bad line's block was skipped
    assert obs.registry.snapshot().counters["loader.quarantined"] == 1
    rows = [json.loads(line) for line in open(metrics)]
    assert [r["cause"] for r in rows] == ["record_quarantined"]
    assert validate_rows(rows) == []
    # every block corrupt: the second quarantine exceeds a budget of 1
    strict = ShardLoader(path, 8, 4, 1 << 10, parse_fn=lambda raw: parse(b"BAD"),
                         io_retry_backoff_s=0.0, max_quarantined_frac=0.0)
    strict.block_bytes = 60
    with pytest.raises(QuarantineExceeded):
        list(strict.iter_batches())


def test_shard_loader_refuses_binary_and_packed_shards(tmp_path):
    """Binary block-cache and packed shards load (tests/test_torch_binary.py,
    tests/test_torch_packed.py), so either magic over a header that
    does not parse is refused as a malformed shard."""
    from xflow_tpu_torch.io import binary, packed
    from xflow_tpu_torch.io.loader import ShardLoader

    path = str(tmp_path / "cache")
    open(path, "wb").write(binary.MAGIC + b"\0" * 64)
    with pytest.raises(ValueError):
        list(ShardLoader(path, 8, 4, 1 << 10).iter_batches())
    open(path, "wb").write(packed.MAGIC + b"\0" * 64)
    with pytest.raises(ValueError):
        list(ShardLoader(path, 8, 4, 1 << 10).iter_batches())


def test_prefetch_propagates_errors_and_closes():
    from xflow_tpu_torch.io.loader import _PrefetchIter

    def boom():
        yield 1
        raise RuntimeError("producer failed")

    it = _PrefetchIter(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)
    slow = _PrefetchIter(iter(range(100)), depth=1)
    assert next(slow) == 0
    slow.close()
    assert not slow.alive
    with pytest.raises(StopIteration):
        next(slow)
    slow.close()  # idempotent


def test_synth_generator_byte_equal_to_gen_synth(tmp_path):
    """io/synth.py is a copy of scripts/gen_synth.py: the same arguments
    write the same bytes, and the planted models agree."""
    import scripts.gen_synth as ref_synth
    from xflow_tpu_torch.io import synth

    for mod, name in ((ref_synth, "ref"), (synth, "port")):
        mod.generate_dataset(str(tmp_path / name), num_train=3000, num_test=1000,
                             train_shards=2, seed=11, chunk=1024, zipf_a=1.1)
    for shard in ("train-00000", "train-00001", "test-00000"):
        assert (tmp_path / f"port.{shard}").read_bytes() == (
            tmp_path / f"ref.{shard}").read_bytes(), shard
    assert np.array_equal(synth.hidden_weights(5, 0.3), ref_synth.hidden_weights(5, 0.3))


def test_synth_read_shard_and_planted_pctr(tmp_path):
    """read_shard decodes the generator's fixed-width lines as the
    reference parser reads them, and planted_pctr scores them with the
    planted model (the check scripts/gen_synth.py's test makes)."""
    from xflow_tpu.io.libffm import parse_block as parse_ref
    from xflow_tpu_torch.io import synth

    path = str(tmp_path / "s.train-00000")
    synth.generate_shard(path, 2000, seed=9)
    labels, ids = synth.read_shard(path)
    with open(path, "rb") as f:
        block = parse_ref(f.read(), 0, hash_mode=False)
    assert np.array_equal(labels, block.labels.astype(np.uint8))
    gids = block.keys.reshape(-1, synth.FIELDS)
    assert np.array_equal(gids // synth.VOCAB, np.tile(np.arange(synth.FIELDS), (2000, 1)))
    assert np.array_equal(ids, gids % synth.VOCAB)
    w = synth.hidden_weights(9)
    want = 1.0 / (1.0 + np.exp(-(w[gids // synth.VOCAB, gids % synth.VOCAB].sum(1) - 1.0)))
    np.testing.assert_allclose(synth.planted_pctr(ids, 9), want, rtol=1e-6)
