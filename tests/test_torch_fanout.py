"""The port's input fan-out (xflow_tpu_torch/io/fanout.py) against the
reference's (xflow_tpu/io/fanout.py) on the toy corpus, and the
loader's backpressure accounting it reads.

The pool's contract is the serial reader's: ``(batch, shard_idx,
resume_offset)`` in serial shard order at any stream count, a resumed
``(start_shard, start_offset)`` starting mid-shard.  Each item of the
port's pool must be byte-equal to the reference pool's (order, shard
index, resume offset, every plane), over libffm text and over
packed-v2 shards (whose batches are CompactBatch records).  The blocks
are 4 KiB so that a shard has several resume offsets."""

import dataclasses
import threading
import time

import numpy as np
import pytest

from xflow_tpu.io import packed as ref_packed
from xflow_tpu.io.fanout import ShardStreamPool as RefPool
from xflow_tpu.io.loader import ShardLoader as RefLoader
from xflow_tpu_torch.io.fanout import ShardStreamPool
from xflow_tpu_torch.io.loader import ShardLoader, _PrefetchIter
from xflow_tpu_torch.trainer import find_shards

B, K, T_LOG2 = 32, 24, 14
BLOCK_BYTES = 4096
BATCH_FIELDS = ("keys", "slots", "vals", "mask", "labels", "weights",
                "hot_keys", "hot_slots", "hot_vals", "hot_mask")


def _factory(cls, compact: bool):
    def make(path):
        loader = cls(path, batch_size=B, max_nnz=K, table_size=1 << T_LOG2,
                     emit_compact=compact)
        loader.block_bytes = BLOCK_BYTES
        return loader
    return make


@pytest.fixture(scope="module")
def corpora(toy_dataset, tmp_path_factory):
    """The toy train shards as text and as packed-v2 shards."""
    text = find_shards(toy_dataset.train_prefix)
    root = tmp_path_factory.mktemp("packed")
    packed = []
    for i, src in enumerate(text):
        dst = str(root / f"toy.pk-{i:05d}")
        ref_packed.convert_shard(src, dst, batch_size=B, max_nnz=K,
                                 table_size=1 << T_LOG2, fmt="v2")
        packed.append(dst)
    return {"text": text, "packed-v2": packed}


def _planes(batch) -> dict:
    """Every plane (and geometry field) of a Batch or a CompactBatch."""
    if hasattr(batch, "cu"):
        return {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
    return {name: getattr(batch, name) for name in BATCH_FIELDS}


def _collect(pool_cls, loader_cls, shards, streams, compact, **kw):
    pool = pool_cls(shards, _factory(loader_cls, compact), num_streams=streams,
                    depth=2, **kw)
    try:
        return [(si, resume, _planes(batch)) for batch, si, resume in pool]
    finally:
        pool.close()


@pytest.mark.parametrize("start", ["shard 0", "mid-shard 1"])
@pytest.mark.parametrize("fmt", ["text", "packed-v2"])
@pytest.mark.parametrize("streams", [1, 2, 4])
def test_pool_items_equal_reference(corpora, streams, fmt, start):
    shards = corpora[fmt]
    compact = fmt == "packed-v2"
    kw = {}
    if start != "shard 0":
        # the cursor a checkpoint saves: shard 1 at its second batch's
        # resume offset, which must lie inside the shard
        serial = _collect(RefPool, RefLoader, shards, 1, compact)
        offsets = [r for si, r, _ in serial if si == 1]
        assert 0 < offsets[1] < offsets[-1]
        kw = {"start_shard": 1, "start_offset": offsets[1]}
    want = _collect(RefPool, RefLoader, shards, streams, compact, **kw)
    got = _collect(ShardStreamPool, ShardLoader, shards, streams, compact, **kw)
    assert len(got) == len(want) > 3
    if kw:
        assert want[0][0] == 1 and len(want) < len(serial)
    for (sa, ra, pa), (sb, rb, pb) in zip(got, want):
        assert (sa, ra) == (sb, rb)
        assert pa.keys() == pb.keys()
        for name, a in pa.items():
            if isinstance(a, np.ndarray):
                assert a.dtype == pb[name].dtype and np.array_equal(a, pb[name]), name
            else:
                assert a == pb[name], name


def test_pool_stream_stats_and_close(corpora):
    """Per-stream rows carry the reference's keys and add up to the
    corpus; a pool closed mid-iteration leaves no producer thread."""
    shards = corpora["text"]
    pool = ShardStreamPool(shards, _factory(ShardLoader, False), num_streams=4, depth=2)
    assert pool.num_streams == len(shards)  # never an empty stream
    items = list(pool)
    rows = pool.stream_stats()
    pool.close()
    ref = RefPool(shards, _factory(RefLoader, False), num_streams=4, depth=2)
    list(ref)
    ref_rows = ref.stream_stats()
    ref.close()
    assert [set(r) for r in rows] == [set(r) for r in ref_rows]
    assert sum(r["shards"] for r in rows) == len(shards)
    assert sum(r["batches"] for r in rows) == len(items)
    assert all(r["examples_per_sec"] > 0 for r in rows)
    before = set(threading.enumerate())
    pool = ShardStreamPool(shards, _factory(ShardLoader, False), num_streams=3, depth=1)
    next(iter(pool))
    assert pool.alive
    t0 = time.time()
    pool.close()
    assert time.time() - t0 < 10 and not pool.alive
    assert not {t for t in threading.enumerate() if t.is_alive()} - before


def test_prefetch_backpressure_stall_seconds():
    """A producer blocked on a full queue books its wait; one whose
    consumer keeps up books (almost) none."""
    it = _PrefetchIter(iter(range(6)), depth=1)
    time.sleep(0.3)  # the producer fills the queue and waits
    assert list(it) == list(range(6))
    assert it.stall_seconds() > 0.2
    it.close()
    fast = _PrefetchIter(iter(range(3)), depth=8)
    assert list(fast) == [0, 1, 2]
    assert fast.stall_seconds() < 0.05
    fast.close()
