"""The port's packed-batch cache (xflow_tpu_torch/io/packed.py) against
the reference's (the cases of tests/test_packed.py and
tests/test_compact.py:184-252): a shard the port writes (v2, and v1 in
numeric mode) is byte-equal to the reference's from the same text; each
package reads the other's v2 shards, and the port reads the reference's
v1; mmap and buffered reads give the same bytes; a split shard reads
back as the whole shard; the geometry checks refuse a mismatched cache;
resume offsets are exact; the CLI converts a text prefix as the
reference's CLI does."""

import io
import os

import numpy as np
import pytest

from xflow_tpu.io import packed as ref_packed
from xflow_tpu.io.loader import ShardLoader as RefShardLoader
from xflow_tpu_torch.io import packed
from xflow_tpu_torch.io.compact import CompactBatch
from xflow_tpu_torch.io.loader import ShardLoader

T = 1 << 14
PLANES = ("cu", "ci", "ct", "cf", "cc", "h8", "hx", "hxh", "hf", "hc",
          "lb", "wb", "cs", "hs")
BATCH_FIELDS = ("keys", "slots", "vals", "mask", "labels", "weights",
                "hot_keys", "hot_slots", "hot_vals", "hot_mask")
GEOM = dict(batch_size=64, max_nnz=24, table_size=T)


def _batches_equal(a, b):
    for f in BATCH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


def _planes_equal(a, b):
    assert (a.n_real, a.n_cold, a.n_dict, a.n_dict_occ) == (
        b.n_real, b.n_cold, b.n_dict, b.n_dict_occ)
    for f in PLANES:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.fixture(scope="module")
def shards(toy_dataset, tmp_path_factory):
    """The first toy shard converted by both packages, v2 (hash mode)
    and v1 (numeric mode); small text blocks, so batches span blocks."""
    src = toy_dataset.train_prefix + "-00000"
    root = tmp_path_factory.mktemp("pk")
    out = {"src": src}
    for name, mod in (("ours", packed), ("ref", ref_packed)):
        out[name] = str(root / f"{name}-v2")
        out[f"{name}_meta"] = mod.convert_shard(src, out[name], block_mib=0.002, **GEOM)
        out[f"{name}_v1"] = str(root / f"{name}-v1")
        mod.convert_shard(src, out[f"{name}_v1"], block_mib=0.002, hash_mode=False, **GEOM)
    return out


def test_port_writes_the_references_bytes(shards):
    for a, b in (("ours", "ref"), ("ours_v1", "ref_v1")):
        with open(shards[a], "rb") as f, open(shards[b], "rb") as g:
            assert f.read() == g.read(), a
    assert shards["ours_meta"] == shards["ref_meta"]
    assert shards["ours_meta"]["examples"] == 200
    assert packed.shard_example_count(shards["ours"]) == 200
    with open(shards["ours"], "rb") as f:
        assert packed.read_header(f)[0]["version"] == 2


@pytest.mark.parametrize("writer", ["ours", "ref"])
def test_each_reads_the_others_shards(shards, writer):
    """Expanded batches from either reader equal the text loader's;
    compact records equal the reference reader's, plane for plane."""
    path = shards[writer]
    text = list(ShardLoader(shards["src"], **GEOM).iter_batches())
    ours = list(ShardLoader(path, **GEOM).iter_batches())
    theirs = list(RefShardLoader(path, **GEOM).iter_batches())
    assert len(text) == len(ours) == len(theirs) > 2
    for (tb, _), (ob, oo), (rb, ro) in zip(text, ours, theirs):
        _batches_equal(tb, ob)
        _batches_equal(ob, rb)
        assert oo == ro
    compact = list(ShardLoader(path, emit_compact=True, **GEOM).iter_batches())
    ref_compact = list(RefShardLoader(path, emit_compact=True, **GEOM).iter_batches())
    for (cb, _), (rcb, _) in zip(compact, ref_compact):
        assert isinstance(cb, CompactBatch)
        _planes_equal(cb, rcb)
    # and the port reads the reference's v1 records (numeric mode)
    v1 = list(ShardLoader(shards["ref_v1"], hash_mode=False, **GEOM).iter_batches())
    text_v1 = list(ShardLoader(shards["src"], hash_mode=False, **GEOM).iter_batches())
    assert len(v1) == len(text_v1)
    for (a, _), (b, _) in zip(v1, text_v1):
        _batches_equal(a, b)


def test_mmap_and_buffered_reads_are_equal(shards):
    import mmap

    with open(shards["ours"], "rb") as f:
        blob = f.read()
    with open(shards["ours"], "rb") as f:
        via_mmap = list(packed.iter_compact_batches(f))
    via_buffer = list(packed.iter_compact_batches(io.BytesIO(blob)))
    assert len(via_mmap) == len(via_buffer) > 1
    for (a, oa, na), (b, ob, nb) in zip(via_mmap, via_buffer):
        assert (oa, na) == (ob, nb)
        _planes_equal(a, b)
    first = via_mmap[0][0].cu
    while isinstance(getattr(first, "base", None), np.ndarray):
        first = first.base
    buf = first.base
    assert isinstance(buf, mmap.mmap) or isinstance(getattr(buf, "obj", None), mmap.mmap)
    with open(shards["ours"], "rb") as f:
        exp_mmap = [b for b, _, _ in packed.iter_batches(f)]
    for a, (b, _, _) in zip(exp_mmap, packed.iter_batches(io.BytesIO(blob))):
        _batches_equal(a, b)


def test_split_shard_reads_back_whole(shards, tmp_path):
    paths = packed.split_shard_v2(shards["ours"], str(tmp_path / "part"), 3)
    ref_paths = ref_packed.split_shard_v2(shards["ours"], str(tmp_path / "refpart"), 3)
    assert len(paths) == len(ref_paths) == 2  # 4 records, 2 per part
    for a, b in zip(paths, ref_paths):
        assert open(a, "rb").read() == open(b, "rb").read()
    whole = [cb for cb, _, _ in packed.iter_compact_batches(open(shards["ours"], "rb"))]
    parts = [cb for p in paths for cb, _, _ in packed.iter_compact_batches(open(p, "rb"))]
    assert len(whole) == len(parts)
    for a, b in zip(whole, parts):
        _planes_equal(a, b)
    assert sum(packed.shard_example_count(p) for p in paths) == 200
    with pytest.raises(ValueError, match="num_shards"):
        packed.split_shard_v2(shards["ours"], str(tmp_path / "x"), 0)


def test_geometry_mismatch_refused_and_resume_exact(shards):
    path = shards["ours"]
    for kw, what in ((dict(batch_size=32), "batch_size"), (dict(max_nnz=16), "cold_nnz"),
                     (dict(table_size=1 << 12), "table_size"),
                     (dict(hash_seed=9), "seed")):
        with pytest.raises(ValueError, match=what):
            list(ShardLoader(path, **{**GEOM, **kw}).iter_batches())
    loader = ShardLoader(path, **GEOM)
    full = list(loader.iter_batches())
    tail = list(loader.iter_batches(start_offset=full[0][1]))
    assert len(tail) == len(full) - 1
    for (fb, fo), (tb, to) in zip(full[1:], tail):
        _batches_equal(fb, tb)
        assert fo == to
    with pytest.raises(ValueError, match="past the packed shard end"):
        list(loader.iter_batches(start_offset=full[-1][1] + 10**6))


def test_cli_converts_as_the_references(toy_dataset, tmp_path):
    ours, ref = str(tmp_path / "ours" / "pk"), str(tmp_path / "ref" / "pk")
    args = ["--train", toy_dataset.train_prefix, "--batch-size", "64",
            "--max-nnz", "24", "--table-size-log2", "14", "--block-mib", "0.01"]
    assert packed.main(["--out", ours, *args]) == 0
    assert ref_packed.main(["--out", ref, *args]) == 0
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "ref")) == ["pk-00000", "pk-00001",
                                                              "pk-00002"]
    for n in names:
        assert (tmp_path / "ours" / n).read_bytes() == (tmp_path / "ref" / n).read_bytes()
    with pytest.raises(SystemExit):
        packed.main(["--out", ours, *args, "--hot-size-log2", "8"])
