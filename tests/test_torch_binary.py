"""The binary block cache (io/binary.py, a copy of the reference's) on
the CPU: the port's converter and CLI write the reference's bytes, the
loader reads binary shards into the batches and resume offsets of the
reference's loader and into the batches of the text they came from,
key counts over them equal the text's, and the Trainer trains from them
to the text run's tables, bit for bit (the same batches, the same
deterministic CPU sums)."""

import os

import numpy as np
import pytest

from xflow_tpu.io import binary as ref_binary
from xflow_tpu.io import freq as ref_freq
from xflow_tpu.io.loader import ShardLoader as RefLoader
from xflow_tpu.io.loader import make_parse_fn as ref_make_parse_fn
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import state_to_numpy
from xflow_tpu_torch.io import binary, freq
from xflow_tpu_torch.io.loader import ShardLoader, make_parse_fn
from xflow_tpu_torch.trainer import Trainer

T = 1 << 12
BLOCK_MIB = 0.002  # ~2 KB text blocks: several records a shard
BATCH_FIELDS = ("keys", "slots", "vals", "mask", "hot_keys", "hot_slots", "hot_vals",
                "hot_mask", "labels", "weights")


@pytest.fixture(scope="module")
def caches(toy_dataset, tmp_path_factory):
    """The toy train shards converted by the port's CLI and by the
    reference's."""
    root = tmp_path_factory.mktemp("bin")
    ours, theirs = str(root / "ours"), str(root / "theirs")
    argv = ["--train", toy_dataset.train_prefix, "--block-mib", str(BLOCK_MIB)]
    assert binary.main(argv + ["--out", ours]) == 0
    assert ref_binary.main(argv + ["--out", theirs]) == 0
    return ours, theirs


def _shards(prefix):
    return [f"{prefix}-{i:05d}" for i in range(3)]


def test_cli_bytes_equal_reference(toy_dataset, caches):
    ours, theirs = caches
    for a, b in zip(_shards(ours), _shards(theirs)):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read()
    meta = binary.shard_example_count(_shards(ours)[0])
    assert meta == toy_dataset.lines_per_shard
    with open(_shards(ours)[0], "rb") as f:
        header, start = binary.read_header(f)
    assert header["blocks"] > 2 and header["hash_mode"] is True
    assert binary.is_binary_shard(_shards(ours)[0])
    assert not binary.is_binary_shard(toy_dataset.train_prefix + "-00000")


@pytest.mark.parametrize("hot", [False, True], ids=["cold", "hot"])
def test_loader_batches_and_offsets(toy_dataset, caches, hot):
    """Over a binary shard: the port's loader gives the reference
    loader's batches and resume offsets, and the batches of the text
    shard it was converted from; resuming at each offset gives the
    straight stream's tail."""
    ours, _ = caches
    remap = None
    kw = dict(batch_size=48, max_nnz=24, table_size=T)
    if hot:
        counts = freq.count_keys([toy_dataset.train_prefix + "-00000"],
                                 make_parse_fn(T, True, 0), T, 1 << 20)
        remap = freq.build_remap(counts, 64)
        kw.update(remap=remap, hot_size=64, hot_nnz=4)
    path = _shards(ours)[1]
    got = list(ShardLoader(path, **kw).iter_batches())
    want = list(RefLoader(path, **kw).iter_batches())
    text = list(ShardLoader(toy_dataset.train_prefix + "-00001", **kw).iter_batches())
    assert len(got) == len(want) == len(text) > 2
    for (a, off), (b, ref_off), (c, _) in zip(got, want, text):
        assert off == ref_off
        for name in BATCH_FIELDS:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
            np.testing.assert_array_equal(getattr(a, name), getattr(c, name), err_msg=name)
    assert ShardLoader(path, **kw).count_examples() == toy_dataset.lines_per_shard
    # a resume offset is a record start: resumed there, the port's
    # loader gives the reference loader's resumed stream, which ends
    # where the straight one ends
    for _, off in got[:-1]:
        tail = list(ShardLoader(path, **kw).iter_batches(off))
        ref_tail = list(RefLoader(path, **kw).iter_batches(off))
        assert [o for _, o in tail] == [o for _, o in ref_tail]
        assert tail[-1][1] == got[-1][1]
        for (a, _), (b, _) in zip(tail, ref_tail):
            np.testing.assert_array_equal(a.keys, b.keys)
            np.testing.assert_array_equal(a.weights, b.weights)
    with pytest.raises(ValueError, match="record boundary"):
        list(ShardLoader(path, **kw).iter_batches(got[0][1] + 1))
    with pytest.raises(ValueError, match="hash_mode"):
        list(ShardLoader(path, **kw, hash_mode=False).iter_batches())


def test_count_keys_over_binary_equals_text(toy_dataset, caches):
    ours, _ = caches
    text = [toy_dataset.train_prefix + "-00000", toy_dataset.train_prefix + "-00001"]
    for sample in (1 << 20, 3000):
        got = freq.count_keys(_shards(ours)[:2], make_parse_fn(T, True, 0), T, sample)
        want = ref_freq.count_keys(_shards(ours)[:2], ref_make_parse_fn(T, True, 0), T, sample)
        np.testing.assert_array_equal(got, want)
    full = freq.count_keys(_shards(ours)[:2], None, T, 1 << 20)
    np.testing.assert_array_equal(
        full, freq.count_keys(text, make_parse_fn(T, True, 0), T, 1 << 20))


@pytest.mark.parametrize("model, extra", [
    ("fm", {}), ("fm", {"hot_size_log2": 6, "hot_nnz": 4}),
], ids=["fm", "fm-hot"])
def test_trainer_from_binary_equals_text(toy_dataset, caches, tmp_path, model, extra):
    """The Trainer on binary shards ships the text run's batches, so its
    tables and eval equal the text run's exactly (a hot model counts its
    remap from the binary shards: the same counts)."""
    ours, _ = caches
    out = {}
    for name, prefix in (("text", toy_dataset.train_prefix), ("binary", ours)):
        cfg = Config(model=model, train_path=prefix, test_path=toy_dataset.test_prefix,
                     epochs=2, batch_size=64, table_size_log2=12, max_nnz=24,
                     max_fields=12, num_devices=1, **extra)
        with Trainer(cfg, device="cpu", log=lambda _: None) as trainer:
            history = trainer.train()
            result = trainer.evaluate()
            out[name] = (state_to_numpy(trainer.state, aux=True), history, result,
                         trainer.remap)
    (tt, th, tr, trm), (bt, bh, br, brm) = out["text"], out["binary"]
    if extra:
        np.testing.assert_array_equal(trm, brm)
    assert [h["steps"] for h in th] == [h["steps"] for h in bh]
    assert [h["train_logloss"] for h in th] == [h["train_logloss"] for h in bh]
    assert (tr["auc"], tr["logloss"]) == (br["auc"], br["logloss"])
    for name, table in tt.items():
        for key, arr in table.items():
            np.testing.assert_array_equal(bt[name][key], arr, err_msg=f"{name}.{key}")


def test_convert_prefix_single_file(toy_dataset, tmp_path):
    src = toy_dataset.test_prefix + "-00000"
    lines = []
    outs = binary.convert_prefix(src, str(tmp_path / "one.bin"), log=lines.append)
    assert outs == [str(tmp_path / "one.bin")] and len(lines) == 1
    assert os.path.getsize(outs[0]) > 0
    assert binary.shard_example_count(outs[0]) == toy_dataset.lines_per_shard
