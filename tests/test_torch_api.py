"""``xflow_tpu_torch.XFlow`` (the port's api.py) against the reference's
``xflow_tpu.api.XFlow``, on the CPU.

Both train the same lr configuration on ``toy_dataset`` from the same
initial state (lr's table starts at zeros in both packages), then score
the same raw batches through ``predict_batch``.

Bound: pctr and the eval log-loss within 1e-4 absolute of the
reference's, tests/test_torch_trainer.py's training bound and for its
reason: one step agrees within the parity bar, but over the epochs the
float32 summation-order differences are fed back through FTRL's state
and the next forward; 1e-4 leaves two orders of magnitude above that
noise, while a wrong gradient or update moves the log-loss by 1e-3 or
more within an epoch.  Scores of one state in two engines of the port:
atol 1e-6 (tests/test_serve.py's bar)."""

import numpy as np
import pytest

from xflow_tpu.api import XFlow as RefXFlow
from xflow_tpu.io.batch import pack_batch as ref_pack_batch
from xflow_tpu.io.libffm import parse_block as ref_parse_block
import xflow_tpu_torch
from xflow_tpu_torch.api import XFlow
from xflow_tpu_torch.io.batch import Batch
from xflow_tpu_torch.serve.engine import PredictEngine

TRACK = 1e-4
ATOL = 1e-6


def _kw(ds, tmp, **kw):
    base = dict(model="lr", epochs=2, batch_size=64, table_size_log2=14, max_nnz=24,
                num_devices=1, checkpoint_dir=str(tmp))
    base.update(kw)
    return base


def _batches(ds, cfg, sizes):
    """(reference Batch, port Batch) pairs of the first test lines."""
    with open(ds.test_prefix + "-00000") as f:
        lines = f.read().splitlines()
    block = ref_parse_block(("\n".join(lines) + "\n").encode(), cfg.table_size,
                            cfg.hash_mode, cfg.seed)
    out = []
    for n in sizes:
        ref = ref_pack_batch(block, 0, n, n, cfg.max_nnz)
        out.append((ref, Batch(keys=ref.keys, slots=ref.slots, vals=ref.vals,
                               mask=ref.mask, labels=ref.labels, weights=ref.weights)))
    return out


@pytest.fixture(scope="module")
def trained(toy_dataset, tmp_path_factory):
    ref = RefXFlow(toy_dataset.train_prefix, toy_dataset.test_prefix,
                   **_kw(toy_dataset, tmp_path_factory.mktemp("ref_ck")))
    ref.train()
    ours = XFlow(toy_dataset.train_prefix, toy_dataset.test_prefix, device="cpu",
                 **_kw(toy_dataset, tmp_path_factory.mktemp("port_ck")))
    ours.train()
    yield ref, ours
    ref.close()
    ours.close()


def test_xflow_is_exported_by_the_package():
    assert xflow_tpu_torch.XFlow is XFlow


def test_predict_batch_and_evaluate_track_the_reference(toy_dataset, trained):
    ref, ours = trained
    for rb, pb in _batches(toy_dataset, ours.config, (1, 5, 64, 130)):
        got = ours.predict_batch(pb)
        assert got.shape == (pb.batch_size,)
        np.testing.assert_allclose(got, ref.predict_batch(rb), atol=TRACK)
    engine = ours._engine
    assert engine.compile_count <= len(engine.buckets)
    assert abs(ours.evaluate()["logloss"] - ref.evaluate()["logloss"]) <= TRACK


def test_predict_batch_follows_the_live_state_through_one_engine(toy_dataset, trained,
                                                                 tmp_path):
    _, ours = trained
    _, full = _batches(toy_dataset, ours.config, (64,))[0]
    before = ours.predict_batch(full)
    engine, keys = ours._engine, ours._engine.compile_count
    ours.trainer.train_epoch()
    after = ours.predict_batch(full)
    assert ours._engine is engine and engine.compile_count == keys
    assert not np.allclose(before, after)
    fresh = PredictEngine(ours.config, ours.trainer.state, device="cpu",
                          remap=ours.trainer.remap)
    np.testing.assert_allclose(after, fresh.predict(full), atol=ATOL)
    # the exported artifact scores what the live state scores
    art = ours.export_artifact(str(tmp_path / "art"))
    loaded = PredictEngine.load(art, device="cpu", buckets=engine.buckets)
    np.testing.assert_allclose(loaded.predict(full), after, atol=ATOL)
    # a save, more training, then a restore brings the saved scores back
    assert ours.save() is not None
    ours.trainer.train_epoch()
    assert not np.allclose(ours.predict_batch(full), after)
    assert ours.restore() is not None
    np.testing.assert_allclose(ours.predict_batch(full), after, atol=ATOL)
    assert ours._engine is engine and engine.compile_count == keys


def test_predict_batch_refuses_the_tiered_store(toy_dataset, trained, monkeypatch):
    _, ours = trained
    _, full = _batches(toy_dataset, ours.config, (8,))[0]
    monkeypatch.setattr(ours, "config", ours.config.replace(store_mode="tiered",
                                                               hot_capacity_log2=10))
    with pytest.raises(ValueError, match="store_mode='tiered' deliberately avoids"):
        ours.predict_batch(full)
