"""Top-k retrieval (two_tower) in the port, on the CPU, against the
reference (xflow_tpu):

* ``item_catalog_from_block`` is a byte-equal copy of the reference's;
* the item index both ways: the reference's ``export_item_index`` read
  by the port's engine, the port's read by the reference's, the same
  files and meta, ``item_embeddings`` equal;
* ``topk`` equal to the reference's on the same index: the scores
  within the parity bar, the ids equal up to near-ties (two items whose
  scores differ by rounding may swap); exactly tied scores keep the
  lower index first (``lax.top_k``'s order);
* the refusals (no user tower, a wrong index width, ``k`` outside (0,
  topk_k], no index attached, a stale index), and ``compile_count``
  flat under mixed batch sizes and ``k``;
* the ``index`` CLI against the reference's.

Tolerances: embeddings and scores rtol 1e-5 / atol 1e-6 (ROADMAP's
parity bar)."""

import inspect
import json
import os

import jax
import numpy as np
import pytest

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.serve import artifact as ref_artifact
from xflow_tpu.serve.__main__ import main as ref_serve_main
from xflow_tpu.serve.artifact import export_artifact as ref_export_artifact
from xflow_tpu.serve.engine import PredictEngine as RefEngine
from xflow_tpu.trainer import Trainer as RefTrainer
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.io.loader import make_parse_fn
from xflow_tpu_torch.serve import artifact
from xflow_tpu_torch.serve.__main__ import main as serve_main
from xflow_tpu_torch.serve.engine import PredictEngine

RTOL, ATOL = 1e-5, 1e-6
BUCKETS = (8, 64)


def _kw(ds, **kw):
    base = dict(train_path=ds.train_prefix, test_path=ds.test_prefix, epochs=1,
                batch_size=64, table_size_log2=14, max_nnz=24, max_fields=12,
                num_devices=1, model="two_tower", emb_dim=4, hidden_dim=8, tower_dim=5,
                tower_split_field=6, sgd_lr=0.02)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def tower_artifact(toy_dataset, tmp_path_factory):
    """A two_tower artifact the JAX trainer exported (one epoch)."""
    root = tmp_path_factory.mktemp("tower")
    trainer = RefTrainer(RefConfig(**_kw(toy_dataset)))
    trainer.train()
    art = str(root / "art")
    ref_export_artifact(trainer, art)
    trainer.close()
    return art


def _catalog(ds, cfg, limit=0):
    with open(ds.test_prefix + "-00000", "rb") as f:
        block = make_parse_fn(cfg.table_size, cfg.hash_mode, cfg.seed)(f.read())
    return artifact.item_catalog_from_block(block, cfg.tower_split_field, limit)


def _copy(src, dst):
    import shutil

    shutil.copytree(src, dst)
    return dst


def test_item_catalog_from_block_is_a_byte_equal_copy():
    assert (inspect.getsource(artifact.item_catalog_from_block)
            == inspect.getsource(ref_artifact.item_catalog_from_block))


def _user_rows(ds, n=40):
    """Raw user-side request rows from the test shard: its first n
    lines' features of fields below the split, parsed and hashed as the
    engine's score path does."""
    cfg = Config(**_kw(ds))
    with open(ds.test_prefix + "-00000", "rb") as f:
        block = make_parse_fn(cfg.table_size, cfg.hash_mode, cfg.seed)(f.read())
    rows = []
    for i in range(min(n, block.num_samples)):
        lo, hi = int(block.row_ptr[i]), int(block.row_ptr[i + 1])
        keys = block.keys[lo:hi].astype(np.int64)
        slots = block.slots[lo:hi].astype(np.int32)
        sel = slots < cfg.tower_split_field
        rows.append((keys[sel], slots[sel], None))
    return rows


def assert_same_topk(got_ids, got_scores, want_ids, want_scores):
    """Equal top-k lists up to near-ties: the score lists within the
    tolerance position by position, every id's score the same on both
    sides, and an id that only one side keeps tied (within the
    tolerance) with the last kept score: two items whose scores differ
    by rounding may swap."""
    np.testing.assert_allclose(got_scores, want_scores, rtol=RTOL, atol=ATOL)
    for gi, gs, wi, ws in zip(got_ids, got_scores, want_ids, want_scores):
        g, w = dict(zip(gi.tolist(), gs.tolist())), dict(zip(wi.tolist(), ws.tolist()))
        tol = ATOL + RTOL * abs(ws[-1])
        for i in g.keys() & w.keys():
            assert abs(g[i] - w[i]) <= ATOL + RTOL * abs(w[i]), (i, g[i], w[i])
        for i in g.keys() ^ w.keys():
            assert abs(g.get(i, w.get(i)) - ws[-1]) <= tol, (i, g.get(i), w.get(i), ws[-1])


def test_item_index_both_ways_and_topk_equal(toy_dataset, tower_artifact, tmp_path):
    cfg = Config(**_kw(toy_dataset))
    items = _catalog(toy_dataset, cfg)
    assert len(items) > 50
    # the reference's index, read by the port
    ref_art = _copy(tower_artifact, str(tmp_path / "ref_idx"))
    ref = RefEngine.load(ref_art, buckets=BUCKETS, warm=False)
    meta = ref_artifact.export_item_index(ref, ref_art, items)
    ours = PredictEngine.load(ref_art, device="cpu", buckets=BUCKETS)
    np.testing.assert_allclose(ours.item_embeddings(items),
                               ref_artifact.load_item_index(ref_art)["item_index"],
                               rtol=RTOL, atol=ATOL)
    ref = RefEngine.load(ref_art, buckets=BUCKETS, warm=False)
    users = ours.featurize_raw(_user_rows(toy_dataset))
    want_ids, want_scores = ref.topk(users)
    got_ids, got_scores = ours.topk(users)
    assert ours.topk_k == ref.topk_k == 16
    assert_same_topk(got_ids, got_scores, want_ids, want_scores)
    # the port's index, read by the reference: same files and meta
    port_art = _copy(tower_artifact, str(tmp_path / "port_idx"))
    engine = PredictEngine.load(port_art, device="cpu", buckets=BUCKETS, warm=False)
    port_meta = artifact.export_item_index(engine, port_art, items)
    assert {k: v for k, v in port_meta.items() if k != "created_unix"} == {
        k: v for k, v in meta.items() if k != "created_unix"}
    assert sorted(os.listdir(port_art)) == sorted(os.listdir(ref_art))
    theirs = ref_artifact.load_item_index(port_art)
    mine = artifact.load_item_index(ref_art)
    for name in ("item_ids", "item_keys", "item_slots", "item_vals", "item_nnz"):
        np.testing.assert_array_equal(theirs[name], mine[name])
    again = RefEngine.load(port_art, buckets=BUCKETS, warm=False)
    ids, scores = again.topk(users, k=7)
    assert_same_topk(ids, scores, *ours.topk(users, k=7))


def test_topk_ties_keep_the_lower_index(toy_dataset, tower_artifact):
    """An index of repeated rows: every score is tied with its copies,
    and the port returns the lower index first, as lax.top_k does."""
    cfg = Config(**_kw(toy_dataset))
    items = _catalog(toy_dataset, cfg, limit=6)
    ours = PredictEngine.load(tower_artifact, device="cpu", buckets=BUCKETS, warm=False)
    ref = RefEngine.load(tower_artifact, buckets=BUCKETS, warm=False)
    emb = np.tile(ours.item_embeddings(items), (3, 1))
    index = {"item_index": emb, "item_ids": np.arange(len(emb), dtype=np.int64) * 10}
    ours.attach_item_index(index, topk_k=12)
    ref.attach_item_index(index, topk_k=12)
    users = ours.featurize_raw(_user_rows(toy_dataset, 9))
    got, _ = ours.topk(users)
    want, _ = ref.topk(users)
    np.testing.assert_array_equal(got, want)
    for row in got:  # copies of one item come in index order
        for a, b in zip(row, row[1:]):
            if (a // 10) % 6 == (b // 10) % 6:
                assert a < b


def test_topk_refusals_and_flat_compile_count(toy_dataset, tower_artifact, tmp_path):
    cfg = Config(**_kw(toy_dataset))
    engine = PredictEngine.load(tower_artifact, device="cpu", buckets=BUCKETS)
    with pytest.raises(ValueError, match="no item index attached"):
        engine.topk_prepared(engine.featurize(_user_rows(toy_dataset, 2)))
    items = _catalog(toy_dataset, cfg, limit=30)
    emb = engine.item_embeddings(items)
    with pytest.raises(ValueError, match="scans 7 lanes"):
        engine.attach_item_index({"item_index": emb[:, :5], "item_ids": np.arange(30)})
    engine.attach_item_index({"item_index": emb, "item_ids": np.arange(30)}, topk_k=10)
    for k in (0, 11):
        with pytest.raises(ValueError, match="outside \\(0, topk_k=10\\]"):
            engine.topk(engine.featurize_raw(_user_rows(toy_dataset, 2)), k=k)
    engine.warm()
    warmed = engine.compile_count
    assert warmed == 2 * len(BUCKETS) + 1  # predict + top-k legs, and item_embed's 64
    rows = _user_rows(toy_dataset, 70)
    for n, k in ((1, 3), (9, 10), (70, 1), (33, 5)):
        ids, scores = engine.topk(engine.featurize_raw(rows[:n]), k=k)
        assert ids.shape == scores.shape == (n, k)
        assert np.all(np.diff(scores, axis=1) <= 0)
    engine.predict(engine.featurize_raw(rows[:20]))
    assert engine.compile_count == warmed
    # a model without a user tower
    art = artifact.write_artifact(
        str(tmp_path / "wd"), Config(model="wide_deep", table_size_log2=10, max_nnz=4,
                                     max_fields=4, emb_dim=2, hidden_dim=3),
        {"w": np.zeros((1024, 1), np.float32), "emb": np.zeros((1024, 2), np.float32)},
        step=0, dense={"w1": np.zeros((8, 3), np.float32), "b1": np.zeros(3, np.float32),
                       "w2": np.zeros((3, 1), np.float32), "b2": np.zeros(1, np.float32)})
    wd = PredictEngine.load(art, device="cpu", buckets=(8,))
    with pytest.raises(ValueError, match="has no user tower"):
        wd.attach_item_index({"item_index": emb, "item_ids": np.arange(30)})
    with pytest.raises(ValueError, match="has no item tower"):
        artifact.export_item_index(wd, art, items)


def test_stale_index_is_refused(toy_dataset, tower_artifact, tmp_path):
    art = _copy(tower_artifact, str(tmp_path / "stale"))
    cfg = Config(**_kw(toy_dataset))
    engine = PredictEngine.load(art, device="cpu", buckets=BUCKETS, warm=False)
    artifact.export_item_index(engine, art, _catalog(toy_dataset, cfg, limit=10))
    with open(os.path.join(art, artifact.ITEM_INDEX_META)) as f:
        meta = json.load(f)
    meta["config_digest"] = "0" * 16
    with open(os.path.join(art, artifact.ITEM_INDEX_META), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="re-run export_item_index"):
        PredictEngine.load(art, device="cpu", buckets=BUCKETS)
    other = RefEngine.load(tower_artifact, buckets=BUCKETS, warm=False)
    other.digest = "f" * 16
    with pytest.raises(ValueError, match="the index must be computed by the model"):
        artifact.export_item_index(other, art, _catalog(toy_dataset, cfg, limit=10))


def test_index_cli_matches_reference(toy_dataset, tower_artifact, tmp_path, capsys):
    src = toy_dataset.test_prefix + "-00000"
    ours = _copy(tower_artifact, str(tmp_path / "ours"))
    theirs = _copy(tower_artifact, str(tmp_path / "theirs"))
    assert serve_main(["index", ours, "--input", src, "--device", "cpu",
                       "--max-items", "80"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ref_serve_main(["index", theirs, "--input", src, "--max-items", "80"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: v for k, v in got.items() if k != "artifact"} == {
        k: v for k, v in want.items() if k != "artifact"}
    a, b = artifact.load_item_index(ours), ref_artifact.load_item_index(theirs)
    np.testing.assert_allclose(a["item_index"], b["item_index"], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(a["item_keys"], b["item_keys"])
    jax.clear_caches()
