"""The tiered parameter store end to end in the port's Trainer, held
against the JAX package's tiered Trainer on the same toy batches: two
epochs of training (FM and LR dense, FM sparse) with their ``store``
rows, the tier-erased checkpoint (bitwise round trips, resets,
refusals, and checkpoints crossing between the packages both ways),
the folded export (against a dense export seeded from the lazy init,
and artifacts crossing between the two engines both ways), the 2^28
geometry, the CLI, and the promotion thread's reaping.

Placement is asynchronous (the promotion worker is a thread), so these
tests compare logical tables — ``logical_rows`` and the fold — never
placement or hit counts.  Bounds: a logical table after two epochs
within rtol 1e-5 / atol 1e-6 of the JAX package's (ROADMAP's parity
bar: FTRL acts row by row, so the per-step summation-order differences
do not compound beyond it at this size); checkpoint round trips
bitwise; served scores within 1e-6 (the serving bar)."""

import os
import threading

import numpy as np
import pytest

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.serve.artifact import export_artifact as ref_export_artifact
from xflow_tpu.serve.engine import PredictEngine as RefPredictEngine
from xflow_tpu.trainer import Trainer as RefTrainer
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import state_from_numpy
from xflow_tpu_torch.io.batch import pack_batch
from xflow_tpu_torch.io.libffm import parse_block
from xflow_tpu_torch.obs.schema import load_jsonl, validate_rows
from xflow_tpu_torch.serve.artifact import export_artifact
from xflow_tpu_torch.serve.engine import PredictEngine
from xflow_tpu_torch.store.cold import row_init_values
from xflow_tpu_torch.trainer import Trainer

RTOL, ATOL = 1e-5, 1e-6
SCORE_ATOL = 1e-6


def _kw(ds, **kw):
    """The reference tests' toy geometry (tests/test_store.py:22-36)."""
    base = dict(train_path=ds.train_prefix, test_path=ds.test_prefix, model="fm", epochs=1,
                batch_size=64, table_size_log2=16, max_nnz=24, num_devices=1,
                store_mode="tiered", hot_capacity_log2=10)
    base.update(kw)
    return base


def _trainer(kw, **extra):
    return Trainer(Config(**kw), device="cpu", log=lambda s: None, **extra)


def _touched(store) -> np.ndarray:
    keys = np.concatenate([store.hot.key_of[store.hot.key_of >= 0], store.cold.keys_view()])
    return np.unique(keys).astype(np.int64)


def _fold(store, state, table) -> np.ndarray:
    return np.concatenate([b for _, _, b in store.iter_logical_param_shards(state, table)])


def _test_batches(ds, cfg, n=3):
    data = open(ds.test_prefix + "-00000", "rb").read()
    block = parse_block(data, cfg.table_size, True, cfg.seed)
    return [pack_batch(block, i * 64, (i + 1) * 64, 64, cfg.max_nnz) for i in range(n)]


@pytest.mark.parametrize("model, mode, hc", [("fm", "dense", 10), ("lr", "dense", 10),
                                             ("fm", "sparse", 10), ("fm", "dense", 5)])
def test_two_epochs_match_reference(toy_dataset, tmp_path, model, mode, hc):
    """Train logloss falls, AUC > 0.6, the ``store`` rows validate with
    promotions in epoch 0 (tests/test_store.py::
    test_tiered_trains_and_emits_store_rows), and the folded logical
    table and every touched row's optimizer planes match the JAX
    package's tiered run on the same batches.  At 2^10 slots the toy
    working set fits the tier; at 2^5 the rows end split across both
    tiers."""
    metrics = tmp_path / "m.jsonl"
    kw = _kw(toy_dataset, model=model, update_mode=mode, epochs=2, hot_capacity_log2=hc)
    with _trainer(dict(kw, metrics_out=str(metrics))) as t:
        hist = t.train()
        res = t.evaluate()
        store = t.step.store
        assert t.step.wire_format == "tiered"
        keys = _touched(store)
        n_cold = len(store.cold)
        got = {tn: store.logical_rows(t.state, tn, keys) for tn in store.cold.tables}
        fold = {tn: _fold(store, t.state, tn) for tn in store.cold.tables}
    assert len(hist) == 2 and hist[1]["train_logloss"] < hist[0]["train_logloss"]
    # no staging ring: put_batch runs on the training thread, exclusive
    assert "h2d" in hist[0]["phases"] and "h2d" not in hist[0]["overlapped"]
    assert res["auc"] > 0.6
    rows = load_jsonl(str(metrics))
    assert validate_rows(rows) == []
    store_rows = [r for r in rows if r["kind"] == "store"]
    assert len(store_rows) == 2 and store_rows[0]["promotions"] > 0
    assert 0.0 < store_rows[1]["hot_occupancy"] <= 1.0
    if hc == 10:  # the warm epoch: the toy working set fits 2^10 slots
        assert store_rows[1]["hot_hit_rate"] > 0.9
    else:
        assert n_cold > 0
    with RefTrainer(RefConfig(**kw)) as r:
        rhist = r.train()
        rres = r.evaluate()
        rstore = r.step.store
        assert np.array_equal(_touched(rstore), keys)
        want = {tn: rstore.logical_rows(r.state, tn, keys) for tn in rstore.cold.tables}
        rfold = {tn: _fold(rstore, r.state, tn) for tn in rstore.cold.tables}
    for tn in want:
        np.testing.assert_allclose(fold[tn], rfold[tn], rtol=RTOL, atol=ATOL, err_msg=tn)
        for plane in want[tn]:
            np.testing.assert_allclose(got[tn][plane], want[tn][plane], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{tn}.{plane}")
    np.testing.assert_allclose([h["train_logloss"] for h in hist],
                               [h["train_logloss"] for h in rhist], rtol=RTOL)
    np.testing.assert_allclose(res["auc"], rres["auc"], atol=1e-3)


def _split_trainer(toy_dataset, tmp_path, name="ck", **kw):
    """A tiered run whose rows end split across both tiers: 32 hot
    slots, far fewer than the toy data's keys."""
    return _trainer(_kw(toy_dataset, hot_capacity_log2=5,
                        checkpoint_dir=str(tmp_path / name), checkpoint_every_steps=3, **kw))


def _probe(store):
    hot = store.hot.key_of[store.hot.key_of >= 0]
    cold = store.cold.keys_view()
    return np.unique(np.concatenate([hot[:40], cold[:40],
                                     np.asarray([1, 2, 3, 60000], np.int64)]))


def test_checkpoint_roundtrip_bitwise(toy_dataset, tmp_path):
    """A mid-run save with rows in both tiers, then a restore into a
    fresh Trainer: the logical rows (FTRL slots and untouched rows
    included) are bitwise equal; the restore is all-cold; training
    goes on (tests/test_store.py::test_tiered_checkpoint_roundtrip_bitwise)."""
    t1 = _split_trainer(toy_dataset, tmp_path)
    t1.train()
    st1 = t1.step.store
    assert st1.hot.occupancy > 0 and len(st1.cold) > 0
    probe = _probe(st1)
    before = {tn: st1.logical_rows(t1.state, tn, probe) for tn in ("w", "v")}
    assert set(before["w"]) == {"param", "n", "z"}
    t1.save(0, 0)
    t2 = _split_trainer(toy_dataset, tmp_path)
    assert t2.restore() is not None
    st2 = t2.step.store
    assert st2.hot.occupancy == 0
    for tn in before:
        after = st2.logical_rows(t2.state, tn, probe)
        for an in before[tn]:
            assert before[tn][an].tobytes() == after[an].tobytes(), (tn, an)
    t2.epoch = 0  # the save was at the end of the last epoch: train one more
    assert np.isfinite(t2.train()[-1]["train_logloss"])
    t1.close()
    t2.close()


def test_same_instance_restore_resets_promoter(toy_dataset, tmp_path):
    """restore() on a live trainer resets the promotion worker with the
    maps it mirrors; the next epoch re-warms the tier."""
    with _trainer(_kw(toy_dataset, checkpoint_dir=str(tmp_path / "ck"))) as t:
        t.train()
        t.save(0, 0)
        store = t.step.store
        assert store.promoter is not None and store.hot.occupancy > 0
        assert t.restore() is not None
        t.epoch = 0
        assert store.promoter is None and store.hot.occupancy == 0
        assert np.isfinite(t.train()[-1]["train_logloss"])
        assert store.hot.occupancy > 0


def test_store_modes_refuse_each_others_checkpoints(toy_dataset, tmp_path):
    """A dense restore of a tiered checkpoint and a tiered restore of a
    dense one are refused with a reason, and start fresh
    (tests/test_store.py:265-294)."""
    ck = str(tmp_path / "tiered")
    with _trainer(_kw(toy_dataset, checkpoint_dir=ck)) as t:
        t.train()
        t.save(0, 0)
    logs = []
    t2 = Trainer(Config(**_kw(toy_dataset, checkpoint_dir=ck, store_mode="dense",
                              hot_capacity_log2=18)), device="cpu", log=logs.append)
    assert t2.restore() is None and any("tiered" in m for m in logs)
    t2.close()
    ck = str(tmp_path / "dense")
    with _trainer(_kw(toy_dataset, checkpoint_dir=ck, store_mode="dense",
                      hot_capacity_log2=18)) as t:
        t.train()
        t.save(0, 0)
    logs = []
    t3 = Trainer(Config(**_kw(toy_dataset, checkpoint_dir=ck)), device="cpu", log=logs.append)
    assert t3.restore() is None
    assert any("was not written by store_mode='tiered'" in m for m in logs)
    t3.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_packages(toy_dataset, tmp_path, writer):
    """A tiered checkpoint written by one package restores in the other
    with bitwise-equal logical rows (touched rows in both tiers at the
    save, untouched rows from the lazy init)."""
    kw = _kw(toy_dataset, hot_capacity_log2=5, checkpoint_dir=str(tmp_path / "ck"))
    make_w, make_r = ((lambda: RefTrainer(RefConfig(**kw))), (lambda: _trainer(kw)))
    if writer == "port":
        make_w, make_r = make_r, make_w
    src = make_w()
    src.train()
    store = src.step.store
    assert store.hot.occupancy > 0 and len(store.cold) > 0
    probe = _probe(store)
    before = {tn: store.logical_rows(src.state, tn, probe) for tn in ("w", "v")}
    src.save(0, 0)
    src.close()
    dst = make_r()
    assert dst.restore() is not None
    for tn in before:
        after = dst.step.store.logical_rows(dst.state, tn, probe)
        for an in before[tn]:
            assert before[tn][an].tobytes() == np.asarray(after[an]).tobytes(), (tn, an)
    assert int(dst.state["step"]) == int(src.state["step"])
    dst.close()


def _dense_twin(kw):
    """A dense-store Trainer whose tables start as the tiered store's
    logical table: every row from ``row_init_values``, in CHUNK_ROWS
    chunks as the export folds them."""
    cfg = Config(**dict(kw, store_mode="dense", hot_capacity_log2=18))
    t = Trainer(cfg, device="cpu", log=lambda s: None)
    rows = np.arange(cfg.table_size, dtype=np.int64)
    tables = {}
    for spec in t.model.tables():
        param = row_init_values(cfg.seed, spec.name, "param", rows, spec.dim,
                                spec.init_kind, spec.init_scale)
        tables[spec.name] = {"param": param, "n": np.zeros_like(param),
                             "z": np.zeros_like(param)}
    t.state = state_from_numpy(cfg, tables, "cpu", dense={
        k: v.numpy() for k, v in t.state["dense"].items()})
    return t


@pytest.mark.parametrize("model", ["fm", "wide_deep"])
def test_folded_export_scores_as_a_dense_run(toy_dataset, tmp_path, model):
    """A tiered export and the export of a dense run seeded from the
    lazy init, trained on the same batches, score within 1e-6 through
    the port's PredictEngine (scripts/check_store_smoke.py's claim); the
    tiered artifact's manifest is a dense one."""
    kw = _kw(toy_dataset, model=model, epochs=2, hot_capacity_log2=5,
             **({"max_fields": 10} if model == "wide_deep" else {}))
    with _trainer(kw) as t:
        t.train()
        tiered_art = export_artifact(t, str(tmp_path / "tiered"))
    dense = _dense_twin(kw)
    dense.train()
    dense_art = export_artifact(dense, str(tmp_path / "dense"))
    dense.close()
    a = PredictEngine.load(tiered_art, device="cpu", warm=False)
    b = PredictEngine.load(dense_art, device="cpu", warm=False)
    assert a.cfg.store_mode == "tiered" and a.step.cfg.store_mode == "dense"
    files = sorted(f for f in os.listdir(tiered_art) if f.endswith(".npy"))
    assert files == sorted(f for f in os.listdir(dense_art) if f.endswith(".npy"))
    for batch in _test_batches(toy_dataset, a.cfg):
        np.testing.assert_allclose(a.predict(batch), b.predict(batch), atol=SCORE_ATOL)


def test_tiered_artifacts_cross_engines(toy_dataset, tmp_path):
    """A tiered artifact exported by the JAX package loads in the port's
    engine, and one exported by the port in the JAX package's engine;
    in both directions the two engines' scores agree within 1e-6."""
    kw = _kw(toy_dataset, epochs=2, hot_capacity_log2=5)
    with RefTrainer(RefConfig(**kw)) as r:
        r.train()
        jax_art = ref_export_artifact(r, str(tmp_path / "jax"))
    with _trainer(kw) as t:
        t.train()
        port_art = export_artifact(t, str(tmp_path / "port"))
    batches = _test_batches(toy_dataset, Config(**kw))
    for art in (jax_art, port_art):
        ours = PredictEngine.load(art, device="cpu", warm=False)
        ref = RefPredictEngine.load(art, warm=False)
        for batch in batches:
            np.testing.assert_allclose(ours.predict(batch), np.asarray(ref.predict(batch)),
                                       atol=SCORE_ATOL)


def test_fm_trains_tiered_at_2pow28(toy_dataset):
    """FM at T = 2^28 (a dense [T, 10] float32 plane alone is 10 GiB):
    device state bounded by the hot capacity, host rows by the touched
    keys (tests/test_store.py::test_fm_trains_tiered_at_2pow28)."""
    with _trainer(_kw(toy_dataset, table_size_log2=28, hot_capacity_log2=12)) as t:
        hist = t.train()
        assert np.isfinite(hist[0]["train_logloss"])
        store = t.step.store
        assert 0 < len(store.cold) + store.hot.occupancy < 1 << 20
        assert all(b.shape[0] < 1 << 14 for bufs in store.hot.bufs.values()
                   for b in bufs.values())
        assert 0.0 < t.evaluate()["logloss"] < 1.0


def test_cli_trains_tiered_and_exports(toy_dataset, tmp_path):
    """``python -m xflow_tpu_torch.train --store-mode tiered`` trains,
    evaluates and exports on the CPU, and the export serves."""
    from xflow_tpu_torch.train import main

    art = str(tmp_path / "art")
    rc = main(["--train", toy_dataset.train_prefix, "--test", toy_dataset.test_prefix,
               "--model", "fm", "--epochs", "1", "--batch-size", "64",
               "--table-size-log2", "16", "--max-nnz", "24", "--store-mode", "tiered",
               "--hot-capacity-log2", "6", "--update-mode", "sparse",
               "--export-artifact", art, "--device", "cpu"])
    assert rc == 0
    engine = PredictEngine.load(art, device="cpu", warm=False)
    pctr = engine.predict(_test_batches(toy_dataset, engine.cfg, 1)[0])
    assert np.all((pctr > 0) & (pctr < 1))


def test_no_promote_thread_survives_close(toy_dataset):
    before = {t.ident for t in threading.enumerate()}
    t = _trainer(_kw(toy_dataset))
    t.train()
    assert any(th.name == "store-promote" for th in threading.enumerate())
    t.close()
    assert not [th for th in threading.enumerate()
                if th.name == "store-promote" and th.ident not in before]


def test_predict_batch_still_refused(toy_dataset):
    """XFlow.predict_batch over the live tiered state stays refused, as
    the reference refuses it."""
    from xflow_tpu_torch.api import XFlow

    xf = XFlow(device="cpu", **_kw(toy_dataset, model="lr"))
    batch = _test_batches(toy_dataset, xf.config, 1)[0]
    with pytest.raises(ValueError, match="export_artifact"):
        xf.predict_batch(batch)
    xf.trainer.close()


FAMILIES = {
    "lr": {}, "fm": {}, "mvm": {"max_fields": 10}, "ffm": {"max_fields": 10},
    "wide_deep": {"max_fields": 10}, "dcn": {"max_fields": 10},
    "two_tower": {"max_fields": 10, "tower_split_field": 5},
}


@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_family_trains_checkpoints_and_exports(toy_dataset, tmp_path, family, mode):
    """Each family the reference's tiered store takes, in both update
    modes, through the Trainer: train, evaluate, save with rows in both
    tiers, restore bit for bit into a fresh Trainer, export, and serve
    the export with the scores evaluate gave."""
    kw = _kw(toy_dataset, model=family, update_mode=mode, hot_capacity_log2=5,
             checkpoint_dir=str(tmp_path / "ck"), **FAMILIES[family])
    with _trainer(kw) as t:
        assert np.isfinite(t.train()[0]["train_logloss"])
        res = t.evaluate(pred_out=str(tmp_path / "pred.txt"))
        assert 0.0 < res["logloss"] < 1.0
        store = t.step.store
        assert store.hot.occupancy > 0 and len(store.cold) > 0
        probe = _probe(store)
        before = {tn: store.logical_rows(t.state, tn, probe) for tn in store.cold.tables}
        dense = {k: v.clone() for k, v in t.state["dense"].items()}
        t.save(0, 0)
        art = export_artifact(t, str(tmp_path / "art"))
    with _trainer(kw) as fresh:
        assert fresh.restore() is not None
        for tn, planes in before.items():
            after = fresh.step.store.logical_rows(fresh.state, tn, probe)
            for plane, arr in planes.items():
                assert arr.tobytes() == after[plane].tobytes(), (tn, plane)
        for name, p in dense.items():
            assert p.numpy().tobytes() == fresh.state["dense"][name].numpy().tobytes()
    engine = PredictEngine.load(art, device="cpu", warm=False)
    pred = np.loadtxt(str(tmp_path / "pred.txt"))[:, 1]
    with open(toy_dataset.test_prefix + "-00000") as f:
        served = engine.score_text(f.read().splitlines())
    np.testing.assert_allclose(served[:len(pred)], pred, atol=SCORE_ATOL + 5e-7)
