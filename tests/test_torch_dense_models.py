"""The pooled families (B11: wide_deep, dcn, two_tower) in the port, on
the CPU, against the reference (xflow_tpu):

* the registry: tables, dense parameter names and shapes, two_tower's
  ``index_dim`` and both families' ``__post_init__`` refusals;
* each family's ``logit`` against the reference model's on the same
  gathered rows, batch and dense parameters (carried from the JAX init),
  with padding, fields past ``max_fields`` and negative ones; wide_deep
  also against tests/_legacy_models.py's frozen copy; two_tower's
  ``user_embed`` / ``item_embed`` lanes;
* the gradients the train step takes (K8's plain version and
  autograd's dense gradients, through ``TrainStep._pooled_grads``)
  against ``jax.value_and_grad`` in the reference's ``grads_from_rows``,
  with logits past +-30 (the residual is the unclamped sigmoid's);
* (tests/test_torch_dense_step.py and tests/test_torch_dense_step_more.py:
  one step in every update mode against the JAX ``TrainStep``;)
* the Trainer against the JAX Trainer on ``toy_dataset``, wide_deep's
  learning test (tests/test_extended_models.py:98), artifacts with their
  dense files both ways, the CLI's ``--model`` for each family.

Tolerances: rtol 1e-5 / atol 1e-6 for logits and gradients (ROADMAP's
parity bar: sums in another order than XLA's); the Trainer's
log-losses and AUC within 1e-4 over its epochs (tests/
test_torch_trainer.py's bound: float32 rounding carried through FTRL
and the dense SGD); pctr atol 1e-6 (tests/test_serve.py's bar)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _legacy_models import LegacyWideDeepModel
from xflow_tpu.config import Config as RefConfig
from xflow_tpu.models import make_model as ref_make_model
from xflow_tpu.parallel.step import grads_from_rows as ref_grads_from_rows
from xflow_tpu.serve.artifact import export_artifact as ref_export_artifact
from xflow_tpu.serve.engine import PredictEngine as RefEngine
from xflow_tpu.trainer import Trainer as RefTrainer
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import dense_to_numpy, state_from_numpy, state_to_numpy
from xflow_tpu_torch.models import DCNModel, TwoTowerModel, WideDeepModel, make_model
from xflow_tpu_torch.optim import make_optimizer
from xflow_tpu_torch.parallel.step import TrainStep
from xflow_tpu_torch.serve.artifact import export_artifact, write_artifact
from xflow_tpu_torch.serve.engine import PredictEngine
from xflow_tpu_torch.train import main as cli_main
from xflow_tpu_torch.trainer import Trainer
from xflow_tpu_torch.utils.metrics import logloss_sum, sigmoid_ref

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
PCTR_ATOL = 1e-6
B, K, F, E, HID = 24, 10, 6, 3, 5
GEOM = {"wide_deep": dict(emb_dim=E, hidden_dim=HID, max_fields=F),
        "dcn": dict(emb_dim=E, hidden_dim=HID, max_fields=F, cross_layers=2),
        "two_tower": dict(emb_dim=E, hidden_dim=HID, max_fields=F, tower_dim=4,
                          tower_split_field=2)}
FAMILIES = list(GEOM)


def _models(family):
    kw = dict(GEOM[family], model=family)
    return make_model(Config(**kw)), ref_make_model(RefConfig(**kw))


def _dense(ref_model, seed=0):
    return {k: np.asarray(a) for k, a in ref_model.dense_init(jax.random.PRNGKey(seed)).items()}


def _batch(seed, values=True):
    """[B, K] planes with padding, empty fields, fields past max_fields
    and negative ones."""
    rng = np.random.default_rng(seed)
    slots = rng.choice([0, 1, 3, 5], size=(B, K)).astype(np.int32)
    slots[rng.random((B, K)) < 0.1] = F + 2
    slots[rng.random((B, K)) < 0.1] = -1
    mask = (rng.random((B, K)) < 0.8).astype(np.float32)
    vals = (rng.uniform(0.5, 1.5, (B, K)) if values else np.ones((B, K))).astype(np.float32)
    keys = rng.integers(0, 50, (B, K)).astype(np.int32)
    return {"keys": keys, "slots": slots, "vals": vals, "mask": mask}


def _rows(seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, scale, (B, K, 1)).astype(np.float32),
            "emb": rng.normal(0, scale, (B, K, E)).astype(np.float32)}


def _t(d):
    return {k: torch.tensor(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def test_registry_builds_pooled_families():
    for family in FAMILIES:
        ours, ref = _models(family)
        assert ours.dense_params and ours.autodiff and ours.uses_slots
        assert [(t.name, t.dim, t.hot, t.init_kind) for t in ours.tables()] == [
            (t.name, t.dim, t.hot, t.init_kind) for t in ref.tables()]
        dense = ours.dense_init(torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in dense.items()} == {
            k: v.shape for k, v in _dense(ref).items()}
    assert isinstance(make_model(Config(model="dcn")), DCNModel)
    assert isinstance(make_model(Config(model="wide_deep")), WideDeepModel)
    tt = make_model(Config(model="two_tower", tower_dim=7))
    assert isinstance(tt, TwoTowerModel) and tt.index_dim == 9
    with pytest.raises(ValueError, match="split_field 5 must be in"):
        TwoTowerModel(max_fields=5, split_field=5)
    with pytest.raises(ValueError, match="cross_layers 0 must be >= 1"):
        DCNModel(cross_layers=0)


@pytest.mark.parametrize("values", [True, False], ids=["full", "binary"])
@pytest.mark.parametrize("family", FAMILIES)
def test_logit_matches_reference(family, values):
    ours, ref = _models(family)
    batch, rows, dense = _batch(1, values), _rows(2), _dense(ref, 3)
    want = np.asarray(ref.logit(_j(rows), _j(batch), _j(dense)))
    got = ours.logit(_t(rows), {k: torch.tensor(v).long() if k == "slots" else torch.tensor(v)
                                for k, v in batch.items()}, _t(dense))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if family == "wide_deep":
        legacy = LegacyWideDeepModel(emb_dim=E, hidden=HID, max_fields=F)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(legacy.logit(_j(rows), _j(batch), _j(dense))),
            rtol=RTOL, atol=ATOL)
    if family == "two_tower":
        tb = {k: torch.tensor(v) for k, v in batch.items()}
        tb["slots"] = tb["slots"].long()
        for name in ("user_embed", "item_embed"):
            u = getattr(ours, name)(_t(rows), tb, _t(dense))
            np.testing.assert_allclose(
                u.numpy(), np.asarray(getattr(ref, name)(_j(rows), _j(batch), _j(dense))),
                rtol=RTOL, atol=ATOL)
            assert u.shape == (B, ours.index_dim)
        # the bias lanes: [u, b_u, 1] against [i, 1, b_i]
        u = ours.user_embed(_t(rows), tb, _t(dense))
        i = ours.item_embed(_t(rows), tb, _t(dense))
        assert float((u[:, -1] - 1).abs().max()) == 0.0
        assert float((i[:, -2] - 1).abs().max()) == 0.0


@pytest.mark.parametrize("side", [-1.0, 0.0, 1.0], ids=["below-30", "inside", "above+30"])
@pytest.mark.parametrize("family", FAMILIES)
def test_gradients_match_grads_from_rows(family, side):
    """The step's forward and backward (K7's and K8's plain versions and
    autograd of the head, ``TrainStep._pooled_grads``) against the
    reference's ``grads_from_rows``: per-occurrence table gradients (each
    occurrence its own table row), the dense gradients, pctr and the
    log-loss.  Past |logit| > 30 the residual is the unclamped sigmoid's
    (a relative tolerance on the gradients, atol 0 for the tables)."""
    ours, ref = _models(family)
    batch = _batch(5, values=not side)
    rows, dense = _rows(6, scale=0.01 if side else 0.3), _dense(ref, 7)
    if side:
        # wide_deep / dcn: 8 or more live slots of w = +-5 (x = 1) push
        # |logit| past 40; two_tower: small towers whose bias lanes
        # b_u + b_i add +-40
        batch["mask"][:, :8] = 1.0
        batch["slots"][:, :8] = 1
        rows["w"][:] = 5.0 * side
        if family == "two_tower":
            dense = {k: v * 0.01 for k, v in dense.items()}
            dense["u_b2"][-1] = dense["i_b2"][-1] = 20.0 * side
    label = 0.0 if side < 0 else 1.0
    nb = dict(batch, labels=np.full(B, label, np.float32), weights=np.ones(B, np.float32))
    nb["labels"][::3] = 1.0 - label if not side else label
    mdl_rows = {k: v for k, v in rows.items() if family != "two_tower" or k == "emb"}
    pctr_ref, occ_ref, gd_ref = ref_grads_from_rows(ref, _j(mdl_rows), _j(dense), _j(nb),
                                                    jnp.float32(B))
    cfg = Config(model=family, table_size_log2=10, max_nnz=K, **GEOM[family])
    step = TrainStep(ours, make_optimizer(cfg), cfg, CPU)
    keys = torch.arange(B * K, dtype=torch.int32).reshape(B, K)
    keys = torch.where(torch.tensor(batch["mask"]) > 0, keys, torch.full_like(keys, -1))
    tables = {n: {"param": torch.tensor(v).reshape(B * K, -1)} for n, v in mdl_rows.items()}
    grads = {n: torch.zeros(B * K, v.shape[-1]) for n, v in mdl_rows.items()}
    view = {"ckeys": keys, "x": torch.tensor(batch["vals"] * batch["mask"]),
            "fields": torch.tensor(batch["slots"])}
    acc = torch.zeros(2, dtype=torch.float64)
    gd = step._pooled_grads(tables, view, torch.tensor(nb["labels"]),
                            torch.tensor(nb["weights"]), float(B), acc, grads, None, {},
                            _t(dense), {})
    logit = ours.logit({n: t["param"].reshape(B, K, -1) for n, t in tables.items()},
                       {"keys": keys.long().clamp(min=0), "slots": view["fields"].long(),
                        "vals": torch.tensor(batch["vals"]), "mask": torch.tensor(batch["mask"])},
                       _t(dense))
    if side:
        assert bool((logit * side > 30).all()), logit
    pctr = sigmoid_ref(logit)
    np.testing.assert_allclose(pctr.numpy(), np.asarray(pctr_ref), atol=PCTR_ATOL)
    ll = logloss_sum(torch.tensor(nb["labels"]), pctr, torch.tensor(nb["weights"]))
    np.testing.assert_allclose(float(acc[0]), float(ll), rtol=RTOL)
    for name, g in grads.items():
        want = np.asarray(occ_ref[name]).reshape(B * K, -1)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=0.0 if side else ATOL,
                                   err_msg=name)
        if side < 0 and name == "w":
            assert 0 < np.abs(want).max() < 1e-12  # the clamp's 1e-6 / B is not there
    assert set(gd) == set(gd_ref)
    for k, a in gd_ref.items():
        np.testing.assert_allclose(gd[k].numpy(), np.asarray(a), rtol=1e-5,
                                   atol=0.0 if side else ATOL, err_msg=k)
    assert float(acc[1]) == float(B)


# -- the Trainer, learning, artifacts, the CLI ----------------------------------


def _trainer_kw(ds, family, **kw):
    # tests/test_extended_models.py::make_cfg's geometry, narrower
    base = dict(train_path=ds.train_prefix, test_path=ds.test_prefix, epochs=3,
                batch_size=64, table_size_log2=14, max_nnz=24, max_fields=12,
                num_devices=1, model=family, emb_dim=4, hidden_dim=8, sgd_lr=0.05)
    if family == "two_tower":
        base["tower_split_field"] = 6
    base.update(kw)
    return base


def _ref_init(trainer):
    tables = {n: {k: np.asarray(jax.device_get(a)).copy() for k, a in t.items()}
              for n, t in trainer.state["tables"].items()}
    dense = {k: np.asarray(jax.device_get(a)).copy() for k, a in trainer.state["dense"].items()}
    return tables, dense


@pytest.mark.parametrize("mode", [{}, dict(update_mode="sequential", microbatch=4,
                                           sequential_inner="sparse")],
                         ids=["dense", "seq-sparse"])
@pytest.mark.parametrize("family", FAMILIES)
def test_trainer_tracks_jax_trainer(toy_dataset, family, mode):
    """The JAX Trainer and the port's from the same initial state (tables
    and dense parameters): per-epoch train log-loss, the eval log-loss
    and AUC within 1e-4, and the dense parameters at the end."""
    kw = _trainer_kw(toy_dataset, family, **mode)
    ref = RefTrainer(RefConfig(**kw))
    tables, dense = _ref_init(ref)
    ref_history = ref.train()
    want = ref.evaluate()
    ref_dense = {k: np.asarray(jax.device_get(a)) for k, a in ref.state["dense"].items()}
    ref.close()
    cfg = Config(**kw)
    with Trainer(cfg, device="cpu", log=lambda _: None) as ours:
        ours.state = state_from_numpy(cfg, tables, "cpu", dense=dense)
        history = ours.train()
        got = ours.evaluate()
        assert ours.step.wire_format == "dict"
        got_dense = dense_to_numpy(ours.state)
    for a, b in zip(history, ref_history):
        assert abs(a["train_logloss"] - b["train_logloss"]) < 1e-4
    assert got["examples"] == want["examples"]
    assert abs(got["auc"] - want["auc"]) < 1e-4
    assert abs(got["logloss"] - want["logloss"]) < 1e-4
    for k, a in ref_dense.items():
        np.testing.assert_allclose(got_dense[k], a, rtol=1e-4, atol=1e-5, err_msg=k)


def test_wide_deep_learns(toy_dataset):
    """tests/test_extended_models.py:98 in the port (its make_cfg: 12
    epochs, the family's default widths, sgd_lr 0.05)."""
    kw = dict(train_path=toy_dataset.train_prefix, test_path=toy_dataset.test_prefix,
              epochs=12, batch_size=64, table_size_log2=14, max_nnz=24, max_fields=12,
              num_devices=1, model="wide_deep", sgd_lr=0.05)
    with Trainer(Config(**kw), device="cpu", log=lambda _: None) as trainer:
        trainer.train()
        result = trainer.evaluate()
    assert result["auc"] > 0.68, result


def _lines(ds):
    with open(ds.test_prefix + "-00000") as f:
        return f.read().splitlines()


@pytest.mark.parametrize("family, hot", [("wide_deep", False), ("wide_deep", True),
                                         ("dcn", False), ("two_tower", False)])
def test_artifacts_score_equal_both_ways(toy_dataset, tmp_path, family, hot):
    """An artifact the JAX trainer exports (tables, dense.<name>.npy, the
    manifest's dense list) scores equal in the port's engine, and the
    port's export of the same model scores equal in the JAX engine;
    convert.py carries the tables with n and z, and the dense
    parameters, both ways."""
    extra = dict(hot_size_log2=6, hot_nnz=8, freq_sample_mib=1) if hot else {}
    kw = _trainer_kw(toy_dataset, family, epochs=1, **extra)
    trainer = RefTrainer(RefConfig(**kw))
    trainer.train()
    art = str(tmp_path / "jax_art")
    ref_export_artifact(trainer, art)
    tables, dense = _ref_init(trainer)
    remap = trainer.remap
    trainer.close()
    lines = _lines(toy_dataset)
    want = RefEngine.load(art, buckets=(8, 64), warm=False).score_text(lines)
    ours = PredictEngine.load(art, device="cpu", buckets=(8, 64))
    np.testing.assert_allclose(ours.score_text(lines), want, atol=PCTR_ATOL)
    assert ours.compile_count == 2
    cfg = Config(**kw)
    state = state_from_numpy(cfg, tables, "cpu", dense=dense)
    back = state_to_numpy(state, aux=True)
    for name, t in tables.items():
        for k, a in t.items():
            assert np.array_equal(back[name][k], a)
    assert all(np.array_equal(dense_to_numpy(state)[k], a) for k, a in dense.items())
    port_art = write_artifact(str(tmp_path / "port_art"), cfg,
                              {n: back[n]["param"] for n in tables}, step=3, remap=remap,
                              dense=dense)
    again = RefEngine.load(port_art, buckets=(8, 64), warm=False)
    np.testing.assert_allclose(again.score_text(lines), want, atol=PCTR_ATOL)
    with Trainer(cfg, device="cpu", log=lambda _: None) as trainer:
        trainer.state = state_from_numpy(cfg, tables, "cpu", dense=dense)
        exported = export_artifact(trainer, str(tmp_path / "trainer_art"))
    np.testing.assert_allclose(
        PredictEngine.load(exported, device="cpu", buckets=(8, 64)).score_text(lines), want,
        atol=PCTR_ATOL)
    np.testing.assert_allclose(
        RefEngine.load(exported, buckets=(8, 64), warm=False).score_text(lines), want,
        atol=PCTR_ATOL)
    with pytest.raises(ValueError, match="dense parameters"):
        write_artifact(str(tmp_path / "no_dense"), cfg, {n: back[n]["param"] for n in tables},
                       step=3, remap=remap)


@pytest.mark.parametrize("family, flags", [
    ("wide_deep", ["--emb-dim", "4", "--hidden-dim", "8"]),
    ("dcn", ["--emb-dim", "4", "--hidden-dim", "8", "--cross-layers", "3"]),
    ("two_tower", ["--tower-dim", "5", "--tower-split-field", "6", "--sgd-lr", "0.02"]),
])
def test_cli_trains_pooled_families(toy_dataset, tmp_path, family, flags):
    art = str(tmp_path / "art")
    rc = cli_main(["--model", family, "--max-fields", "12", *flags,
                   "--train", toy_dataset.train_prefix, "--test", toy_dataset.test_prefix,
                   "--epochs", "1", "--batch-size", "64", "--table-size-log2", "14",
                   "--max-nnz", "24", "--device", "cpu", "--export-artifact", art])
    assert rc in (0, None)
    engine = PredictEngine.load(art, device="cpu", buckets=(64,))
    assert engine.cfg.model == family
    assert set(engine.state["dense"]) == set(
        engine.model.dense_init(torch.Generator().manual_seed(0)))
    assert np.isfinite(engine.score_text(_lines(toy_dataset))).all()
