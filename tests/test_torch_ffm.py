"""FFM (B10) in the port, on the CPU, against the reference (xflow_tpu):

* the plain ``FFMModel.logit`` against the JAX ``logit`` and
  ``logit_pairwise`` (and the port's own ``logit_pairwise``), with
  padding, fields past ``max_fields`` and negative ones;
* the explicit ``grad_logit`` against ``jax.grad`` of the reference's
  logit and ``torch.autograd.grad`` of the port's (float64 there);
* the residual at logits past -30 and +30: the port's occurrence
  gradients against the reference's ``grads_from_rows`` (its autodiff
  loss), held to a relative tolerance on the gradients themselves, so
  the sigmoid's 1e-6 clamp cannot hide in an absolute one;
* (tests/test_torch_ffm_step.py: one K2 step against the JAX
  ``TrainStep`` in every update mode, the bf16 flag, the hot-inner
  refusal;)
* the Trainer against the JAX Trainer on ``toy_dataset``, FFM's
  learning test (tests/test_extended_models.py:91), artifacts both
  ways, the CLI's ``--model ffm``, and ``check_ffm_stage``'s refusal.

Tolerances: rtol 1e-5 / atol 1e-6 for the logit and the gradients
(ROADMAP's parity bar: the port sums in another order than XLA, and
autodiff's chain against the written-out gradient); 1e-4 for the
Trainer's log-losses and AUC over four epochs
(tests/test_torch_trainer.py's bound: float32 rounding carried through
FTRL); pctr atol 1e-6 (tests/test_serve.py's bar)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.models import make_model as ref_make_model
from xflow_tpu.models.ffm import FFMModel as RefFFM
from xflow_tpu.parallel.step import grads_from_rows as ref_grads_from_rows
from xflow_tpu.serve.artifact import export_artifact as ref_export_artifact
from xflow_tpu.serve.engine import PredictEngine as RefEngine
from xflow_tpu.trainer import Trainer as RefTrainer
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import state_from_numpy, state_to_numpy
from xflow_tpu_torch.models import FFMModel, make_model
from xflow_tpu_torch.models.blocks import ffm_field_interaction, valid_fields
from xflow_tpu_torch.ops.score import (
    MVM_SMEM_BYTES,
    check_ffm_stage,
    ffm_stage_bytes,
    ffm_tile,
    score,
)
from xflow_tpu_torch.ops.train import occurrence_grads, train_step
from xflow_tpu_torch.parallel.step import check_servable
from xflow_tpu_torch.serve.artifact import export_artifact, write_artifact
from xflow_tpu_torch.serve.engine import PredictEngine
from xflow_tpu_torch.train import main as cli_main
from xflow_tpu_torch.trainer import Trainer

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
PCTR_ATOL = 1e-6
B, K, F, D = 24, 10, 6, 3


# -- the model ---------------------------------------------------------------


def _model_batch(seed, values=True):
    """[B, K] planes with padding, fields drawn from a few of F (empty
    fields), fields past max_fields and negative ones."""
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
    return {"w": rng.normal(0, 1, (B, K, 1)).astype(np.float32),
            "v": rng.normal(0, scale, (B, K, F * D)).astype(np.float32)}


def _both(batch, rows):
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    tb = {k: torch.tensor(a) for k, a in batch.items()}
    jr = {k: jnp.asarray(a) for k, a in rows.items()}
    tr = {k: torch.tensor(a) for k, a in rows.items()}
    return jb, tb, jr, tr


@pytest.mark.parametrize("values", [True, False], ids=["full", "binary"])
def test_ffm_logit_matches_reference(values):
    """The aggregated logit against the JAX logit and logit_pairwise,
    and the port's pairwise oracle against both."""
    batch, rows = _model_batch(1, values), _rows(2)
    jb, tb, jr, tr = _both(batch, rows)
    ref, ours = RefFFM(v_dim=D, max_fields=F), FFMModel(v_dim=D, max_fields=F)
    want = np.asarray(ref.logit(jr, jb))
    np.testing.assert_allclose(np.asarray(ref.logit_pairwise(jr, jb)), want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ours.logit(tr, tb).numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours.logit_pairwise(tr, tb).numpy(), want, rtol=RTOL,
                               atol=ATOL)
    # the pair term alone, through the block, as the reference's
    from xflow_tpu.models import blocks as ref_blocks

    x = batch["vals"] * batch["mask"]
    valid = valid_fields(tb["slots"], tb["mask"], F)
    x_eff = torch.where(valid, torch.tensor(x), torch.zeros(()))
    slot = torch.clamp(tb["slots"], 0, F - 1)
    got = ffm_field_interaction(tr["v"], x_eff, slot, valid, F, D)
    jvalid = ref_blocks.valid_fields(jb["slots"], jb["mask"], F)
    want = ref_blocks.ffm_field_interaction(
        jr["v"], jnp.where(jvalid, jnp.asarray(x), 0.0), jnp.clip(jb["slots"], 0, F - 1),
        jvalid, F, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_ffm_gradient_matches_jax_grad_and_autograd():
    """grad_logit against jax.grad of the reference's logit (float32) and
    torch.autograd.grad of the port's (float64), with padding and fields
    outside [0, F), negative ones included: those get a zero v gradient
    and keep their w gradient x."""
    batch, rows = _model_batch(3), _rows(4)
    jb, tb, jr, tr = _both(batch, rows)
    ref, ours = RefFFM(v_dim=D, max_fields=F), FFMModel(v_dim=D, max_fields=F)
    want = jax.grad(lambda r: jnp.sum(ref.logit(r, jb)))(jr)
    got = ours.grad_logit(tr, tb)
    for name in ("w", "v"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    dropped = (batch["slots"] < 0) | (batch["slots"] >= F)
    live = batch["mask"] > 0
    assert (dropped & live).any()
    assert not got["v"][torch.tensor(dropped | ~live)].any()
    np.testing.assert_array_equal(got["w"][..., 0].numpy(), batch["vals"] * batch["mask"])
    t64 = {k: torch.tensor(a, dtype=torch.float64, requires_grad=True) for k, a in rows.items()}
    b64 = {k: (torch.tensor(a, dtype=torch.float64) if a.dtype == np.float32 else torch.tensor(a))
           for k, a in batch.items()}
    auto = torch.autograd.grad(ours.logit(t64, b64).sum(), [t64["w"], t64["v"]])
    explicit = ours.grad_logit({k: t.detach() for k, t in t64.items()}, b64)
    for name, a in zip(("w", "v"), auto):
        np.testing.assert_allclose(explicit[name].numpy(), a.numpy(), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("side", [-1.0, 1.0], ids=["below-30", "above+30"])
def test_ffm_residual_is_unclamped(side):
    """Past |logit| > 30 the reference's autodiff loss gives the residual
    sigmoid(logit) - y, unclamped: the port's occurrence gradients equal
    its grads_from_rows within a relative tolerance on each gradient
    (atol 0), while pctr keeps sigmoid_ref's clamp.  Below -30 with
    y = 0 the residual is about 1e-20, where the clamped sigmoid's would
    be 1e-6; above +30 with y = 1 it is 0 both ways in float32."""
    batch = _model_batch(5, values=False)
    rows = _rows(6, scale=0.01)
    rows["w"][:] = 5.0 * side
    batch["mask"][:, :8] = 1.0  # at least 8 live slots: |linear| >= 40
    batch["slots"][:, :8] = 1
    label = 0.0 if side < 0 else 1.0
    nb = dict(batch, labels=np.full(B, label, np.float32), weights=np.ones(B, np.float32))
    jb = {k: jnp.asarray(a) for k, a in nb.items()}
    model = RefFFM(v_dim=D, max_fields=F)
    pctr_ref, occ_ref, _ = ref_grads_from_rows(
        model, {k: jnp.asarray(a) for k, a in rows.items()}, {}, jb, jnp.float32(B))
    keys = torch.arange(B * K, dtype=torch.int32).reshape(B, K)
    keys = torch.where(torch.tensor(batch["mask"]) > 0, keys, torch.full_like(keys, -1))
    w = torch.tensor(rows["w"]).reshape(B * K, 1)
    v = torch.tensor(rows["v"]).reshape(B * K, F * D)
    occ, _, pctr, view = occurrence_grads(
        keys, None, torch.tensor(nb["labels"]), torch.tensor(nb["weights"]), float(B), w, v,
        fields=torch.tensor(batch["slots"]), max_fields=F, form="ffm")
    logit = FFMModel(v_dim=D, max_fields=F).logit({"w": w[keys.clamp(min=0).long()],
                                                    "v": v[keys.clamp(min=0).long()]}, view)
    assert bool((logit * side > 30).all())
    np.testing.assert_allclose(pctr.numpy(), np.asarray(pctr_ref), atol=PCTR_ATOL)
    for name in ("w", "v"):
        want = np.asarray(occ_ref[name])
        np.testing.assert_allclose(occ[name].numpy(), want, rtol=1e-5, atol=0.0)
        if side < 0:
            assert 0 < np.abs(want).max() < 1e-12  # the clamp's 1e-6 / B is not there


def test_registry_builds_ffm():
    cfg = Config(model="ffm", ffm_v_dim=3, max_fields=21, v_init_scale=0.03)
    model = make_model(cfg)
    assert isinstance(model, FFMModel) and model.uses_slots and model.autodiff
    assert (model.v_dim, model.max_fields, model.v_init_scale) == (3, 21, 0.03)
    specs = model.tables()
    assert [(t.name, t.dim, t.hot) for t in specs] == [("w", 1, True), ("v", 63, False)]
    ref_specs = ref_make_model(RefConfig(model="ffm", ffm_v_dim=3, max_fields=21)).tables()
    assert [(t.name, t.dim, t.hot) for t in ref_specs] == [(t.name, t.dim, t.hot)
                                                           for t in specs]


def test_ffm_stage_limit_is_refused_by_name():
    """One factor's stage (4 F^2 B plus the slots) past a block's 232,448
    B of shared memory is refused by name, in check_servable and the
    wrappers; the flagship's whole D fits one tile."""
    assert ffm_tile(39, 4, 40) == 4 and ffm_stage_bytes(39, 40, 4) == 24_336 + 640 + 128
    assert ffm_tile(39, 16, 40) == 7 and ffm_tile(64, 4, 40) == 2
    check_servable(Config(model="ffm", max_fields=240, wire_mode="full", hash_mode=False))
    assert ffm_stage_bytes(241, 40) > MVM_SMEM_BYTES >= ffm_stage_bytes(240, 40)
    with pytest.raises(ValueError, match="shared-memory stage"):
        check_servable(Config(model="ffm", max_fields=241, wire_mode="full", hash_mode=False))
    with pytest.raises(ValueError, match="shared-memory stage"):
        check_ffm_stage(241, 40)
    keys = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared-memory stage"):
        score(keys, None, torch.zeros((8, 1)), torch.zeros((8, 241)),
              fields=torch.zeros((2, 3), dtype=torch.int32), max_fields=241, form="ffm")
    with pytest.raises(ValueError, match="max_fields \\* D"):
        score(keys, None, torch.zeros((8, 1)), torch.zeros((8, 10)),
              fields=torch.zeros((2, 3), dtype=torch.uint8), max_fields=4, form="ffm")
    with pytest.raises(ValueError, match="form='mvm' or form='ffm'"):
        score(keys, None, torch.zeros((8, 1)), torch.zeros((8, 8)),
              fields=torch.zeros((2, 3), dtype=torch.uint8), max_fields=4)
    acc = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="no window-start mode"):
        train_step(keys, None, torch.zeros(2), torch.ones(2), 2.0, torch.zeros((8, 1)),
                   torch.zeros((8, 8)), torch.zeros((8, 1)), torch.zeros((8, 8)), acc,
                   hot_size=4, snap_w=torch.zeros((4, 1)), snap_v=torch.zeros((4, 8)),
                   fields=torch.zeros((2, 3), dtype=torch.uint8), max_fields=4, form="ffm")


# -- the Trainer, learning, artifacts, the CLI ----------------------------------


def _trainer_kw(ds, **kw):
    # tests/test_extended_models.py::make_cfg, with FFM's geometry
    base = dict(train_path=ds.train_prefix, test_path=ds.test_prefix, epochs=4,
                batch_size=64, table_size_log2=14, max_nnz=24, max_fields=12,
                num_devices=1, model="ffm", ffm_v_dim=2)
    base.update(kw)
    return base


@pytest.mark.parametrize("mode", [{}, dict(microbatch=4),
                                  dict(update_mode="sequential", microbatch=4,
                                       sequential_inner="sparse")],
                         ids=["dense", "dense-mb4", "seq-sparse"])
def test_trainer_ffm_tracks_jax_trainer(toy_dataset, mode):
    """The JAX Trainer and the port's from the same initial state:
    per-epoch train log-loss and the eval log-loss and AUC within 1e-4."""
    kw = _trainer_kw(toy_dataset, **mode)
    ref = RefTrainer(RefConfig(**kw))
    init = {n: {k: np.asarray(jax.device_get(a)).copy() for k, a in t.items()}
            for n, t in ref.state["tables"].items()}
    ref_history = ref.train()
    want = ref.evaluate()
    ref.close()
    cfg = Config(**kw)
    with Trainer(cfg, device="cpu", log=lambda _: None) as ours:
        ours.state = state_from_numpy(cfg, init, "cpu")
        history = ours.train()
        got = ours.evaluate()
        assert ours.step.wire_format == "dict"
    for a, b in zip(history, ref_history):
        assert abs(a["train_logloss"] - b["train_logloss"]) < 1e-4
    assert got["examples"] == want["examples"]
    assert abs(got["auc"] - want["auc"]) < 1e-4
    assert abs(got["logloss"] - want["logloss"]) < 1e-4


def test_ffm_learns(toy_dataset):
    """tests/test_extended_models.py:91 in the port (its make_cfg: 12
    epochs at the reference's default ffm_v_dim of 4)."""
    with Trainer(Config(**_trainer_kw(toy_dataset, epochs=12, ffm_v_dim=4)), device="cpu",
                 log=lambda _: None) as trainer:
        trainer.train()
        result = trainer.evaluate()
    assert result["auc"] > 0.68, result


def _lines(ds):
    with open(ds.test_prefix + "-00000") as f:
        return f.read().splitlines()


@pytest.mark.parametrize("hot", [False, True], ids=["nohot", "hot"])
def test_ffm_artifacts_score_equal_both_ways(toy_dataset, tmp_path, hot):
    """An FFM artifact the JAX trainer exports scores equal in the port's
    engine, and the port's export of the same model scores equal in the
    JAX engine; convert.py carries w, v, n and z both ways."""
    extra = dict(hot_size_log2=6, hot_nnz=8, freq_sample_mib=1) if hot else {}
    kw = _trainer_kw(toy_dataset, epochs=1, **extra)
    trainer = RefTrainer(RefConfig(**kw))
    trainer.train()
    art = str(tmp_path / "jax_art")
    ref_export_artifact(trainer, art)
    ref_tables = {n: {k: np.asarray(jax.device_get(a)) for k, a in t.items()}
                  for n, t in trainer.state["tables"].items()}
    remap = trainer.remap
    trainer.close()
    lines = _lines(toy_dataset)
    ref = RefEngine.load(art, buckets=(8, 64), warm=False)
    ours = PredictEngine.load(art, device="cpu", buckets=(8, 64))
    want = ref.score_text(lines)
    np.testing.assert_allclose(ours.score_text(lines), want, atol=PCTR_ATOL)
    assert ours.compile_count == 2
    cfg = Config(**kw)
    state = state_from_numpy(cfg, ref_tables, "cpu")
    back = state_to_numpy(state, aux=True)
    for name in ("w", "v"):
        assert set(back[name]) == set(ref_tables[name]) >= {"param", "n", "z"}
        for k, a in ref_tables[name].items():
            assert np.array_equal(back[name][k], a)
    assert back["v"]["param"].shape[1] == 12 * 2
    port_art = write_artifact(str(tmp_path / "port_art"), cfg,
                              {n: back[n]["param"] for n in ("w", "v")}, step=3, remap=remap)
    again = RefEngine.load(port_art, buckets=(8, 64), warm=False)
    np.testing.assert_allclose(again.score_text(lines), want, atol=PCTR_ATOL)
    with Trainer(cfg, device="cpu", log=lambda _: None) as trainer:
        trainer.state = state_from_numpy(cfg, ref_tables, "cpu")
        exported = export_artifact(trainer, str(tmp_path / "trainer_art"))
    np.testing.assert_allclose(
        PredictEngine.load(exported, device="cpu", buckets=(8, 64)).score_text(lines), want,
        atol=PCTR_ATOL)
    np.testing.assert_allclose(
        RefEngine.load(exported, buckets=(8, 64), warm=False).score_text(lines), want,
        atol=PCTR_ATOL)


def test_cli_trains_ffm(toy_dataset, tmp_path):
    art = str(tmp_path / "art")
    rc = cli_main(["--model", "ffm", "--ffm-v-dim", "2", "--max-fields", "12",
                   "--train", toy_dataset.train_prefix, "--test", toy_dataset.test_prefix,
                   "--epochs", "2", "--batch-size", "64", "--table-size-log2", "14",
                   "--max-nnz", "24", "--microbatch", "4", "--device", "cpu",
                   "--export-artifact", art])
    assert rc in (0, None)
    engine = PredictEngine.load(art, device="cpu", buckets=(64,))
    assert engine.cfg.model == "ffm" and engine.cfg.ffm_v_dim == 2
    assert np.isfinite(engine.score_text(_lines(toy_dataset))).all()
