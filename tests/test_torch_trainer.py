"""The port's Trainer, evaluate, metrics rows, export and CLI against the
reference's on ``toy_dataset`` (the tests/test_train.py scenarios), on
the CPU, each port run starting from the reference trainer's own
initial state.

Bound for training: per-epoch train log-loss and the final eval
log-loss and AUC within 1e-4 absolute of the reference.  One step
agrees within the parity bar (tests/test_torch_train_step.py); over
12 epochs x 12 steps the float32 summation-order differences are fed
back through FTRL's state and the next forward, and 1e-4 leaves two
orders of magnitude above what that noise reaches here while a wrong
gradient or update moves the log-loss by 1e-3 or more within an epoch.
Scores of one artifact in the two engines: atol 1e-6
(tests/test_serve.py's bar)."""

import json
import os

import jax
import numpy as np
import pytest

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.obs.schema import validate_rows
from xflow_tpu.serve.engine import PredictEngine as RefEngine
from xflow_tpu.trainer import Trainer as RefTrainer
from xflow_tpu.utils import metrics as ref_metrics
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import state_from_numpy
from xflow_tpu_torch.serve.artifact import export_artifact
from xflow_tpu_torch.serve.engine import PredictEngine
from xflow_tpu_torch.train import main as cli_main
from xflow_tpu_torch.trainer import Trainer
from xflow_tpu_torch.utils import metrics

TRACK = 1e-4
SCENARIOS = {
    "lr-ftrl": dict(model="lr", optimizer="ftrl"),
    "lr-sgd": dict(model="lr", optimizer="sgd", sgd_lr=0.05),
    "fm-ftrl": dict(model="fm", optimizer="ftrl"),
    # the touched-rows update modes: per-key FTRL steps over the same
    # batches, and 4 sequential slices per batch (4x the updates, each
    # at its slice's num_real) — the same 1e-4 holds
    "lr-ftrl-sparse": dict(model="lr", optimizer="ftrl", update_mode="sparse"),
    "fm-ftrl-sparse": dict(model="fm", optimizer="ftrl", update_mode="sparse"),
    "lr-sgd-seq-sparse": dict(model="lr", optimizer="sgd", sgd_lr=0.05,
                              update_mode="sequential", microbatch=4,
                              sequential_inner="sparse"),
    "fm-ftrl-seq-sparse": dict(model="fm", optimizer="ftrl",
                               update_mode="sequential", microbatch=4,
                               sequential_inner="sparse"),
}


def _kw(ds, **kw):
    # tests/test_train.py::make_cfg
    base = dict(train_path=ds.train_prefix, test_path=ds.test_prefix,
                epochs=12, batch_size=64, table_size_log2=14, max_nnz=24,
                max_fields=12, num_devices=1)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def reference_runs(toy_dataset):
    """Each scenario trained and evaluated by the JAX trainer, with the
    initial state it started from."""
    out = {}
    for name, kw in SCENARIOS.items():
        trainer = RefTrainer(RefConfig(**_kw(toy_dataset, **kw)))
        init = {
            n: {k: np.asarray(jax.device_get(a)).copy() for k, a in t.items()}
            for n, t in trainer.state["tables"].items()
        }
        history = trainer.train()
        result = trainer.evaluate()
        trainer.close()
        out[name] = (init, history, result)
    return out


def _port_trainer(cfg, init):
    trainer = Trainer(cfg, device="cpu", log=lambda _: None)
    trainer.state = state_from_numpy(cfg, init, "cpu")
    return trainer


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_trainer_tracks_reference(toy_dataset, reference_runs, tmp_path, scenario):
    init, ref_history, ref_result = reference_runs[scenario]
    metrics_out = str(tmp_path / "run.jsonl")
    cfg = Config(**_kw(toy_dataset, metrics_out=metrics_out, **SCENARIOS[scenario]))
    with _port_trainer(cfg, init) as trainer:
        history = trainer.train()
        result = trainer.evaluate()
    assert len(history) == len(ref_history) == cfg.epochs
    for ours, ref in zip(history, ref_history):
        # every field of the reference's row but the staging ring's
        # occupancy (A10), in every update mode
        assert set(ref) - {"transfer_ahead_depth_mean"} <= set(ours)
        assert ours["steps"] == ref["steps"] and ours["examples"] == ref["examples"]
        assert abs(ours["train_logloss"] - ref["train_logloss"]) < TRACK, (ours, ref)
    assert history[-1]["train_logloss"] < history[0]["train_logloss"]
    assert abs(result["logloss"] - ref_result["logloss"]) < TRACK
    assert abs(result["auc"] - ref_result["auc"]) < TRACK
    assert result["examples"] == ref_result["examples"] == toy_dataset.lines_per_shard
    assert (result["tp"], result["fp"]) == (ref_result["tp"], ref_result["fp"])
    assert result["auc"] > 0.68
    with open(metrics_out) as f:
        rows = [json.loads(line) for line in f]
    assert validate_rows(rows) == []
    kinds = [r["kind"] for r in rows]
    assert kinds[0] == "run_start" and kinds.count("train_epoch") == cfg.epochs
    assert {"shard", "wire", "device_mem", "eval"} <= set(kinds)
    wire = next(r for r in rows if r["kind"] == "wire")
    assert wire["format"] == "compact"


def test_port_artifact_loads_in_both_engines(toy_dataset, reference_runs, tmp_path):
    init, _, _ = reference_runs["fm-ftrl"]
    cfg = Config(**_kw(toy_dataset, epochs=2, **SCENARIOS["fm-ftrl"]))
    with _port_trainer(cfg, init) as trainer:
        trainer.train()
        pred_path = str(tmp_path / "pred.txt")
        result = trainer.evaluate(pred_out=pred_path)
        art = export_artifact(trainer, str(tmp_path / "art"))
    with open(toy_dataset.test_prefix + "-00000") as f:
        lines = f.read().splitlines()
    ours = PredictEngine.load(art, device="cpu", buckets=(8, 64)).score_text(lines)
    ref = RefEngine.load(art, buckets=(8, 64), warm=False).score_text(lines)
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    # and the engine scores the test lines as evaluate did (the pred
    # lines carry 6 decimals)
    with open(pred_path) as f:
        pred = np.array([float(line.split("\t")[1]) for line in f])
    assert len(pred) == result["examples"] == len(lines)
    np.testing.assert_allclose(ours, pred, atol=1e-6 + 5e-7)


def test_evaluate_per_block_pred_files(toy_dataset, tmp_path):
    cfg = Config(**_kw(toy_dataset, epochs=1, pred_style="per_block", batch_size=64))
    out = tmp_path / "preds"
    with Trainer(cfg, device="cpu", log=lambda _: None) as trainer:
        trainer.train()
        os.makedirs(out)
        (out / "pred_0_99.txt").write_text("stale\n")
        trainer.evaluate(pred_out=str(out))
    files = sorted(os.listdir(out))
    assert "pred_0_99.txt" not in files
    assert files == [f"pred_0_{i}.txt" for i in range(len(files))]
    total = sum(len((out / f).read_text().splitlines()) for f in files)
    assert total == toy_dataset.lines_per_shard


@pytest.mark.parametrize("kw, item", [
    ({"checkpoint_dir": "ck"}, "A6"),
    ({"profile_dir": "prof"}, "A14"),
    ({"obs_trace_out": "t.json"}, "A14"),
    ({"obs_watchdog": True}, "A14"),
    ({"chaos_spec": "loader.read_block:nth=2"}, "A14"),
])
def test_trainer_refuses_unported(toy_dataset, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        Trainer(Config(**_kw(toy_dataset, **kw)), device="cpu")


def test_trainer_default_device_is_the_card(toy_dataset):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(Config(**_kw(toy_dataset)))


def test_cli_trains_on_cpu_and_refuses_without_card(toy_dataset, tmp_path, capsys):
    import torch

    art = str(tmp_path / "art")
    argv = ["--model", "1", "--train", toy_dataset.train_prefix,
            "--test", toy_dataset.test_prefix, "--epochs", "2",
            "--batch-size", "64", "--table-size-log2", "12", "--max-nnz", "24"]
    assert cli_main(argv + ["--device", "cpu", "--export-artifact", art]) == 0
    err = capsys.readouterr().err.strip().splitlines()
    final = [line for line in err if line.startswith("logloss: ")]
    assert len(final) == 1 and "\tauc = " in final[0]
    assert os.path.exists(os.path.join(art, "manifest.json"))
    assert cli_main(argv + ["--resume"]) == 2
    assert "A6" in capsys.readouterr().err
    assert cli_main(argv + ["--device", "cpu", "--checkpoint-dir", str(tmp_path)]) == 2
    assert "A6" in capsys.readouterr().err
    assert cli_main(argv + ["--device", "cpu", "--hot-size-log2", "8"]) == 2
    assert "A8b" in capsys.readouterr().err
    assert cli_main(argv + ["--device", "cpu", "--update-mode", "sparse"]) == 0
    assert "\tauc = " in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert cli_main(argv) == 1
        assert "torch.cuda.is_available() is false" in capsys.readouterr().err


def test_metric_copies_match_reference():
    rng = np.random.default_rng(0)
    labels = (rng.random(500) > 0.6).astype(np.float32)
    pctr = np.round(rng.random(500), 2).astype(np.float32)  # ties
    pctr[:20] = 1.0
    assert metrics.auc_rank_sum(labels, pctr) == ref_metrics.auc_rank_sum(labels, pctr)
    assert metrics.auc_midrank(labels, pctr) == ref_metrics.auc_midrank(labels, pctr)
    assert np.isnan(metrics.auc_midrank(np.ones(4), np.ones(4)))
    ours, ref = metrics.AucAccumulator(), ref_metrics.AucAccumulator()
    weights = (rng.random(500) > 0.1).astype(np.float32)
    for acc in (ours, ref):
        acc.add(labels[:250], pctr[:250], weights[:250])
        acc.add(labels[250:], pctr[250:])
    assert ours.count() == ref.count()
    assert ours.compute() == ref.compute()
    import jax.numpy as jnp
    import torch

    for w in (None, weights):
        got = metrics.logloss(torch.tensor(labels), torch.tensor(pctr),
                              None if w is None else torch.tensor(w))
        want = ref_metrics.logloss(jnp.asarray(labels), jnp.asarray(pctr),
                                   None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
