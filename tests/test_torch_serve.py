"""The port's serving path against the reference's: artifacts exported
by the JAX trainer score equal in the port's PredictEngine (on the CPU,
atol 1e-6 — tests/test_serve.py's bar), artifacts the port writes score
equal in the JAX engine, and the engine's refusals, bucket invariant,
batcher and CLI."""

import io
import json
import os
import subprocess
import sys
import threading
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.io.batch import pack_batch as ref_pack_batch
from xflow_tpu.io.libffm import parse_block as ref_parse_block
from xflow_tpu.serve.artifact import export_artifact
from xflow_tpu.serve.artifact import load_manifest as ref_load_manifest
from xflow_tpu.serve.engine import PredictEngine as RefEngine
from xflow_tpu.trainer import Trainer
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import state_from_numpy, state_to_numpy
from xflow_tpu_torch.io.batch import Batch
from xflow_tpu_torch.serve.__main__ import main as cli_main
from xflow_tpu_torch.serve.artifact import MANIFEST, write_artifact
from xflow_tpu_torch.serve.batcher import MicroBatcher
from xflow_tpu_torch.serve.engine import PredictEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6


@pytest.fixture(scope="module")
def jax_artifacts(toy_dataset, tmp_path_factory):
    """lr and fm trained one epoch by the JAX trainer and exported."""
    out = {}
    for model in ("lr", "fm"):
        cfg = RefConfig(
            train_path=toy_dataset.train_prefix,
            test_path=toy_dataset.test_prefix,
            model=model, epochs=1, batch_size=64, table_size_log2=14,
            max_nnz=24, num_devices=1,
        )
        trainer = Trainer(cfg)
        trainer.train()
        art = str(tmp_path_factory.mktemp("torch_serve") / f"{model}_artifact")
        export_artifact(trainer, art)
        trainer.close()
        out[model] = art
    return out


def _test_lines(toy_dataset):
    with open(toy_dataset.test_prefix + "-00000") as f:
        return f.read().splitlines()


def _raw_batches(cfg, lines, size=64):
    """(reference Batch, port Batch) pairs with the same planes."""
    block = ref_parse_block(
        ("\n".join(lines) + "\n").encode(), cfg.table_size, cfg.hash_mode, cfg.seed
    )
    pairs = []
    for s in range(0, block.num_samples, size):
        e = min(s + size, block.num_samples)
        ref = ref_pack_batch(block, s, e, e - s, cfg.max_nnz)
        ours = Batch(keys=ref.keys, slots=ref.slots, vals=ref.vals,
                     mask=ref.mask, labels=ref.labels, weights=ref.weights)
        pairs.append((ref, ours))
    return pairs


@pytest.mark.parametrize("model", ["lr", "fm"])
def test_jax_artifact_scores_equal_in_port(jax_artifacts, toy_dataset, model):
    art = jax_artifacts[model]
    ref = RefEngine.load(art, buckets=(8, 64), warm=False)
    ours = PredictEngine.load(art, device="cpu", buckets=(8, 64))
    assert ours.digest == ref.digest and ours.cfg.to_json() == ref.cfg.to_json()
    lines = _test_lines(toy_dataset)
    for ref_batch, batch in _raw_batches(ours.cfg, lines):
        np.testing.assert_allclose(
            ours.predict(batch), ref.predict(ref_batch), atol=ATOL
        )
    got, want = ours.score_text(lines), ref.score_text(lines)
    assert got.shape == want.shape == (len(lines),)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _seed_tables(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tables = {"w": (rng.standard_normal((cfg.table_size, 1)) * 0.5).astype(np.float32)}
    if cfg.model == "fm":
        tables["v"] = (rng.standard_normal((cfg.table_size, cfg.v_dim)) * 0.1).astype(np.float32)
    return tables


@pytest.mark.parametrize("model", ["lr", "fm"])
def test_port_artifact_scores_equal_in_jax(toy_dataset, tmp_path, model):
    cfg = Config(model=model, table_size_log2=12, max_nnz=24, v_dim=6)
    art = write_artifact(str(tmp_path / "art"), cfg, _seed_tables(cfg), step=7)
    manifest = ref_load_manifest(art)
    assert manifest["step"] == 7 and manifest["config_digest"] == cfg.digest()
    ref = RefEngine.load(art, buckets=(8, 64), warm=False)
    ours = PredictEngine.load(art, device="cpu", buckets=(8, 64))
    lines = _test_lines(toy_dataset)
    np.testing.assert_allclose(
        ours.score_text(lines), ref.score_text(lines), atol=ATOL
    )
    # rewriting in place replaces the artifact atomically
    write_artifact(art, cfg, _seed_tables(cfg, seed=1), step=8)
    assert ref_load_manifest(art)["step"] == 8
    assert sorted(os.listdir(tmp_path)) == ["art"]


def test_state_round_trip_and_jax_state(jax_artifacts, toy_dataset):
    ref = RefEngine.load(jax_artifacts["fm"], buckets=(64,), warm=False)
    tables = {
        name: np.asarray(t["param"]) for name, t in ref.state["tables"].items()
    }
    cfg = Config.from_json(ref.cfg.to_json())
    state = state_from_numpy(cfg, tables, "cpu", step=3)
    back = state_to_numpy(state)
    assert set(back) == {"w", "v"} and state["step"] == 3
    for name in tables:
        assert back[name].dtype == np.float32
        assert np.array_equal(back[name], tables[name])
    engine = PredictEngine(cfg, state, device="cpu", buckets=(64,))
    lines = _test_lines(toy_dataset)
    np.testing.assert_allclose(
        engine.score_text(lines), ref.score_text(lines), atol=ATOL
    )
    with pytest.raises(ValueError, match="must be float32"):
        state_from_numpy(cfg, {"w": tables["w"][:10], "v": tables["v"]}, "cpu")
    with pytest.raises(ValueError, match="has tables"):
        state_from_numpy(cfg, {"w": tables["w"]}, "cpu")


def test_compile_count_flat_under_mixed_traffic(jax_artifacts):
    engine = PredictEngine.load(
        jax_artifacts["lr"], device="cpu", buckets=(1, 8, 64)
    )
    assert engine.buckets == (1, 8, 64) and engine.compile_count == 3
    replica = engine.clone()
    rng = np.random.default_rng(0)
    table = engine.cfg.table_size
    for n in (1, 2, 3, 7, 8, 9, 40, 64, 65, 200):
        rows = [
            rng.integers(0, table, size=int(rng.integers(1, 10)))
            for _ in range(n)
        ]
        assert engine.predict(engine.featurize_raw(rows)).shape == (n,)
        assert replica.predict(replica.featurize_raw(rows)).shape == (n,)
    assert engine.compile_count == replica.compile_count == 3
    assert engine.bucket_for(9) == 64 and engine.bucket_for(500) == 64


def test_value_carrying_request_rejected_on_compact_wire(jax_artifacts):
    engine = PredictEngine.load(jax_artifacts["lr"], device="cpu", buckets=(8,))
    assert engine.step.compact_wire
    bad = (np.asarray([3, 5]), None, np.asarray([0.5, 2.0]))
    with pytest.raises(ValueError, match="compact wire"):
        engine.predict(engine.featurize_raw([bad]))


def _rewrite_config(art, cfg):
    """Swap the artifact's embedded config (with a matching digest)."""
    path = os.path.join(art, MANIFEST)
    manifest = json.load(open(path))
    manifest["config"], manifest["config_digest"] = cfg.to_json(), cfg.digest()
    json.dump(manifest, open(path, "w"))


def test_load_refusals(tmp_path):
    cfg = Config(model="lr", table_size_log2=10, max_nnz=8)
    art = write_artifact(str(tmp_path / "lr"), cfg, _seed_tables(cfg), step=1)
    with pytest.raises(ValueError, match="refusing to serve a mismatched"):
        PredictEngine.load(art, config=cfg.replace(max_nnz=9), device="cpu")
    assert PredictEngine.load(art, config=cfg, device="cpu", warm=False)
    path = os.path.join(art, MANIFEST)
    manifest = json.load(open(path))
    manifest["config_digest"] = "0" * 12
    json.dump(manifest, open(path, "w"))
    with pytest.raises(ValueError, match="corrupt or tampered"):
        PredictEngine.load(art, device="cpu")
    # a hot model serves now, with its remap; without it, the
    # reference's refusal
    _rewrite_config(art, cfg.replace(hot_size_log2=6, hot_nnz=8))
    with pytest.raises(ValueError, match="no remap was provided"):
        PredictEngine.load(art, device="cpu")
    for changes, item in (
        ({"store_mode": "tiered", "hot_capacity_log2": 6}, "A11"),
        # MVM and FFM serve now (tests/test_torch_mvm.py,
        # tests/test_torch_ffm.py); the tiered store stays refused
        ({"model": "ffm", "store_mode": "tiered", "hot_capacity_log2": 6}, "A11"),
        # two_tower serves now (tests/test_torch_topk.py); the tiered
        # store stays refused
        ({"model": "two_tower", "max_fields": 8, "tower_split_field": 4,
          "store_mode": "tiered", "hot_capacity_log2": 6}, "A11"),
    ):
        _rewrite_config(art, cfg.replace(**changes))
        with pytest.raises(NotImplementedError, match=item):
            PredictEngine.load(art, device="cpu")


def test_default_device_is_the_card(tmp_path):
    """No silent CPU fallback: without a card the default refuses."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = Config(model="lr", table_size_log2=10, max_nnz=8)
    art = write_artifact(str(tmp_path / "lr"), cfg, _seed_tables(cfg), step=1)
    with pytest.raises(RuntimeError, match="cuda"):
        PredictEngine.load(art)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_main(["score", art, "--input", os.devnull])


def test_batcher_matches_engine_and_closes(jax_artifacts):
    engine = PredictEngine.load(jax_artifacts["fm"], device="cpu", buckets=(1, 8, 64))
    rng = np.random.default_rng(1)
    rows = [rng.integers(0, engine.cfg.table_size, size=int(rng.integers(1, 30)))
            for _ in range(96)]
    want = engine.predict(engine.featurize_raw(rows))
    got = np.zeros(len(rows), np.float32)
    batcher = MicroBatcher(engine, max_wait_ms=5.0)

    def client(idx):
        for i in idx:
            got[i] = batcher.submit(rows[i]).result(timeout=60)

    threads = [threading.Thread(target=client, args=(range(c, 96, 6),)) for c in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert batcher.score(rows[0]) == pytest.approx(float(want[0]), abs=ATOL)
    stats = batcher.close()
    assert stats == batcher.close()  # idempotent
    assert stats["requests"] == 97 and stats["batches"] >= 1
    assert stats["device_p99"] >= stats["device_p50"] > 0
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert engine.compile_count == 3
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(rows[0])


def test_cli_score_matches_jax_cli(jax_artifacts, toy_dataset, tmp_path):
    art = jax_artifacts["fm"]
    src = toy_dataset.test_prefix + "-00000"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    outs = {}
    for pkg in ("xflow_tpu", "xflow_tpu_torch"):
        out = tmp_path / f"{pkg}.txt"
        cmd = [sys.executable, "-m", f"{pkg}.serve", "score", art,
               "--input", src, "--out", str(out), "--buckets", "8,64"]
        if pkg == "xflow_tpu_torch":
            cmd += ["--device", "cpu"]
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        outs[pkg] = np.loadtxt(out)
    assert outs["xflow_tpu_torch"].shape == outs["xflow_tpu"].shape
    np.testing.assert_allclose(outs["xflow_tpu_torch"], outs["xflow_tpu"], atol=2e-6)


def test_cli_bench_on_cpu(jax_artifacts):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli_main(["bench", jax_artifacts["lr"], "--device", "cpu",
                       "--requests", "64", "--concurrency", "4",
                       "--buckets", "1,8,64"])
    assert rc == 0
    summary = json.loads(buf.getvalue())
    assert summary["requests"] == 64 and summary["compiles"] == 3
    assert summary["device"] == "cpu" and summary["e2e_p99"] > 0
