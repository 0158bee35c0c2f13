"""Checkpoints, resume and preemption in the port (utils/checkpoint.py,
Trainer.save / restore / train, the CLI's --resume) against the JAX
package's, on the CPU with ``toy_dataset``.

* The same state saved by either package gives the same files, byte for
  byte, and the same manifest; neither writes the port's gradient
  buffer ``g``.
* A checkpoint either package writes restores in the other bit-equal:
  LR, FM, a hot FM with its ``remap.npy``, ``wide_deep`` with its dense
  arrays, and one written on a 2-device JAX mesh (two row ranges an
  array).  Continued training then tracks the other package's: one
  step within the parity bar (rtol 1e-5 / atol 1e-6 on every table
  array, ``tests/test_ftrl.py``'s bar), an epoch's train log-loss
  within ``TRACK`` (1e-4, tests/test_torch_trainer.py's bound: float32
  summation order fed back through FTRL).
* The port alone (tests/test_checkpoint.py's cases): the port's CPU
  path is deterministic (the same sums in the same order), so a resumed
  run's tables EQUAL a straight run's, bit for bit.
"""

import json
import os
import shutil
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.trainer import Trainer as RefTrainer
from xflow_tpu.utils import checkpoint as ref_ckpt
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import dense_to_numpy, state_from_numpy, state_to_numpy
from xflow_tpu_torch.trainer import Trainer
from xflow_tpu_torch.utils import checkpoint as ckpt

TRACK = 1e-4
RTOL, ATOL = 1e-5, 1e-6
HOT = dict(hot_size_log2=6, hot_nnz=4)
WIDE = dict(model="wide_deep", emb_dim=4, hidden_dim=8, sgd_lr=0.05)
SCENARIOS = {
    "lr": dict(model="lr"),
    "fm": dict(model="fm"),
    "fm-hot": dict(model="fm", **HOT),
    "wide_deep": WIDE,
}


def _kw(ds, ck, **kw):
    base = dict(train_path=ds.train_prefix, test_path=ds.test_prefix, epochs=1,
                batch_size=64, table_size_log2=12, max_nnz=24, max_fields=12,
                num_devices=1, checkpoint_dir=str(ck))
    base.update(kw)
    return base


def _quiet(cfg, **kw):
    return Trainer(cfg, device="cpu", log=lambda _: None, **kw)


def _ref_arrays(trainer) -> dict:
    out = {f"{n}.{k}": np.asarray(jax.device_get(a))
           for n, t in trainer.state["tables"].items() for k, a in t.items()}
    out.update({f"dense.{k}": np.asarray(jax.device_get(a))
                for k, a in trainer.state["dense"].items()})
    return out


def _port_arrays(trainer) -> dict:
    out = {f"{n}.{k}": a for n, t in state_to_numpy(trainer.state, aux=True).items()
           for k, a in t.items()}
    out.update({f"dense.{k}": a for k, a in dense_to_numpy(trainer.state).items()})
    return out


def _assert_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)


def _assert_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, arr in want.items():
        np.testing.assert_allclose(got[key], arr, rtol=RTOL, atol=ATOL, err_msg=key)


def _first_batch(trainer):
    batch, _, _ = next(iter(trainer.iter_train_batches()))
    return batch


# -- (1) file-level parity -------------------------------------------------


@pytest.mark.parametrize("scenario", ["lr", "fm", "wide_deep"])
def test_same_state_same_files(toy_dataset, tmp_path, scenario):
    """From the JAX trainer's initial state, each package's
    save_checkpoint writes the same file names and bytes and the same
    manifest (format 2, step, arrays' shapes and dtypes, dense names,
    cursor, config); the port's dense-mode state holds ``g`` and writes
    none."""
    kw = _kw(toy_dataset, tmp_path / "unused", **SCENARIOS[scenario])
    ref = RefTrainer(RefConfig(**kw))
    cfg = Config(**kw)
    tables = {n: {k: np.asarray(jax.device_get(a)) for k, a in t.items()}
              for n, t in ref.state["tables"].items()}
    dense = {k: np.asarray(jax.device_get(a)) for k, a in ref.state["dense"].items()}
    state = state_from_numpy(cfg, tables, "cpu", dense=dense)
    assert all("g" in t for t in state["tables"].values())
    cursor = {"epoch": 0, "num_hosts": 1, "cursors": [{"shard": 1, "offset": 4096}],
              "shard": 1, "offset": 4096}
    theirs = ref_ckpt.save_checkpoint(str(tmp_path / "jax"), ref.state, cursor, cfg.to_json())
    ours = ckpt.save_checkpoint(str(tmp_path / "port"), state, cursor, cfg.to_json())
    ref.close()
    assert os.path.basename(ours) == os.path.basename(theirs) == "ckpt-0000000000"
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs))
    assert not [n for n in names if ".g." in n or n.startswith("g.")]
    for name in names:
        with open(os.path.join(ours, name), "rb") as f, \
                open(os.path.join(theirs, name), "rb") as g:
            if name == ckpt.MANIFEST:
                assert json.load(f) == json.load(g)
            else:
                assert f.read() == g.read(), name
    for directory in ("jax", "port"):
        with open(tmp_path / directory / "LATEST") as f:
            assert f.read() == "ckpt-0000000000"


# -- (2) JAX -> port and (3) port -> JAX -----------------------------------


def _continue(trainer, ref) -> None:
    """One step on each side from the restored state (the same first
    batch), held to the parity bar."""
    ref.state, _ = ref.step.dispatch_train(ref.state, ref.step.put_batch(_first_batch(ref)))
    trainer.step.dispatch_train(trainer.state, trainer.step.put_batch(_first_batch(trainer)))
    _assert_close(_port_arrays(trainer), _ref_arrays(ref))


@pytest.mark.parametrize("scenario", ["lr", "fm", "fm-hot", "wide_deep", "lr-2dev"])
def test_jax_checkpoint_restores_in_port(toy_dataset, tmp_path, scenario):
    """A JAX run's epoch-end checkpoint (on a 2-device mesh for
    ``lr-2dev``: every array in two row ranges) restores in the port
    bit-equal, step, epoch, cursor and remap included, with ``g`` zero;
    then both sides go on from it."""
    ck = tmp_path / "ck"
    kw = _kw(toy_dataset, ck, **SCENARIOS[scenario.split("-2dev")[0]])
    ref_kw = dict(kw, num_devices=2) if scenario.endswith("2dev") else kw
    ref = RefTrainer(RefConfig(**ref_kw))
    ref.train()
    want = _ref_arrays(ref)
    step = int(jax.device_get(ref.state["step"]))
    ref.close()
    path = ref_ckpt.latest_checkpoint(str(ck))
    if scenario.endswith("2dev"):
        assert len([f for f in os.listdir(path) if f.startswith("w.param.r")]) == 2
    fork = tmp_path / "fork"
    shutil.copytree(ck, fork)
    lines = []
    trainer = Trainer(Config(**kw), device="cpu", log=lines.append)
    cursor = trainer.restore()
    assert cursor["epoch"] == trainer.epoch == 1 and trainer._resume_cursor == (0, 0)
    assert trainer.state["step"] == step and isinstance(trainer.state["step"], int)
    _assert_equal(_port_arrays(trainer), want)
    assert all(float(t["g"].abs().max()) == 0.0 for t in trainer.state["tables"].values())
    if "hot" in scenario:
        np.testing.assert_array_equal(trainer.remap, np.load(ck / "remap.npy"))
        assert trainer.hot_mass is None and not [s for s in lines if "hot remap" in s]
    # both go on from the checkpoint: one step within the parity bar ...
    ref = RefTrainer(RefConfig(**dict(ref_kw, checkpoint_dir=str(fork))))
    ref.restore()
    _continue(trainer, ref)
    ref.close()
    trainer.close()
    # ... and a second epoch within TRACK
    runs = []
    for side in ("port", "jax"):
        directory = tmp_path / f"more-{side}"
        shutil.copytree(fork, directory)
        more = dict(ref_kw if side == "jax" else kw, epochs=2, checkpoint_dir=str(directory))
        t = RefTrainer(RefConfig(**more)) if side == "jax" else _quiet(Config(**more))
        t.restore()
        runs.append(t.train())
        t.close()
    assert len(runs[0]) == len(runs[1]) == 1
    assert abs(runs[0][0]["train_logloss"] - runs[1][0]["train_logloss"]) < TRACK


@pytest.mark.parametrize("scenario", ["lr", "fm", "fm-hot", "wide_deep"])
def test_port_checkpoint_restores_in_jax(toy_dataset, tmp_path, scenario):
    """The mirror image: the port's epoch-end checkpoint restores in the
    JAX trainer bit-equal (its remap.npy too), and both go on from it."""
    ck = tmp_path / "ck"
    kw = _kw(toy_dataset, ck, **SCENARIOS[scenario])
    with _quiet(Config(**kw)) as trainer:
        trainer.train()
        want = _port_arrays(trainer)
        step = trainer.state["step"]
        remap = trainer.remap
    ref = RefTrainer(RefConfig(**kw))
    cursor = ref.restore()
    assert cursor["epoch"] == ref.epoch == 1
    assert int(jax.device_get(ref.state["step"])) == step
    _assert_equal(_ref_arrays(ref), want)
    if remap is not None:
        np.testing.assert_array_equal(ref.remap, remap)
    port = _quiet(Config(**kw))
    port.restore()
    _continue(port, ref)
    port.close()
    ref.close()


# -- (4) the port alone ----------------------------------------------------


def test_round_trip(toy_dataset, tmp_path):
    kw = _kw(toy_dataset, tmp_path, model="fm", epochs=2)
    with _quiet(Config(**kw)) as trainer:
        trainer.train()
        want = _port_arrays(trainer)
        step = trainer.state["step"]
    with _quiet(Config(**kw)) as again:
        cursor = again.restore()
        assert cursor["epoch"] == 2 and again.state["step"] == step
        _assert_equal(_port_arrays(again), want)
        with open(os.path.join(ckpt.latest_checkpoint(str(tmp_path)), ckpt.MANIFEST)) as f:
            manifest = json.load(f)
    assert manifest["format"] == 2 and manifest["step"] == step
    assert manifest["config"] == Config(**kw).to_json()
    assert sorted(manifest["arrays"]) == ["v.n", "v.param", "v.z", "w.n", "w.param", "w.z"]


@pytest.mark.parametrize("mode", [{}, dict(update_mode="sparse")], ids=["dense", "sparse"])
def test_two_plus_two_epochs_equal_four(toy_dataset, tmp_path, mode):
    """2 epochs, a checkpoint, 2 more from a fresh trainer: the tables
    EQUAL 4 straight epochs' (the CPU path is deterministic)."""
    straight = _quiet(Config(**_kw(toy_dataset, tmp_path / "a", model="fm", epochs=4, **mode)))
    straight.train()
    with _quiet(Config(**_kw(toy_dataset, tmp_path / "b", model="fm", epochs=2, **mode))) as t:
        t.train()
    rest = _quiet(Config(**_kw(toy_dataset, tmp_path / "b", model="fm", epochs=4, **mode)))
    rest.restore()
    assert rest.epoch == 2
    history = rest.train()
    assert [h["epoch"] for h in history] == [2, 3]
    _assert_equal(_port_arrays(rest), _port_arrays(straight))
    assert rest.state["step"] == straight.state["step"]
    straight.close()
    rest.close()


def test_mid_epoch_cursor_reaches_train_epoch(toy_dataset, tmp_path, monkeypatch):
    with _quiet(Config(**_kw(toy_dataset, tmp_path, epochs=2))) as t:
        assert t.save(shard_idx=1, offset=4096) is not None
    t2 = _quiet(Config(**_kw(toy_dataset, tmp_path, epochs=2)))
    cursor = t2.restore()
    assert (cursor["shard"], cursor["offset"]) == (1, 4096)
    assert cursor["cursors"] == [{"shard": 1, "offset": 4096}]
    calls = []
    real = t2.train_epoch

    def spy(start_shard=0, start_offset=0):
        calls.append((start_shard, start_offset))
        return real(start_shard=0, start_offset=0)  # toy offsets exceed a block

    monkeypatch.setattr(t2, "train_epoch", spy)
    t2.train()
    t2.close()
    assert calls == [(1, 4096), (0, 0)]


def test_resume_mid_shard_skips_what_was_trained(toy_dataset, tmp_path):
    """A cursor at the end of shard 0 resumes at shard 1: the epoch's
    remaining batches are exactly the straight epoch's tail."""
    with _quiet(Config(**_kw(toy_dataset, tmp_path))) as t:
        batches = list(t.iter_train_batches())
        shard0 = [b for b in batches if b[1] == 0]
        tail = list(t.iter_train_batches(0, shard0[-1][2]))
    assert shard0[-1][2] == os.path.getsize(toy_dataset.train_prefix + "-00000")
    assert len(tail) == len(batches) - len(shard0)
    for (a, si, off), (b, sj, offj) in zip(tail, batches[len(shard0):]):
        assert (si, off) == (sj, offj)
        np.testing.assert_array_equal(a.keys, b.keys)


def test_checkpoint_keep_gc(toy_dataset, tmp_path):
    """checkpoint_keep=2 leaves the newest two generations, LATEST on
    the newest; a manifest-less dir is neither counted nor deleted."""
    kw = _kw(toy_dataset, tmp_path, epochs=4, checkpoint_keep=2)
    os.makedirs(tmp_path / "ckpt-0000000001")  # corrupt: no manifest
    with _quiet(Config(**kw)) as t:
        t.train()
    complete = sorted(d for d in os.listdir(tmp_path)
                      if d.startswith("ckpt-") and ckpt.is_complete(str(tmp_path / d)))
    assert len(complete) == 2 and (tmp_path / "ckpt-0000000001").is_dir()
    with open(tmp_path / "LATEST") as f:
        assert f.read() == complete[-1]
    assert ckpt.latest_complete(str(tmp_path)).endswith(complete[-1])
    with _quiet(Config(**kw)) as t2:
        assert t2.restore()["epoch"] == 4


@pytest.mark.parametrize("site", ["ckpt.write_shard", "ckpt.finalize"])
def test_failed_save_leaves_previous_generation(toy_dataset, tmp_path, monkeypatch, site):
    """A save that fails mid-write or mid-commit (the failpoint sites)
    raises, leaves no .tmp-* dir and a ``checkpoint_save_failed`` health
    row, and the previous generation restores."""
    metrics = str(tmp_path / "run.jsonl")
    ck = tmp_path / "ck"
    trainer = _quiet(Config(**_kw(toy_dataset, ck, epochs=2, metrics_out=metrics)))
    trainer.train_epoch()
    trainer.epoch = 1
    first = trainer.save()
    saved = _port_arrays(trainer)
    trainer.train_epoch()

    def fire(name):
        if name == site:
            raise OSError(f"injected at {name}")

    monkeypatch.setattr(ckpt, "failpoint", fire)
    with pytest.raises(OSError, match="injected"):
        trainer._timed_save(0, 0)
    monkeypatch.undo()
    trainer.close()
    assert not [d for d in os.listdir(ck) if d.startswith(".tmp-")]
    assert ckpt.latest_complete(str(ck)) == first == ckpt.latest_checkpoint(str(ck))
    with open(metrics) as f:
        health = [r for r in map(json.loads, f) if r["kind"] == "health"]
    assert [r["cause"] for r in health] == ["checkpoint_save_failed"]
    with _quiet(Config(**_kw(toy_dataset, ck, epochs=2))) as again:
        again.restore()
        _assert_equal(_port_arrays(again), saved)


def test_resume_auto_skips_manifestless_generation(toy_dataset, tmp_path):
    """A newer generation without a manifest (killed mid-commit, or
    corrupted): ``--resume auto`` restores the newest complete one with
    a ``checkpoint_fallback`` health row; plain resume follows LATEST
    and starts fresh."""
    ck = tmp_path / "ck"
    with _quiet(Config(**_kw(toy_dataset, ck))) as t:
        t.train()
        want = _port_arrays(t)
        good = ckpt.latest_checkpoint(str(ck))
    bad = str(ck / "ckpt-0000009999")
    shutil.copytree(good, bad)
    os.remove(os.path.join(bad, ckpt.MANIFEST))
    with open(ck / "LATEST", "w") as f:
        f.write("ckpt-0000009999")
    metrics = str(tmp_path / "run.jsonl")
    lines = []
    with Trainer(Config(**_kw(toy_dataset, ck, metrics_out=metrics)), device="cpu",
                 log=lines.append) as auto:
        assert auto.restore(auto=True)["epoch"] == 1
        _assert_equal(_port_arrays(auto), want)
    assert any("resume auto: skipping unusable checkpoint" in s for s in lines)
    with open(metrics) as f:
        health = [r for r in map(json.loads, f) if r["kind"] == "health"]
    assert [r["cause"] for r in health] == ["checkpoint_fallback"]
    assert "ckpt-0000009999" in health[0]["detail"]
    with _quiet(Config(**_kw(toy_dataset, ck))) as plain:
        assert plain.restore() is None and plain.epoch == 0


@pytest.mark.parametrize("edit, match", [
    ({"format": 1}, "unsupported format 1"),
    ({"store": {"hot_capacity": 4}}, "store_mode='tiered'"),
])
def test_incompatible_checkpoint(toy_dataset, tmp_path, edit, match):
    with _quiet(Config(**_kw(toy_dataset, tmp_path))) as t:
        t.train()
        path = ckpt.latest_checkpoint(str(tmp_path))
        with open(os.path.join(path, ckpt.MANIFEST)) as f:
            manifest = json.load(f)
        manifest.update(edit)
        with open(os.path.join(path, ckpt.MANIFEST), "w") as f:
            json.dump(manifest, f)
        with pytest.raises(ckpt.IncompatibleCheckpoint, match=match):
            ckpt.load_checkpoint(path, t.state)
    with _quiet(Config(**_kw(toy_dataset, tmp_path))) as t2:
        assert t2.restore() is None  # plain resume: "starting fresh"
    with pytest.raises(ckpt.IncompatibleCheckpoint, match="no manifest.json"):
        ckpt.load_checkpoint(str(tmp_path / "missing"), t2.state)


def test_shape_mismatch_and_missing_arrays(toy_dataset, tmp_path):
    with _quiet(Config(**_kw(toy_dataset, tmp_path, model="fm"))) as t:
        t.train()
    path = ckpt.latest_checkpoint(str(tmp_path))
    with _quiet(Config(**_kw(toy_dataset, tmp_path / "other", model="fm",
                             table_size_log2=11))) as small:
        with pytest.raises(ValueError, match="shape"):
            ckpt.load_checkpoint(path, small.state)
    with _quiet(Config(**_kw(toy_dataset, tmp_path / "lr", model="lr"))) as lr:
        state, _ = ckpt.load_checkpoint(path, lr.state)  # LR's w of an FM checkpoint
        assert set(state["tables"]) == {"w"}
    os.remove(os.path.join(path, "v.z.r000000000000-000000004096.npy"))
    with _quiet(Config(**_kw(toy_dataset, tmp_path / "fm2", model="fm"))) as fm:
        with pytest.raises(ValueError, match="missing"):
            ckpt.load_checkpoint(path, fm.state)


# -- (5) hot models ---------------------------------------------------------


def test_hot_remap_persists_and_toggle_is_refused(toy_dataset, tmp_path):
    """The remap is saved in checkpoint_dir on the first run and reused
    (not counted again) by the next; a hot toggle across the directory
    is refused either way, in the reference's words."""
    kw = _kw(toy_dataset, tmp_path / "hot", model="fm", **HOT)
    lines = []
    with Trainer(Config(**kw), device="cpu", log=lines.append) as first:
        first.train()
        remap = first.remap
    assert len([s for s in lines if s.startswith("hot remap: ")]) == 1
    lines.clear()
    with Trainer(Config(**kw), device="cpu", log=lines.append) as second:
        np.testing.assert_array_equal(second.remap, remap)
        assert second.hot_mass is None and not lines
    with pytest.raises(ValueError, match="trained with a hot table"):
        Trainer(Config(**dict(kw, hot_size_log2=0, hot_nnz=0)), device="cpu")
    np.save(tmp_path / "hot" / "remap.npy", remap[:100])
    with pytest.raises(ValueError, match="table_size_log2 changed"):
        Trainer(Config(**kw), device="cpu")
    cold = _kw(toy_dataset, tmp_path / "cold", model="fm")
    with _quiet(Config(**cold)) as t:
        t.train()
    with pytest.raises(ValueError, match="WITHOUT one"):
        Trainer(Config(**dict(cold, **HOT)), device="cpu", log=lambda _: None)


# -- (6) preemption --------------------------------------------------------


def _preempt_after(trainer, steps: int) -> None:
    """SIGTERM to this process as the trainer takes batch ``steps + 1``
    of its first epoch (the device half of its ``put_batch``: the
    staging ring reads batches ahead of the step): it finishes that
    step, checkpoints and stops."""
    inner = trainer.step.put_batch_device
    taken = []

    def wrapped(staged):
        if len(taken) == steps:
            # the trainer's handler, never the default (which kills)
            assert signal.getsignal(signal.SIGTERM) not in (signal.SIG_DFL, None)
            os.kill(os.getpid(), signal.SIGTERM)
        taken.append(1)
        return inner(staged)

    trainer.step.put_batch_device = wrapped


def test_sigterm_checkpoints_and_resume_finishes(toy_dataset, tmp_path):
    """SIGTERM after step 3: the 4th step (the end of shard 0) finishes,
    the checkpoint lands with a cursor at that offset, train() returns
    ``preempted`` and restores the previous handler; the resumed run
    finishes, and its tables equal a straight run's."""
    before = signal.getsignal(signal.SIGTERM)
    kw = _kw(toy_dataset, tmp_path / "ck", model="fm", epochs=2)
    trainer = _quiet(Config(**kw))
    _preempt_after(trainer, 3)
    history = trainer.train()
    trainer.close()
    assert signal.getsignal(signal.SIGTERM) is before
    assert len(history) == 1 and history[0]["preempted"] and history[0]["steps"] == 4
    assert history[0]["checkpoint_seconds"] > 0
    path = ckpt.latest_checkpoint(str(tmp_path / "ck"))
    with open(os.path.join(path, ckpt.MANIFEST)) as f:
        manifest = json.load(f)
    size = os.path.getsize(toy_dataset.train_prefix + "-00000")
    assert manifest["step"] == 4
    assert manifest["cursor"]["cursors"] == [{"shard": 0, "offset": size}]
    resumed = _quiet(Config(**kw))
    assert resumed.restore()["epoch"] == 0 and resumed._resume_cursor == (0, size)
    rest = resumed.train()
    assert [h["epoch"] for h in rest] == [0, 1] and not rest[-1]["preempted"]
    straight = _quiet(Config(**dict(kw, checkpoint_dir=str(tmp_path / "straight"))))
    full = straight.train()
    assert rest[0]["steps"] + 4 == full[0]["steps"]
    _assert_equal(_port_arrays(resumed), _port_arrays(straight))
    resumed.close()
    straight.close()


def test_periodic_checkpoints(toy_dataset, tmp_path):
    """checkpoint_every_steps=3 saves at steps 3, 6, ... and at the
    epoch end, each booked as checkpoint_seconds."""
    kw = _kw(toy_dataset, tmp_path, checkpoint_every_steps=3, checkpoint_keep=0)
    with _quiet(Config(**kw)) as t:
        history = t.train()
    steps = history[0]["steps"]
    names = sorted(d for d in os.listdir(tmp_path) if d.startswith("ckpt-"))
    want = sorted({f"ckpt-{s:010d}" for s in range(3, steps + 1, 3)} | {f"ckpt-{steps:010d}"})
    assert names == want and history[0]["checkpoint_seconds"] > 0


# -- (7) the CLI -----------------------------------------------------------


def test_cli_checkpoint_then_resume(toy_dataset, tmp_path):
    ck = str(tmp_path / "ck")
    argv = [sys.executable, "-m", "xflow_tpu_torch.train", "--model", "fm",
            "--train", toy_dataset.train_prefix, "--test", toy_dataset.test_prefix,
            "--batch-size", "64", "--table-size-log2", "12", "--max-nnz", "24",
            "--device", "cpu", "--checkpoint-dir", ck]
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    first = subprocess.run(argv + ["--epochs", "1"], capture_output=True, text=True,
                           timeout=120, env=env)
    assert first.returncode == 0, first.stderr
    assert os.path.exists(os.path.join(ck, "LATEST"))
    again = subprocess.run(argv + ["--epochs", "2", "--resume", "auto"], capture_output=True,
                           text=True, timeout=120, env=env)
    assert again.returncode == 0, again.stderr
    assert "resumed at {'epoch': 1" in again.stderr
    assert [s for s in again.stderr.splitlines() if s.startswith("logloss: ")
            and "\tauc = " in s]
    assert "epoch 1: logloss=" in again.stderr and "epoch 0:" not in again.stderr
