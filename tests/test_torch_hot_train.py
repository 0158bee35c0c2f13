"""Training with the hot table in the port, on the CPU, against the
reference (xflow_tpu):

* one JAX TrainStep and one port TrainStep step the same seed-made
  batches from the same state (carried with convert.py), and their
  tables (param and optimizer state) and log-losses match, in every
  update mode the reference allows with a hot table: dense (and dense
  microbatch), sequential with the dense inner, the sparse inner (the
  hybrid: K5's fold and K3 over the head rows) and the hot inner with
  ``hot_windowend`` dense and sparse (K2's window-start mode), and
  ``microbatch=1`` for each inner; LR and FM, FTRL on the compact (u16
  hot plane, H = 2^6) and dictionary (hot tiers, H = 2^8) wires and SGD
  on the compact wire (H = 2^8) (the cases of tests/test_sequential.py:208-505 and
  tests/test_hot_train.py:137); the full wire (int32 hot plane with
  values) and a forced ``hot_impl="mxu"`` with bfloat16 on a subset;
* ``TrainStep._sliced`` keeps a sequential batch's hot planes through
  the slice reorder;
* the Trainer end to end: the same remap and ``hot remap`` line as the
  JAX Trainer, eval AUC and log-loss within the bound below; and the
  hot model trains the same logical model as the cold one (the remap is
  a permutation) within the port.

Tolerances: tables rtol 1e-5 / atol 1e-6 and log-loss rtol 1e-5 /
atol 1e-6 (ROADMAP's parity bar; the sums run in another order);
under bfloat16 a per-occurrence rounding can land one bf16 step apart
when the float32 products before it differ in their last bit, so that
case is held at atol 1e-4 on the tables."""

import numpy as np
import pytest
import torch

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.io.batch import make_batch as ref_make_batch
from xflow_tpu.models import make_model as ref_make_model
from xflow_tpu.optim import make_optimizer as ref_make_optimizer
from xflow_tpu.parallel.mesh import make_mesh
from xflow_tpu.parallel.step import TrainStep as RefTrainStep
from xflow_tpu.parallel.step import init_state as ref_init_state
from xflow_tpu.trainer import Trainer as RefTrainer
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import state_from_numpy, state_to_numpy
from xflow_tpu_torch.io.batch import make_batch
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.ops.optim import optim_update
from xflow_tpu_torch.ops.sparse import consolidate_keys, touched_update
from xflow_tpu_torch.ops.train import train_step
from xflow_tpu_torch.optim import make_optimizer
from xflow_tpu_torch.parallel.step import TrainStep, uses_grad_buffer
from xflow_tpu_torch.trainer import Trainer

B, K, KH, T_LOG2, V_DIM = 64, 8, 4, 12, 4
RTOL, ATOL, LL_ATOL = 1e-5, 1e-6, 1e-6
CPU = torch.device("cpu")

MODES = {
    "dense": {},
    "dense-mb4": dict(microbatch=4),
    "seq-dense-mb4": dict(update_mode="sequential", microbatch=4),
    "seq-dense-mb1": dict(update_mode="sequential"),
    "seq-sparse-mb4": dict(update_mode="sequential", microbatch=4,
                           sequential_inner="sparse"),
    "seq-sparse-mb1": dict(update_mode="sequential", sequential_inner="sparse"),
    "seq-hot-dense-mb4": dict(update_mode="sequential", microbatch=4,
                              sequential_inner="hot", hot_windowend="dense"),
    "seq-hot-sparse-mb4": dict(update_mode="sequential", microbatch=4,
                               sequential_inner="hot", hot_windowend="sparse"),
    "seq-hot-mb1": dict(update_mode="sequential", sequential_inner="hot"),
}


def _cfg_kw(model, optimizer, wire, h_log2, **mode):
    return dict(model=model, optimizer=optimizer, table_size_log2=T_LOG2,
                max_nnz=K, hot_size_log2=h_log2, hot_nnz=KH, batch_size=B,
                v_dim=V_DIM, num_devices=1, sgd_lr=0.05, hash_mode=wire != "full",
                wire_mode="full" if wire == "full" else "auto",
                wire_dedup="on" if wire == "dict" else "off", **mode)


def _raw(seed, full, h):
    """Seed-made [B, K + KH] planes: zipf-like keys, so rows carry more
    hot keys than KH (overflow spills into the cold plane) and hot rows
    repeat across examples; masked holes; the last 3 examples padding;
    on the full wire values other than 1."""
    rng = np.random.default_rng(seed)
    ktot = K + KH
    keys = rng.integers(0, 1 << T_LOG2, (B, ktot))
    head = np.minimum(rng.zipf(1.3, (B, ktot)) - 1, 2 * h)
    keys = np.where(rng.random((B, ktot)) < 0.6, head, keys).astype(np.int32)
    mask = (rng.random((B, ktot)) < 0.85).astype(np.float32)
    vals = (rng.uniform(0.5, 1.5, (B, ktot)) if full else np.ones((B, ktot))).astype(np.float32)
    labels = (rng.random(B) < 0.4).astype(np.float32)
    weights = np.ones(B, np.float32)
    weights[-3:] = 0.0
    mask[-3:] = 0.0
    return keys, np.zeros_like(keys), vals, mask, labels, weights


def _ref_run(rcfg, raws):
    mdl, opt = ref_make_model(rcfg), ref_make_optimizer(rcfg)
    step = RefTrainStep(mdl, opt, rcfg, make_mesh(1))
    state = ref_init_state(mdl, opt, rcfg, make_mesh(1))
    start = {n: {k: np.asarray(a).copy() for k, a in t.items()}
             for n, t in state["tables"].items()}
    metrics = []
    h = rcfg.hot_size
    for raw in raws:
        batch = ref_make_batch(*raw, h, rcfg.hot_nnz)
        state, m = step.train(state, step.put_batch(batch))
        metrics.append((float(m["logloss"]), float(m["count"])))
    end = {n: {k: np.asarray(a) for k, a in t.items()} for n, t in state["tables"].items()}
    return start, end, metrics


def _port_run(cfg, start, raws):
    step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    state = state_from_numpy(cfg, start, "cpu")
    metrics = []
    for raw in raws:
        m = step.train(state, step.put_batch(make_batch(*raw, cfg.hot_size, cfg.hot_nnz)))
        metrics.append((float(m["logloss"]), float(m["count"])))
    return step, state, metrics


def _check_parity(kw, atol=ATOL):
    full = not kw["hash_mode"]
    h = 1 << kw["hot_size_log2"]
    raws = [_raw(1, full, h), _raw(2, full, h)]
    start, want, ref_metrics = _ref_run(RefConfig(**kw), raws)
    cfg = Config(**kw)
    step, state, metrics = _port_run(cfg, start, raws)
    got = state_to_numpy(state, aux=True)
    for name in want:
        assert set(got[name]) == set(want[name])
        for key in want[name]:
            np.testing.assert_allclose(got[name][key], want[name][key], rtol=RTOL,
                                       atol=atol, err_msg=f"{name}.{key}")
    for (ll, cnt), (rll, rcnt) in zip(metrics, ref_metrics):
        assert cnt == rcnt
        np.testing.assert_allclose(ll, rll, rtol=RTOL, atol=LL_ATOL)
    return step, state


@pytest.mark.parametrize("optimizer, wire, h_log2", [
    ("ftrl", "compact", 6), ("ftrl", "dict", 8),
    # SGD once: the wires decode the same planes whatever the optimizer
    ("sgd", "compact", 8),
])
@pytest.mark.parametrize("model", ["lr", "fm"])
@pytest.mark.parametrize("mode", list(MODES))
def test_hot_mode_matches_reference(mode, model, optimizer, wire, h_log2):
    """Two steps of the mode from the reference's initial state (the
    second starts with n > 0 and w != 0)."""
    step, state = _check_parity(_cfg_kw(model, optimizer, wire, h_log2, **MODES[mode]))
    assert step.wire_format == wire
    assert step.window == (mode.startswith("seq-hot") and mode.endswith("mb4"))
    # the sparse forms keep no [T, D] gradient buffer
    sparse = "seq-sparse" in mode or mode == "seq-hot-sparse-mb4"
    assert {"g" in t for t in state["tables"].values()} == {not sparse}
    assert uses_grad_buffer(step.cfg) == (not sparse)
    if "heads" in step._scratch:  # K3 leaves the head buffers zeroed
        assert not any(g.any() for g in step._scratch["heads"].values())


@pytest.mark.parametrize("model", ["lr", "fm"])
@pytest.mark.parametrize("mode", ["dense", "seq-sparse-mb4", "seq-hot-dense-mb4",
                                  "seq-hot-sparse-mb4"])
def test_hot_full_wire_matches_reference(mode, model):
    """The full wire: an int32 hot plane with its values."""
    step, _ = _check_parity(_cfg_kw(model, "ftrl", "full", 8, **MODES[mode]))
    assert step.wire_format == "full"


@pytest.mark.parametrize("model", ["lr", "fm"])
@pytest.mark.parametrize("mode", ["dense", "seq-sparse-mb4", "seq-hot-sparse-mb4"])
def test_hot_mxu_bf16_matches_reference(mode, model):
    """A forced ``hot_impl="mxu"`` with bfloat16: the hot rows and the
    hot gradients rounded to bfloat16, as the reference's one-hot
    matmuls round them."""
    kw = _cfg_kw(model, "ftrl", "compact", 6, hot_impl="mxu", hot_dtype="bfloat16",
                 **MODES[mode])
    step, _ = _check_parity(kw, atol=1e-4)
    assert step.hot_bf16 and step.predict_step.hot_bf16


def test_sliced_keeps_hot_planes():
    """A sequential hot batch keeps every hot occurrence through the
    slice reorder: slice j of the reordered planes holds rows j::s of
    the batch, hot planes included, and the decoded hot plane ships
    each of them."""
    cfg = Config(**_cfg_kw("fm", "ftrl", "dict", 6, **MODES["seq-hot-sparse-mb4"]))
    step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    batch = make_batch(*_raw(3, False, 64), cfg.hot_size, cfg.hot_nnz)
    assert batch.hot_mask.sum() > 0
    sliced = step._sliced(batch)
    order = step.slice_order(B)
    for name in ("hot_keys", "hot_slots", "hot_vals", "hot_mask", "keys", "mask"):
        np.testing.assert_array_equal(getattr(sliced, name), getattr(batch, name)[order],
                                      err_msg=name)
    arrays = step.put_batch(batch)
    rows = B // 4
    for j in range(4):
        got = arrays["hot"][j * rows:(j + 1) * rows].numpy()
        want = np.where(batch.hot_mask[j::4] > 0, batch.hot_keys[j::4], -1)
        np.testing.assert_array_equal(got, want)
    assert int((arrays["hot"] >= 0).sum()) == int(batch.hot_mask.sum())


def test_hot_modes_launch_nothing_on_cpu():
    """The CPU path runs the plain versions: no kernel launch is counted."""
    fns = (train_step, optim_update, consolidate_keys, touched_update)
    before = [f.launches for f in fns]
    _check_parity(_cfg_kw("fm", "ftrl", "compact", 6, **MODES["seq-hot-sparse-mb4"]))
    assert [f.launches for f in fns] == before


def test_hot_window_needs_hot_planes():
    cfg = Config(**_cfg_kw("lr", "ftrl", "compact", 6, **MODES["seq-hot-dense-mb4"]))
    step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    state = state_from_numpy(cfg, {"w": {"param": np.zeros((1 << T_LOG2, 1), np.float32),
                                         "n": np.zeros((1 << T_LOG2, 1), np.float32),
                                         "z": np.zeros((1 << T_LOG2, 1), np.float32)}}, "cpu")
    arrays = step.put_batch(make_batch(*_raw(4, False, 64)))
    with pytest.raises(ValueError, match="needs hot batch planes"):
        step.train(state, arrays)


# -- the Trainer end to end ------------------------------------------------


@pytest.fixture(scope="module")
def zipfy_dataset(tmp_path_factory):
    # tests/test_hot_train.py's: a wider vocab than the shared toy dataset
    from tests.gen_data import generate_dataset

    return generate_dataset(str(tmp_path_factory.mktemp("zipfy_torch")),
                            num_train_shards=2, lines_per_shard=300, num_fields=10,
                            vocab_per_field=64, seed=11, scale=3.0)


def _trainer_kw(ds, **kw):
    return dict(train_path=ds.train_prefix, test_path=ds.test_prefix, epochs=4,
                batch_size=64, table_size_log2=14, max_nnz=16, max_fields=12,
                num_devices=1, **kw)


HOT = dict(hot_size_log2=8, hot_nnz=8, freq_sample_mib=1)


@pytest.mark.parametrize("model, mode", [
    ("lr", {}),
    ("fm", {}),
    ("fm", dict(update_mode="sequential", microbatch=4, sequential_inner="hot")),
])
def test_trainer_hot_matches_jax_trainer(zipfy_dataset, model, mode):
    """The same remap and ``hot remap`` line as the JAX Trainer, and
    eval log-loss and AUC within 1e-4: four epochs of the same updates
    whose sums run in another order drift by float rounding, far below
    that."""
    kw = _trainer_kw(zipfy_dataset, model=model, **HOT, **mode)
    ref_lines, lines = [], []
    ref = RefTrainer(RefConfig(**kw))
    ref._log = ref_lines.append
    ref._init_remap()  # re-run, so its log line lands in ref_lines
    ref.train()
    want = ref.evaluate()
    ref.close()
    with Trainer(Config(**kw), device="cpu", log=lines.append) as ours:
        np.testing.assert_array_equal(ours.remap, ref.remap)
        ours.train()
        got = ours.evaluate()
    remap_line = [s for s in lines if s.startswith("hot remap: ")]
    assert remap_line == [s for s in ref_lines if s.startswith("hot remap: ")]
    assert len(remap_line) == 1 and "256 rows capture" in remap_line[0]
    assert got["examples"] == want["examples"]
    assert abs(got["auc"] - want["auc"]) < 1e-4
    assert abs(got["logloss"] - want["logloss"]) < 1e-4


def test_trainer_hot_equals_cold_model(zipfy_dataset, tmp_path):
    """tests/test_hot_train.py::test_hot_training_matches_dma_training
    in the port: the remap is a permutation of the rows, so the hot
    model's predictions equal the cold model's up to summation order
    (that test's bar: rtol 2e-3 / atol 2e-4, AUC within 1e-3); and
    prepare_batch brings an external batch into the hot key space."""
    preds = {}
    for name, extra in (("cold", {}), ("hot", HOT)):
        with Trainer(Config(**_trainer_kw(zipfy_dataset, model="fm", **extra)),
                     device="cpu", log=lambda _: None) as trainer:
            trainer.train()
            out = str(tmp_path / f"{name}.txt")
            preds[name] = (trainer.evaluate(pred_out=out), np.loadtxt(out, usecols=1))
            if name == "hot":
                raw = make_batch(*_raw(5, False, 256)[:6])
                prepared = trainer.prepare_batch(raw)
                assert prepared.hot_nnz == 8
                live = raw.mask > 0
                np.testing.assert_array_equal(
                    np.sort(np.concatenate([prepared.hot_keys[prepared.hot_mask > 0],
                                            prepared.keys[prepared.mask > 0]])),
                    np.sort(trainer.remap[raw.keys[live]]))
    np.testing.assert_allclose(preds["hot"][1], preds["cold"][1], rtol=2e-3, atol=2e-4)
    assert abs(preds["hot"][0]["auc"] - preds["cold"][0]["auc"]) < 1e-3


def test_trainer_hot_refusals(zipfy_dataset, tmp_path):
    """What stays refused with the hot table names its item: the
    remap's persistence in checkpoint_dir (A6), and hot training from
    packed shards (A6)."""
    kw = _trainer_kw(zipfy_dataset, model="lr", **HOT)
    with pytest.raises(NotImplementedError, match="A6"):
        Trainer(Config(**kw, checkpoint_dir=str(tmp_path / "ck")), device="cpu")
    from xflow_tpu_torch.io import packed

    pk = str(tmp_path / "train.pk")
    packed.convert_shard(zipfy_dataset.train_prefix + "-00000", pk, batch_size=64,
                         max_nnz=16, table_size=1 << 14, hash_mode=True, hash_seed=0)
    with pytest.raises(NotImplementedError, match="A6"):
        Trainer(Config(**{**kw, "train_path": pk}), device="cpu", log=lambda _: None)
    with pytest.raises(SystemExit):
        packed.main(["--train", zipfy_dataset.train_prefix, "--out", str(tmp_path / "p"),
                     "--batch-size", "64", "--max-nnz", "16", "--table-size-log2", "14",
                     "--hot-size-log2", "8"])
