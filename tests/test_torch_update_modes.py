"""The port's update modes on the CPU against the reference's: the
port's TrainStep (K2, K3, K4 and K5 through their plain versions)
against the JAX TrainStep from the same state (carried with
convert.py) on the same seed-made batches, at T=2^10, K=8, B=64,
v_dim 4, LR and FM, FTRL and SGD, both wires:

* update_mode="sparse";
* dense with microbatch 2 and 4;
* dense with cold_consolidate (microbatch 1 and 4);
* sequential, dense and sparse inner, microbatch 4 (and 1);
* a sequential batch whose slice 1 is all padding, which must leave
  the tables as the other slices alone do;

and, within the port, dense against sparse, microbatch against the
whole batch, and cold_consolidate against the plain scatter over
Trainer runs (tests/test_update_modes.py's properties); the dense
microbatch and cold_consolidate forms run the plain dense step.  Tolerances
are the reference's own: tables rtol 1e-5 / atol 1e-7, log-loss rtol
1e-5 / atol 1e-6 (tests/test_update_modes.py:43-56,
tests/test_sequential.py:102-114)."""

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
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import state_from_numpy, state_to_numpy
from xflow_tpu_torch.io.batch import make_batch
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.ops.sparse import consolidate_keys, touched_update
from xflow_tpu_torch.optim import make_optimizer
from xflow_tpu_torch.parallel.step import TrainStep, init_state
from xflow_tpu_torch.trainer import Trainer

B, K, T_LOG2, V_DIM = 64, 8, 10, 4
RTOL, ATOL, LL_ATOL = 1e-5, 1e-7, 1e-6

MODES = {
    "sparse": dict(update_mode="sparse"),
    "dense-mb2": dict(microbatch=2),
    "dense-mb4": dict(microbatch=4),
    "cold-consolidate": dict(cold_consolidate=True),
    "cold-consolidate-mb4": dict(cold_consolidate=True, microbatch=4),
    "seq-dense-mb4": dict(update_mode="sequential", microbatch=4),
    "seq-sparse-mb4": dict(update_mode="sequential", microbatch=4,
                           sequential_inner="sparse"),
    "seq-sparse-mb1": dict(update_mode="sequential", sequential_inner="sparse"),
}


def _cfg_kw(model, optimizer, full, **mode):
    return dict(model=model, optimizer=optimizer, table_size_log2=T_LOG2,
                max_nnz=K, batch_size=B, v_dim=V_DIM, num_devices=1,
                hash_mode=not full, wire_mode="full" if full else "auto",
                sgd_lr=0.05, **mode)


def _raw(seed, full, pad_slice=None):
    """Seed-made planes: keys with repeats (a hot key in a quarter of
    the rows), masked holes, the last 3 examples padding (weight 0); on
    the full wire values other than 1.  ``pad_slice`` makes that
    interleaved slice of 4 all padding."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << T_LOG2, (B, K)).astype(np.int32)
    keys[rng.random(B) < 0.25, 0] = 5
    vals = (rng.uniform(0.5, 1.5, (B, K)) if full else np.ones((B, K))).astype(np.float32)
    mask = (rng.random((B, K)) < 0.8).astype(np.float32)
    labels = (rng.random(B) < 0.4).astype(np.float32)
    weights = np.ones(B, np.float32)
    weights[-3:] = 0.0
    mask[-3:] = 0.0
    if pad_slice is not None:
        weights[pad_slice::4] = 0.0
        mask[pad_slice::4] = 0.0
    return keys, np.zeros_like(keys), vals, mask, labels, weights


def _ref_run(rcfg, raws):
    mdl, opt = ref_make_model(rcfg), ref_make_optimizer(rcfg)
    step = RefTrainStep(mdl, opt, rcfg, make_mesh(1))
    state = ref_init_state(mdl, opt, rcfg, make_mesh(1))
    # the reference's FM v init is random; start the port from the same
    start = {n: {k: np.asarray(a).copy() for k, a in t.items()}
             for n, t in state["tables"].items()}
    metrics = []
    for raw in raws:
        state, m = step.train(state, step.put_batch(ref_make_batch(*raw)))
        metrics.append((float(m["logloss"]), float(m["count"])))
    end = {n: {k: np.asarray(a) for k, a in t.items()} for n, t in state["tables"].items()}
    return start, end, metrics


def _port_run(cfg, start, raws):
    step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, torch.device("cpu"))
    state = state_from_numpy(cfg, start, "cpu")
    metrics = []
    for raw in raws:
        m = step.train(state, step.put_batch(make_batch(*raw)))
        metrics.append((float(m["logloss"]), float(m["count"])))
    return step, state, metrics


def _assert_tables(got_state, want, what=""):
    got = state_to_numpy(got_state, aux=True)
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name])
        for key in want[name]:
            np.testing.assert_allclose(got[name][key], want[name][key], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{what} {name}.{key}")


@pytest.mark.parametrize("full", [False, True], ids=["compact", "full"])
@pytest.mark.parametrize("optimizer", ["ftrl", "sgd"])
@pytest.mark.parametrize("model", ["lr", "fm"])
@pytest.mark.parametrize("mode", list(MODES))
def test_mode_matches_reference(mode, model, optimizer, full):
    """Two steps of the mode from the reference's initial state (the
    second starts with n > 0 and w != 0)."""
    kw = _cfg_kw(model, optimizer, full, **MODES[mode])
    raws = [_raw(1, full), _raw(2, full)]
    start, want, ref_metrics = _ref_run(RefConfig(**kw), raws)
    cfg = Config(**kw)
    step, state, metrics = _port_run(cfg, start, raws)
    _assert_tables(state, want, mode)
    for (ll, cnt), (rll, rcnt) in zip(metrics, ref_metrics):
        assert cnt == rcnt
        np.testing.assert_allclose(ll, rll, rtol=RTOL, atol=LL_ATOL)
    # the sparse update keeps no [T, D] gradient buffer
    has_g = {"g" in t for t in state["tables"].values()}
    assert has_g == {not step.sparse}
    assert step.sparse == (mode.startswith("sparse") or "seq-sparse" in mode)


@pytest.mark.parametrize("inner", ["dense", "sparse"])
@pytest.mark.parametrize("model", ["lr", "fm"])
def test_sequential_all_padding_slice_is_noop(model, inner):
    """tests/test_sequential.py::test_sequential_empty_slice_is_noop: a
    slice of all-padding examples leaves the carried tables as the
    other slices alone leave them, in the port as in the reference."""
    kw = _cfg_kw(model, "ftrl", False, update_mode="sequential", microbatch=4,
                 sequential_inner=inner)
    raw = _raw(3, False, pad_slice=1)
    start, want, ref_metrics = _ref_run(RefConfig(**kw), [raw])
    cfg = Config(**kw)
    _, state, metrics = _port_run(cfg, start, [raw])
    _assert_tables(state, want, "vs reference")
    assert metrics[0][1] == ref_metrics[0][1]
    np.testing.assert_allclose(metrics[0][0], ref_metrics[0][0], rtol=RTOL, atol=LL_ATOL)
    # the same three live slices as dense steps of B/4 examples
    dcfg = Config(**{**kw, "update_mode": "dense", "microbatch": 1, "batch_size": B // 4})
    dense = [tuple(a[j::4] for a in raw) for j in (0, 2, 3)]
    _, dstate, _ = _port_run(dcfg, start, dense)
    _assert_tables(state, state_to_numpy(dstate, aux=True), "vs dense sequence")


@pytest.mark.parametrize("model", ["lr", "fm"])
def test_all_padding_batch_touches_nothing(model):
    """A sparse step over an all-padding batch (K4 finds no key) leaves
    every table bit-identical and counts nothing."""
    kw = _cfg_kw(model, "ftrl", False, update_mode="sparse")
    cfg = Config(**kw)
    step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, torch.device("cpu"))
    state = init_state(step.model, step.optimizer, cfg, torch.device("cpu"))
    step.train(state, step.put_batch(make_batch(*_raw(4, False))))
    before = state_to_numpy(state, aux=True)
    keys, slots, vals, mask, labels, weights = _raw(5, False)
    m = step.train(state, step.put_batch(make_batch(
        keys, slots, vals, np.zeros_like(mask), labels, np.zeros_like(weights))))
    assert float(m["count"]) == 0.0 and float(m["logloss"]) == 0.0
    after = state_to_numpy(state, aux=True)
    for name in before:
        for key in before[name]:
            assert np.array_equal(after[name][key], before[name][key]), (name, key)


def test_consolidation_buffers_are_reused_and_left_clean():
    """The per-slice buffers are allocated once at the slice's size and
    left zeroed by K5's plain version, step after step."""
    kw = _cfg_kw("fm", "ftrl", False, update_mode="sequential", microbatch=4,
                 sequential_inner="sparse")
    cfg = Config(**kw)
    step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, torch.device("cpu"))
    state = init_state(step.model, step.optimizer, cfg, torch.device("cpu"))
    step.train(state, step.put_batch(make_batch(*_raw(6, False))))
    gsum = step._scratch["gsum"]
    assert step._scratch["cap"] == (B // 4) * K
    assert {tuple(g.shape) for g in gsum.values()} == {((B // 4) * K, 1), ((B // 4) * K, V_DIM)}
    assert step._scratch["slot_map"] is None  # the plain versions need no map
    step.train(state, step.put_batch(make_batch(*_raw(7, False))))
    assert step._scratch["gsum"] is gsum
    assert not any(g.any() for g in gsum.values())


def test_put_batch_reorders_slices_and_counts_each():
    kw = _cfg_kw("lr", "ftrl", False, update_mode="sequential", microbatch=4)
    cfg = Config(**kw)
    step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, torch.device("cpu"))
    raw = _raw(8, False, pad_slice=2)
    arrays = step.put_batch(make_batch(*raw))
    keys, weights = raw[0], raw[5]
    rows = B // 4
    for j in range(4):
        got = arrays["ckeys"][j * rows:(j + 1) * rows].numpy()
        want = np.where(raw[3][j::4] > 0, keys[j::4], -1)
        np.testing.assert_array_equal(got, want)
        assert arrays["slice_num_real"][j] == max(float(weights[j::4].sum()), 1.0)
    assert arrays["slice_num_real"][2] == 1.0
    assert arrays["num_real"] == float(weights.sum())
    with pytest.raises(ValueError, match="divide"):
        step.put_batch(make_batch(*(a[:B - 2] for a in raw)))


def _trainer_state(toy_dataset, **kw):
    # tests/test_update_modes.py::cfg_for
    cfg = Config(train_path=toy_dataset.train_prefix, test_path=toy_dataset.test_prefix,
                 epochs=2, batch_size=64, table_size_log2=14, max_nnz=24,
                 max_fields=12, num_devices=1, **kw)
    with Trainer(cfg, device="cpu", log=lambda _: None) as trainer:
        trainer.train()
        return state_to_numpy(trainer.state, aux=True)


@pytest.mark.parametrize("model, optimizer, other", [
    ("lr", "ftrl", dict(update_mode="sparse")),
    ("fm", "ftrl", dict(update_mode="sparse")),
    ("lr", "sgd", dict(update_mode="sparse")),
    ("fm", "ftrl", dict(microbatch=4)),
    ("fm", "ftrl", dict(cold_consolidate=True)),
    ("lr", "ftrl", dict(cold_consolidate=True, microbatch=4)),
])
def test_port_mode_equals_dense(toy_dataset, model, optimizer, other):
    """Within the port (tests/test_update_modes.py): dense equals
    sparse, microbatch equals the whole batch, cold_consolidate equals
    the plain scatter — same training, other execution."""
    want = _trainer_state(toy_dataset, model=model, optimizer=optimizer)
    got = _trainer_state(toy_dataset, model=model, optimizer=optimizer, **other)
    for name in want:
        for key in want[name]:
            np.testing.assert_allclose(got[name][key], want[name][key], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{other} {name}.{key}")


@pytest.mark.parametrize("model", ["lr", "fm"])
@pytest.mark.parametrize("mode", ["dense-mb2", "dense-mb4", "cold-consolidate",
                                  "cold-consolidate-mb4"])
def test_dense_forms_run_the_plain_dense_step(mode, model):
    """Dense microbatch and cold_consolidate compute the plain dense
    update (the reference's slicing and merging bound its [B, K, D]
    intermediates on a TPU; K2 builds none), so the port runs that step
    for them: the batch ships unreordered, no consolidation buffer is
    made, and the tables and log-loss equal the plain dense step's
    bit for bit."""
    raws = [_raw(10, False), _raw(11, False)]
    start, _, _ = _ref_run(RefConfig(**_cfg_kw(model, "ftrl", False)), [])
    want_step, want, want_metrics = _port_run(Config(**_cfg_kw(model, "ftrl", False)),
                                              start, raws)
    cfg = Config(**_cfg_kw(model, "ftrl", False, **MODES[mode]))
    step, got, metrics = _port_run(cfg, start, raws)
    assert step.slices == 1 and not step.sparse and step._scratch == {}
    arrays = step.put_batch(make_batch(*raws[0]))
    assert "slice_num_real" not in arrays
    np.testing.assert_array_equal(arrays["ckeys"].numpy(),
                                  want_step.put_batch(make_batch(*raws[0]))["ckeys"].numpy())
    assert metrics == want_metrics
    for name, table in want["tables"].items():
        for key, a in table.items():
            assert torch.equal(got["tables"][name][key], a), (mode, name, key)


def test_launch_counts_on_cpu_are_zero():
    """The CPU path runs the plain versions: no kernel launch is counted."""
    before = (consolidate_keys.launches, touched_update.launches)
    kw = _cfg_kw("fm", "ftrl", False, update_mode="sparse")
    start, _, _ = _ref_run(RefConfig(**kw), [])
    _port_run(Config(**kw), start, [_raw(9, False)])
    assert (consolidate_keys.launches, touched_update.launches) == before
