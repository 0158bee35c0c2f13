"""The pooled families (B11: wide_deep, dcn, two_tower) in the port: one
train step (K7, the head under autograd, K8, the table optimizer and
the dense SGD) against the JAX ``TrainStep`` on the CPU, on the same
numpy-seeded batches from the same state (tables and dense parameters
carried with convert.py), in every update mode: dense microbatch 1 and
4, sparse, sequential with the sparse and dense inners, and with the
hot table dense, the hybrid and the hot inner (both window ends);
FTRL and SGD; the compact, dictionary and full wires; the bf16 hot flag
on w and emb together.  The models, gradients, Trainer, artifacts and
CLI are tests/test_torch_dense_models.py's.

Tolerances: two steps' tables, dense parameters and log-losses rtol
1e-5 / atol 1e-6 (ROADMAP's parity bar: the sums run in another order);
bfloat16 tables atol 1e-4 (one bfloat16 step of a hot gradient,
tests/test_torch_hot_train.py's bar)."""

import numpy as np
import pytest
import torch

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.io import batch as ref_batch
from xflow_tpu.models import make_model as ref_make_model
from xflow_tpu.optim import make_optimizer as ref_make_optimizer
from xflow_tpu.parallel.mesh import make_mesh
from xflow_tpu.parallel.step import TrainStep as RefTrainStep
from xflow_tpu.parallel.step import init_state as ref_init_state
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import dense_to_numpy, state_from_numpy, state_to_numpy
from xflow_tpu_torch.io import batch as port_batch
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.optim import make_optimizer
from xflow_tpu_torch.parallel.step import TrainStep

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
T_LOG2, KC, KH, SF = 12, 8, 4, 6


def _raw(seed, b, kc, kh, h, full=False):
    """Seed-made [B, Kc + Kh] planes: zipf-like keys (rows carry more hot
    keys than Kh: the overflow spills), field ids (some past
    max_fields, negative ones on the full wire), masked holes, the last
    3 examples padding."""
    rng = np.random.default_rng(seed)
    ktot = kc + kh
    keys = rng.integers(0, 1 << T_LOG2, (b, ktot))
    if h:
        head = np.minimum(rng.zipf(1.3, (b, ktot)) - 1, 2 * h)
        keys = np.where(rng.random((b, ktot)) < 0.6, head, keys)
    keys = keys.astype(np.int32)
    slots = rng.integers(-2 if full else 0, SF, (b, ktot)).astype(np.int32)
    slots[rng.random((b, ktot)) < 0.05] = SF + 1
    mask = (rng.random((b, ktot)) < 0.85).astype(np.float32)
    vals = (rng.uniform(0.5, 1.5, (b, ktot)) if full else np.ones((b, ktot))).astype(np.float32)
    labels = (rng.random(b) < 0.4).astype(np.float32)
    weights = np.ones(b, np.float32)
    weights[-3:] = 0.0
    mask[-3:] = 0.0
    return keys, slots, vals, mask, labels, weights


def _left(raw):
    keys, slots, vals, mask, labels, weights = raw
    order = np.argsort(-mask, axis=1, kind="stable")
    keys, slots, mask = (np.take_along_axis(a, order, 1) for a in (keys, slots, mask))
    return (np.where(mask > 0, keys, 0).astype(np.int32), slots, mask.copy(), mask,
            labels, weights)


MODES = {
    "dense": {},
    "dense-mb4": dict(microbatch=4),
    "sparse": dict(update_mode="sparse"),
    "seq-sparse-mb4": dict(update_mode="sequential", microbatch=4, sequential_inner="sparse"),
    "seq-dense-mb4": dict(update_mode="sequential", microbatch=4),
    "hot-dense": dict(hot_size_log2=6),
    "hot-hybrid-mb4": dict(hot_size_log2=6, update_mode="sequential", microbatch=4,
                           sequential_inner="sparse"),
    "hot-inner-sparse-end": dict(hot_size_log2=6, update_mode="sequential", microbatch=4,
                                 sequential_inner="hot", hot_windowend="sparse"),
    "hot-inner-dense-end": dict(hot_size_log2=6, update_mode="sequential", microbatch=4,
                                sequential_inner="hot", hot_windowend="dense"),
}
FAMILY = {"wide_deep": {}, "dcn": dict(cross_layers=2),
          "two_tower": dict(tower_dim=3, tower_split_field=3)}


def _step_kw(model, optimizer, wire, **mode):
    h_log2 = mode.pop("hot_size_log2", 0)
    return dict(model=model, optimizer=optimizer, table_size_log2=T_LOG2, max_nnz=KC,
                hot_size_log2=h_log2, hot_nnz=KH if h_log2 else 0, batch_size=64,
                emb_dim=3, hidden_dim=5, max_fields=SF, num_devices=1, sgd_lr=0.05,
                hash_mode=wire != "full", wire_mode="full" if wire == "full" else "auto",
                wire_dedup="on" if wire == "dict" else "off", **FAMILY[model], **mode)


def _check_step_parity(kw, atol=ATOL, steps=2):
    """``steps`` steps from the reference's initial state (the second
    starts with n > 0 and moved dense parameters): tables, dense
    parameters and log-losses."""
    full = not kw["hash_mode"]
    h = (1 << kw["hot_size_log2"]) if kw["hot_size_log2"] else 0
    raws = [_raw(s, 64, KC, kw["hot_nnz"], h, full=full) for s in range(1, steps + 1)]
    if kw["wire_dedup"] == "on":
        raws = [_left(r) for r in raws]
    rcfg = RefConfig(**kw)
    mdl, opt = ref_make_model(rcfg), ref_make_optimizer(rcfg)
    rstep = RefTrainStep(mdl, opt, rcfg, make_mesh(1))
    state = ref_init_state(mdl, opt, rcfg, make_mesh(1))
    start = {n: {k: np.asarray(a).copy() for k, a in t.items()}
             for n, t in state["tables"].items()}
    start_dense = {k: np.asarray(a).copy() for k, a in state["dense"].items()}
    cfg = Config(**kw)
    step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    ours = state_from_numpy(cfg, start, "cpu", dense=start_dense)
    for raw in raws:
        state, m = rstep.train(state, rstep.put_batch(ref_batch.make_batch(*raw, h,
                                                                           kw["hot_nnz"])))
        got = step.train(ours, step.put_batch(port_batch.make_batch(*raw, h, kw["hot_nnz"])))
        assert float(got["count"]) == float(m["count"])
        np.testing.assert_allclose(float(got["logloss"]), float(m["logloss"]), rtol=RTOL,
                                   atol=ATOL)
    assert step.wire_format == rstep.wire_format
    back = state_to_numpy(ours, aux=True)
    for n, t in state["tables"].items():
        assert set(back[n]) == set(t)
        for k, a in t.items():
            np.testing.assert_allclose(back[n][k], np.asarray(a), rtol=RTOL, atol=atol,
                                       err_msg=f"{n}.{k}")
    dense = dense_to_numpy(ours)
    assert set(dense) == set(state["dense"]) and dense
    for k, a in state["dense"].items():
        np.testing.assert_allclose(dense[k], np.asarray(a), rtol=RTOL, atol=ATOL,
                                   err_msg=f"dense {k}")
    # the dense SGD moved the parameters
    assert any(not np.array_equal(dense[k], a) for k, a in start_dense.items())
    return step


@pytest.mark.parametrize("optimizer, wire", [("ftrl", "compact"), ("ftrl", "dict"),
                                             ("ftrl", "full"), ("sgd", "compact")])
@pytest.mark.parametrize("mode", list(MODES))
def test_wide_deep_step_matches_reference(mode, optimizer, wire):
    step = _check_step_parity(_step_kw("wide_deep", optimizer, wire, **MODES[mode]))
    assert step.pooled
    assert step.row_chunks == 1  # a pooled family takes the view whole
    assert step.window == mode.startswith("hot-inner")
