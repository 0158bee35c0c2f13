"""MVM (B9) and the field-id planes it reads (B4s) in the port, and FM
past 32 factors (C1), on the CPU, against the reference (xflow_tpu):

* ``mvm_slot_terms`` and ``MVMModel.logit`` / ``grad_logit`` against
  the JAX functions: empty fields, fields out of range (past
  ``max_fields`` and negative), an own-field factor exactly 0 (the
  guard); the frozen oracle of tests/test_models.py:103-124; the
  explicit gradient against torch.autograd of the port's forward;
* K6's plain field streams against ``_expand_dict_wire``, exactly;
* K1's plain MVM form against the JAX ``PredictStep`` on the compact,
  full and dictionary wires, with and without the hot plane;
* one plain K2 step against the JAX ``TrainStep`` in every update mode,
  FTRL and SGD, on the compact, dictionary and full wires, as
  tests/test_torch_hot_train.py does for FM;
* the Trainer against the JAX Trainer on ``toy_dataset``, the MVM
  learning test of tests/test_train.py:47, artifacts both ways, and the
  CLI's ``--model mvm`` / ``--model 2``;
* C1: FM at ``v_dim=64`` for one step and for serving, against JAX.

Tolerances: rtol 1e-5 / atol 1e-6 where v is at its init scale (1e-2)
or the step's own tables (ROADMAP's parity bar: sums and products run
in another order); rtol 1e-4 / atol 1e-5, the reference's own bar
(tests/test_models.py:89-124), where v ~ N(0, 0.5), since S factors of
1 + slotsum multiply their rounding; integer planes exactly; pctr atol
1e-6 (tests/test_serve.py's bar)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.io import batch as ref_batch
from xflow_tpu.io import compact as ref_compact
from xflow_tpu.models import blocks as ref_blocks
from xflow_tpu.models import make_model as ref_make_model
from xflow_tpu.models.mvm import MVMModel as RefMVM
from xflow_tpu.optim import make_optimizer as ref_make_optimizer
from xflow_tpu.parallel.mesh import make_mesh
from xflow_tpu.parallel.step import TrainStep as RefTrainStep
from xflow_tpu.parallel.step import init_state as ref_init_state
from xflow_tpu.serve.artifact import export_artifact as ref_export_artifact
from xflow_tpu.serve.engine import PredictEngine as RefEngine
from xflow_tpu.trainer import Trainer as RefTrainer
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import state_from_numpy, state_to_numpy
from xflow_tpu_torch.io import batch as port_batch
from xflow_tpu_torch.models import MVMModel, make_model
from xflow_tpu_torch.models.blocks import mvm_slot_terms
from xflow_tpu_torch.ops.score import MVM_MAX_SLOTS, mvm_stage_global, score
from xflow_tpu_torch.ops.train import train_step
from xflow_tpu_torch.ops.wire import dict_decode, to_device
from xflow_tpu_torch.optim import make_optimizer
from xflow_tpu_torch.parallel.step import TrainStep, check_servable, compact_wire_np
from xflow_tpu_torch.serve.artifact import export_artifact, write_artifact
from xflow_tpu_torch.serve.engine import PredictEngine
from xflow_tpu_torch.train import main as cli_main
from xflow_tpu_torch.trainer import Trainer

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6  # init-scale v, one step
REF_RTOL, REF_ATOL = 1e-4, 1e-5  # v ~ N(0, 0.5): tests/test_models.py's bar
PCTR_ATOL = 1e-6
B, K, D, S = 16, 12, 4, 6


# -- the model ---------------------------------------------------------------


def _model_batch(seed, values=True):
    """[B, K] planes with padding, empty fields (slots drawn from a few
    of S), slots past max_fields and negative ones."""
    rng = np.random.default_rng(seed)
    slots = rng.choice([0, 2, 3, 5], size=(B, K)).astype(np.int32)
    slots[rng.random((B, K)) < 0.1] = S + 2
    slots[rng.random((B, K)) < 0.1] = -1
    mask = (rng.random((B, K)) < 0.8).astype(np.float32)
    vals = (rng.uniform(0.5, 1.5, (B, K)) if values else np.ones((B, K))).astype(np.float32)
    return {"keys": np.zeros((B, K), np.int32), "slots": slots, "vals": vals, "mask": mask}


@pytest.mark.parametrize("scale, rtol, atol", [(1e-2, RTOL, ATOL),
                                               (0.5, REF_RTOL, REF_ATOL)])
def test_mvm_model_matches_reference(scale, rtol, atol):
    batch = _model_batch(1)
    v = (np.random.default_rng(2).normal(0, scale, (B, K, D))).astype(np.float32)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    tb = {k: torch.tensor(a) for k, a in batch.items()}
    ref, ours = RefMVM(v_dim=D, max_fields=S), MVMModel(v_dim=D, max_fields=S)
    x = batch["vals"] * batch["mask"]
    want = ref_blocks.mvm_slot_terms(jnp.asarray(v), jnp.asarray(x), jb["slots"], S)
    got = mvm_slot_terms(torch.tensor(v), torch.tensor(x), tb["slots"], S)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol)
    np.testing.assert_allclose(ours.logit({"v": torch.tensor(v)}, tb).numpy(),
                               np.asarray(ref.logit({"v": jnp.asarray(v)}, jb)),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(ours.grad_logit({"v": torch.tensor(v)}, tb)["v"].numpy(),
                               np.asarray(ref.grad_logit({"v": jnp.asarray(v)}, jb)["v"]),
                               rtol=rtol, atol=atol)
    # fields 1 and 4 are empty: their factor is exactly 1
    assert bool((got[0][:, [1, 4]] == 1.0).all())


def test_mvm_guard_and_dropped_slots_match_reference():
    """An own-field factor exactly 0 (one slot of field 0 with v * x =
    -1): the guard zeroes its gradient and prod is 0, on both sides;
    slots outside [0, max_fields) (negative ones included) get no
    gradient and add nothing to the logit."""
    batch = _model_batch(3, values=False)
    rng = np.random.default_rng(4)
    v = rng.normal(0, 0.1, (B, K, D)).astype(np.float32)
    batch["slots"][:, 0] = 0
    batch["slots"][:, 1:][batch["slots"][:, 1:] == 0] = 2
    batch["mask"][:, 0] = 1.0
    v[:, 0, 1] = -1.0
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    tb = {k: torch.tensor(a) for k, a in batch.items()}
    ref, ours = RefMVM(v_dim=D, max_fields=S), MVMModel(v_dim=D, max_fields=S)
    got = ours.grad_logit({"v": torch.tensor(v)}, tb)["v"].numpy()
    want = np.asarray(ref.grad_logit({"v": jnp.asarray(v)}, jb)["v"])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[:, 0, 1] == 0).all() and (want[:, 0, 1] == 0).all()
    dropped = (batch["slots"] < 0) | (batch["slots"] >= S)
    assert dropped.any() and (got[dropped] == 0).all()
    np.testing.assert_allclose(ours.logit({"v": torch.tensor(v)}, tb).numpy(),
                               np.asarray(ref.logit({"v": jnp.asarray(v)}, jb)),
                               rtol=RTOL, atol=ATOL)
    # all slots out of range: logit 0, no gradient (tests/test_models.py:127)
    tb["slots"] = torch.full((B, K), 5, dtype=torch.int32)
    two = MVMModel(v_dim=D, max_fields=2)
    assert bool((two.logit({"v": torch.tensor(v)}, tb) == 0).all())
    assert not two.grad_logit({"v": torch.tensor(v)}, tb)["v"].any()


def test_mvm_forward_oracle():
    """tests/test_models.py:103-124's frozen oracle, on the port."""
    bs, ks, ds, ss = 4, 6, 3, 3
    rng = np.random.default_rng(8)
    slots = rng.integers(0, ss, (bs, ks)).astype(np.int32)
    x = (rng.uniform(0.5, 1.5, (bs, ks)) * (rng.random((bs, ks)) < 0.8)).astype(np.float32)
    v = rng.normal(0, 0.5, (bs, ks, ds)).astype(np.float32)
    batch = {"slots": torch.tensor(slots), "vals": torch.tensor(x),
             "mask": torch.ones((bs, ks))}
    got = MVMModel(v_dim=ds, max_fields=ss).logit({"v": torch.tensor(v)}, batch).numpy()
    want = np.zeros(bs)
    for b in range(bs):
        total = 0.0
        for d in range(ds):
            prod = 1.0
            for s in range(ss):
                prod *= 1.0 + sum(v[b, k, d] * x[b, k] for k in range(ks) if slots[b, k] == s)
            total += prod - 1.0  # the centred form
        want[b] = total
    np.testing.assert_allclose(got, want, rtol=REF_RTOL)


def test_mvm_gradient_equals_autograd():
    """MVM's explicit gradient is the true gradient of its forward (the
    consistent 1 + sum form), wherever the guard does not fire."""
    batch = {k: torch.tensor(a) for k, a in _model_batch(5).items()}
    v = torch.tensor(np.random.default_rng(6).normal(0, 0.5, (B, K, D)).astype(np.float32),
                     requires_grad=True)
    model = MVMModel(v_dim=D, max_fields=S)
    (auto,) = torch.autograd.grad(model.logit({"v": v}, batch).sum(), v)
    explicit = model.grad_logit({"v": v.detach()}, batch)["v"]
    np.testing.assert_allclose(explicit.numpy(), auto.numpy(), rtol=REF_RTOL, atol=REF_ATOL)


def test_registry_builds_mvm():
    cfg = Config(model="mvm", v_dim=7, max_fields=21, v_init_scale=0.03)
    model = make_model(cfg)
    assert isinstance(model, MVMModel) and model.uses_slots
    assert (model.v_dim, model.max_fields, model.v_init_scale) == (7, 21, 0.03)
    assert [t.name for t in model.tables()] == ["v"]
    assert model.tables()[0].dim == 7


# -- the wires --------------------------------------------------------------


def _zipf_raw(seed, b, kc, kh, t_log2, h, full=False, slot_lo=0, slot_hi=S):
    """Seed-made [B, Kc + Kh] planes: zipf-like keys (rows carry more
    hot keys than Kh: the overflow spills), field ids (some out of
    range), masked holes, the last 3 examples padding."""
    rng = np.random.default_rng(seed)
    ktot = kc + kh
    keys = rng.integers(0, 1 << t_log2, (b, ktot))
    if h:
        head = np.minimum(rng.zipf(1.3, (b, ktot)) - 1, 2 * h)
        keys = np.where(rng.random((b, ktot)) < 0.6, head, keys)
    keys = keys.astype(np.int32)
    slots = rng.integers(slot_lo, slot_hi, (b, ktot)).astype(np.int32)
    slots[rng.random((b, ktot)) < 0.05] = S + 1
    mask = (rng.random((b, ktot)) < 0.85).astype(np.float32)
    vals = (rng.uniform(0.5, 1.5, (b, ktot)) if full else np.ones((b, ktot))).astype(np.float32)
    labels = (rng.random(b) < 0.4).astype(np.float32)
    weights = np.ones(b, np.float32)
    weights[-3:] = 0.0
    mask[-3:] = 0.0
    return keys, slots, vals, mask, labels, weights


FIELD_CASES = {
    # (Kc, Kh, table_size_log2, hot_size_log2, slot range)
    "cold": (12, 0, 14, 0, (0, S)),
    "hot-u12": (12, 6, 14, 12, (0, S)),
    "hot-u16": (12, 6, 16, 14, (0, S)),
    "overflow": (12, 2, 14, 12, (0, S)),
    "out-of-range": (12, 6, 14, 12, (-30, 300)),
}


@pytest.mark.parametrize("case", list(FIELD_CASES))
def test_k6_field_streams_equal_reference_expand(case):
    """K6's plain field streams (``cw_cs``, ``cw_hs``) decode exactly as
    the reference's ``_expand_dict_wire`` (its ``flat_slots``), 0 on
    padding; and the u8 plane's values are the batch's field ids under
    the clamp (outside [0, 255] → 255)."""
    kc, kh, t_log2, h_log2, (lo, hi) = FIELD_CASES[case]
    b, h = 61, (1 << h_log2) if h_log2 else 0
    keys, slots, vals, mask, labels, weights = _zipf_raw(7, b, kc, kh, t_log2, h,
                                                         slot_lo=lo, slot_hi=hi)
    # left-compacted rows, as loader batches are
    order = np.argsort(-mask, axis=1, kind="stable")
    raw = tuple(np.take_along_axis(a, order, 1) for a in (keys, slots, vals, mask))
    raw = (np.where(raw[3] > 0, raw[0], 0).astype(np.int32), raw[1], raw[3].copy(),
           raw[3], labels * weights, weights)
    batch = ref_batch.make_batch(*raw, h, kh)
    wire = ref_compact.compact_batch(batch, 1 << t_log2, h).wire(True)
    step = RefTrainStep(*(lambda c: (ref_make_model(c), ref_make_optimizer(c), c))(
        RefConfig(model="mvm", batch_size=b, max_nnz=kc, hot_size_log2=h_log2, hot_nnz=kh,
                  table_size_log2=t_log2, num_devices=1, wire_dedup="on", max_fields=S)),
        make_mesh(1))
    want = step._expand_dict_wire({n: jnp.asarray(a) for n, a in wire.items()})
    planes = dict_decode(to_device(wire, CPU), kc, kh)
    assert len(planes) == 3 + bool(kh) + 1 + bool(kh)
    fields = planes[-1 - bool(kh)]
    assert fields.dtype == torch.uint8 and fields.shape == (b, kc)
    np.testing.assert_array_equal(fields.numpy(), np.asarray(want["slots"]))
    clamp = np.where((batch.slots < 0) | (batch.slots > 255), 255, batch.slots)
    np.testing.assert_array_equal(fields.numpy(), np.where(batch.mask > 0, clamp, 0))
    if kh:
        np.testing.assert_array_equal(planes[-1].numpy(), np.asarray(want["hot_slots"]))
    # a wire without the streams decodes as before
    bare = ref_compact.compact_batch(batch, 1 << t_log2, h).wire(False)
    assert len(dict_decode(to_device(bare, CPU), kc, kh)) == 3 + bool(kh)


K1_WIRES = {
    # (wire_mode, wire_dedup, hot_size_log2)
    "compact": ("auto", "off", 0),
    "compact-hot": ("auto", "off", 8),
    "full": ("full", "off", 0),
    "full-hot": ("full", "off", 8),
    "dict": ("auto", "on", 0),
    "dict-hot": ("auto", "on", 8),
}


def _ref_tables(rcfg, scale=0.1, seed=5):
    mdl, opt = ref_make_model(rcfg), ref_make_optimizer(rcfg)
    state = ref_init_state(mdl, opt, rcfg, make_mesh(1))
    rng = np.random.default_rng(seed)
    return {n: {k: (np.asarray(a) + rng.normal(0, scale, np.asarray(a).shape)).astype(np.float32)
                for k, a in t.items()} for n, t in state["tables"].items()}


@pytest.mark.parametrize("case", list(K1_WIRES))
def test_k1_mvm_matches_reference_predict(case):
    wire_mode, dedup, h_log2 = K1_WIRES[case]
    full = wire_mode == "full"
    kw = dict(model="mvm", table_size_log2=12, hot_size_log2=h_log2, hot_nnz=4 if h_log2 else 0,
              max_nnz=8, batch_size=48, v_dim=D, max_fields=S, num_devices=1,
              wire_mode=wire_mode, wire_dedup=dedup, hash_mode=not full)
    rcfg = RefConfig(**kw)
    ref_step = RefTrainStep(ref_make_model(rcfg), ref_make_optimizer(rcfg), rcfg, make_mesh(1))
    tables = _ref_tables(rcfg)
    ref_state = {"tables": {n: {k: jnp.asarray(a) for k, a in t.items()}
                            for n, t in tables.items()}, "dense": {}}
    kh = kw["hot_nnz"]
    h = (1 << h_log2) if h_log2 else 0
    raw = list(_zipf_raw(6, 48, 8, kh, 12, h, full=full,
                         slot_lo=-2 if full else 0))
    if dedup == "on":  # left-compacted rows for the dictionary wire
        order = np.argsort(-raw[3], axis=1, kind="stable")
        for i in range(4):
            raw[i] = np.take_along_axis(raw[i], order, 1)
        raw[0] = np.where(raw[3] > 0, raw[0], 0).astype(np.int32)
        raw[2] = raw[3].copy()
    batch = ref_batch.make_batch(*raw, h, kh)
    want = np.asarray(ref_step.predict(ref_state, ref_step.put_batch(batch, predict=True)))
    cfg = Config(**kw)
    step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    assert step.wire_format == ref_step.wire_format
    state = state_from_numpy(cfg, tables, "cpu")
    arrays = step.put_batch(port_batch.make_batch(*raw, h, kh), predict=True)
    assert arrays["fields"].dtype == (torch.int32 if full else torch.uint8)
    assert ("hot_fields" in arrays) == bool(h_log2)
    got = step.predict(state, arrays).numpy()
    np.testing.assert_allclose(got, want, atol=PCTR_ATOL)


# -- one train step against the JAX TrainStep ---------------------------------

T_LOG2, KC, KH = 12, 8, 4
MODES = {
    "dense": {},
    "dense-mb4": dict(microbatch=4),
    "consolidate": dict(cold_consolidate=True),
    "seq-dense-mb4": dict(update_mode="sequential", microbatch=4),
    "seq-sparse-mb4": dict(update_mode="sequential", microbatch=4, sequential_inner="sparse"),
    "seq-sparse-mb1": dict(update_mode="sequential", sequential_inner="sparse"),
    "seq-hot-dense-mb4": dict(update_mode="sequential", microbatch=4, sequential_inner="hot",
                              hot_windowend="dense"),
    "seq-hot-sparse-mb4": dict(update_mode="sequential", microbatch=4,
                               sequential_inner="hot", hot_windowend="sparse"),
    "seq-hot-mb1": dict(update_mode="sequential", sequential_inner="hot"),
}
NOHOT_MODES = ("dense", "dense-mb4", "consolidate", "seq-dense-mb4", "seq-sparse-mb4")


def _step_kw(optimizer, wire, h_log2, **mode):
    return dict(model="mvm", optimizer=optimizer, table_size_log2=T_LOG2, max_nnz=KC,
                hot_size_log2=h_log2, hot_nnz=KH if h_log2 else 0, batch_size=64, v_dim=D,
                max_fields=S, num_devices=1, sgd_lr=0.05, hash_mode=wire != "full",
                wire_mode="full" if wire == "full" else "auto",
                wire_dedup="on" if wire == "dict" else "off", **mode)


def _check_step_parity(kw):
    """Two steps from the reference's initial state (the second starts
    with n > 0): tables and log-losses."""
    full = not kw["hash_mode"]
    h = (1 << kw["hot_size_log2"]) if kw["hot_size_log2"] else 0
    raws = [_zipf_raw(s, 64, KC, kw["hot_nnz"], T_LOG2, h, full=full,
                      slot_lo=-2 if full else 0) for s in (1, 2)]
    if kw["wire_dedup"] == "on":
        raws = [_left(r) for r in raws]
    rcfg = RefConfig(**kw)
    mdl, opt = ref_make_model(rcfg), ref_make_optimizer(rcfg)
    rstep = RefTrainStep(mdl, opt, rcfg, make_mesh(1))
    state = ref_init_state(mdl, opt, rcfg, make_mesh(1))
    start = {n: {k: np.asarray(a).copy() for k, a in t.items()}
             for n, t in state["tables"].items()}
    cfg = Config(**kw)
    step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    ours = state_from_numpy(cfg, start, "cpu")
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
            np.testing.assert_allclose(back[n][k], np.asarray(a), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{n}.{k}")
    return step


def _left(raw):
    keys, slots, vals, mask, labels, weights = raw
    order = np.argsort(-mask, axis=1, kind="stable")
    keys, slots, mask = (np.take_along_axis(a, order, 1) for a in (keys, slots, mask))
    return (np.where(mask > 0, keys, 0).astype(np.int32), slots, mask.copy(), mask,
            labels, weights)


@pytest.mark.parametrize("optimizer, wire", [("ftrl", "compact"), ("ftrl", "dict"),
                                             ("sgd", "compact")])
@pytest.mark.parametrize("mode", list(MODES))
def test_mvm_hot_step_matches_reference(mode, optimizer, wire):
    step = _check_step_parity(_step_kw(optimizer, wire, 6, **MODES[mode]))
    assert step.window == (mode.startswith("seq-hot") and mode.endswith("mb4"))


@pytest.mark.parametrize("wire", ["compact", "dict", "full"])
@pytest.mark.parametrize("mode", NOHOT_MODES)
def test_mvm_step_matches_reference(mode, wire):
    """mvm_nohot's geometry (no hot table) in the modes the reference
    allows without one, and ``update_mode="sparse"``."""
    _check_step_parity(_step_kw("ftrl", wire, 0, **MODES[mode]))


@pytest.mark.parametrize("wire", ["compact", "full"])
def test_mvm_sparse_step_matches_reference(wire):
    _check_step_parity(_step_kw("ftrl", wire, 0, update_mode="sparse"))


@pytest.mark.parametrize("mode", ["dense", "seq-sparse-mb4", "seq-hot-sparse-mb4"])
def test_mvm_hot_full_wire_matches_reference(mode):
    """The full wire: int32 field planes (negative ids included) and an
    int32 hot plane with its values."""
    _check_step_parity(_step_kw("ftrl", "full", 8, **MODES[mode]))


def test_mvm_mxu_bf16_matches_reference():
    """A forced ``hot_impl="mxu"`` with bfloat16: the hot rows and the
    hot gradients rounded to bfloat16 (tests/test_torch_hot_train.py's
    atol 1e-4: a rounding may land one bfloat16 step apart)."""
    kw = _step_kw("ftrl", "compact", 6, hot_impl="mxu", hot_dtype="bfloat16")
    full = False
    raws = [_zipf_raw(s, 64, KC, KH, T_LOG2, 64, full=full) for s in (1, 2)]
    rcfg = RefConfig(**kw)
    mdl, opt = ref_make_model(rcfg), ref_make_optimizer(rcfg)
    rstep = RefTrainStep(mdl, opt, rcfg, make_mesh(1))
    state = ref_init_state(mdl, opt, rcfg, make_mesh(1))
    cfg = Config(**kw)
    step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    ours = state_from_numpy(cfg, {n: {k: np.asarray(a) for k, a in t.items()}
                                  for n, t in state["tables"].items()}, "cpu")
    for raw in raws:
        state, _ = rstep.train(state, rstep.put_batch(ref_batch.make_batch(*raw, 64, KH)))
        step.train(ours, step.put_batch(port_batch.make_batch(*raw, 64, KH)))
    assert step.hot_bf16
    for k, a in state["tables"]["v"].items():
        np.testing.assert_allclose(ours["tables"]["v"][k].numpy(), np.asarray(a), rtol=RTOL,
                                   atol=1e-4)


def test_sliced_keeps_field_planes():
    """A sequential batch keeps its field planes through the slice
    reorder, on the dictionary wire (K6's field streams) and the compact
    wire."""
    for wire in ("dict", "compact"):
        cfg = Config(**_step_kw("ftrl", wire, 6, **MODES["seq-hot-sparse-mb4"]))
        step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
        raw = _left(_zipf_raw(3, 64, KC, KH, T_LOG2, 64))
        batch = port_batch.make_batch(*raw, 64, KH)
        arrays = step.put_batch(batch)
        order = step.slice_order(64)
        clamp = np.where((batch.slots < 0) | (batch.slots > 255), 255, batch.slots)
        hclamp = np.where((batch.hot_slots < 0) | (batch.hot_slots > 255), 255,
                          batch.hot_slots)
        want = np.where(batch.mask > 0, clamp, 0)[order]
        hwant = np.where(batch.hot_mask > 0, hclamp, 0)[order]
        got, hgot = arrays["fields"].numpy(), arrays["hot_fields"].numpy()
        if wire == "compact":  # the compact wire ships padding's ids too
            live, hlive = batch.mask[order] > 0, batch.hot_mask[order] > 0
            got, hgot = np.where(live, got, 0), np.where(hlive, hgot, 0)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(hgot, hwant)


def test_compact_wire_clamps_fields_as_the_reference():
    from xflow_tpu.parallel.step import compact_wire_np as ref_compact_wire_np

    raw = _zipf_raw(9, 32, KC, KH, T_LOG2, 64, slot_lo=-300, slot_hi=300)
    ours = compact_wire_np(port_batch.make_batch(*raw, 64, KH), True, ship_slots=True)
    ref = ref_compact_wire_np(ref_batch.make_batch(*raw, 64, KH), True, True)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k


def test_mvm_slot_limit_is_refused_by_name():
    """C5: an MVM row past MVM_MAX_SLOTS (the most a warp's shared-memory
    stage holds; the kernels stage a wider row in device memory) is
    servable and trains: at MVM_MAX_SLOTS + 1 slots, predict and one
    dense and one sparse step against the JAX package.  The wrappers'
    other refusals stand."""
    check_servable(Config(model="mvm", max_nnz=MVM_MAX_SLOTS))
    check_servable(Config(model="mvm", max_nnz=MVM_MAX_SLOTS + 1))
    assert mvm_stage_global(MVM_MAX_SLOTS + 1) and not mvm_stage_global(MVM_MAX_SLOTS)
    wide = MVM_MAX_SLOTS + 1
    kw = dict(model="mvm", table_size_log2=T_LOG2, max_nnz=wide, batch_size=8, v_dim=D,
              max_fields=S, num_devices=1)
    _past_cap_parity(kw, _past_cap_raw(21, 8, wide, T_LOG2, S))
    keys = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="v and no w"):
        score(keys, None, torch.zeros((8, 1)), torch.zeros((8, 2)),
              fields=torch.zeros((2, 3), dtype=torch.uint8), max_fields=4, form="mvm")
    with pytest.raises(ValueError, match="fields must be uint8 or int32"):
        score(keys, None, None, torch.zeros((8, 2)),
              fields=torch.zeros((2, 3), dtype=torch.int64), max_fields=4, form="mvm")
    acc = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="w and g_w come together"):
        train_step(keys, None, torch.zeros(2), torch.ones(2), 2.0, None,
                   torch.zeros((8, 2)), torch.zeros((8, 1)), torch.zeros((8, 2)), acc,
                   fields=torch.zeros((2, 3), dtype=torch.uint8), max_fields=4, form="mvm")



def _past_cap_parity(kw, raw):
    """C5: a geometry past the kernels' shared-memory stage, on the CPU
    against the JAX package: predict from the reference's initial tables
    (params plus seed-made noise of 0.01), then one step from its
    initial state in the dense and in the sparse update mode, tables
    (and dense parameters) and log-loss at rtol 1e-5 / atol 1e-6, pctr
    at atol 1e-6."""
    import jax.numpy as jnp

    from xflow_tpu.io import batch as ref_batch
    from xflow_tpu.optim import make_optimizer as ref_make_optimizer
    from xflow_tpu.parallel.mesh import make_mesh
    from xflow_tpu.parallel.step import TrainStep as RefTrainStep
    from xflow_tpu.parallel.step import init_state as ref_init_state
    from xflow_tpu_torch.convert import dense_to_numpy
    from xflow_tpu_torch.io import batch as port_batch
    from xflow_tpu_torch.optim import make_optimizer
    from xflow_tpu_torch.parallel.step import TrainStep

    cpu = torch.device("cpu")
    for mode in ({}, {"update_mode": "sparse"}):
        rcfg = RefConfig(**kw, **mode)
        mdl, opt = ref_make_model(rcfg), ref_make_optimizer(rcfg)
        rstep = RefTrainStep(mdl, opt, rcfg, make_mesh(1))
        state = ref_init_state(mdl, opt, rcfg, make_mesh(1))
        start = {n: {k: np.asarray(a).copy() for k, a in t.items()}
                 for n, t in state["tables"].items()}
        dense = {k: np.asarray(a).copy() for k, a in state["dense"].items()}
        cfg = Config(**kw, **mode)
        step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, cpu)
        if not mode:
            rng = np.random.default_rng(11)
            noisy = {n: dict(t, param=(t["param"] + rng.normal(0, 0.01, t["param"].shape))
                             .astype(np.float32)) for n, t in start.items()}
            ref_state = {"tables": {n: {k: jnp.asarray(a) for k, a in t.items()}
                                    for n, t in noisy.items()}, "dense": state["dense"]}
            batch = ref_batch.make_batch(*raw, 0, 0)
            want = np.asarray(rstep.predict(ref_state, rstep.put_batch(batch, predict=True)))
            ours = state_from_numpy(cfg, noisy, "cpu", dense=dense or None)
            got = step.predict(ours, step.put_batch(port_batch.make_batch(*raw, 0, 0),
                                                     predict=True)).numpy()
            np.testing.assert_allclose(got, want, atol=1e-6)
        ours = state_from_numpy(cfg, start, "cpu", dense=dense or None)
        state, m = rstep.train(state, rstep.put_batch(ref_batch.make_batch(*raw, 0, 0)))
        got = step.train(ours, step.put_batch(port_batch.make_batch(*raw, 0, 0)))
        assert float(got["count"]) == float(m["count"])
        np.testing.assert_allclose(float(got["logloss"]), float(m["logloss"]), rtol=1e-5,
                                   atol=1e-6)
        back = state_to_numpy(ours, aux=True)
        for n, t in state["tables"].items():
            for k, a in t.items():
                np.testing.assert_allclose(back[n][k], np.asarray(a), rtol=1e-5, atol=1e-6,
                                           err_msg=f"{mode} {n}.{k}")
        for k, a in state["dense"].items():
            np.testing.assert_allclose(dense_to_numpy(ours)[k], np.asarray(a), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{mode} dense {k}")


def _past_cap_raw(seed, b, k, t_log2, fields):
    """Seed-made [B, K] planes (keys, field ids in [0, fields) with some
    past it, values, mask, labels, weights; the last row padding)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << t_log2, (b, k)).astype(np.int32)
    slots = rng.integers(0, fields, (b, k)).astype(np.int32)
    slots[rng.random((b, k)) < 0.03] = fields + 1
    mask = (rng.random((b, k)) < 0.85).astype(np.float32)
    mask[-1] = 0.0
    vals = np.ones((b, k), np.float32)
    labels = (rng.random(b) < 0.4).astype(np.float32)
    weights = np.ones(b, np.float32)
    weights[-1] = 0.0
    return keys, slots, vals, mask, labels, weights

# -- the Trainer, learning, artifacts, the CLI ----------------------------------


def _trainer_kw(ds, **kw):
    # tests/test_train.py::make_cfg, with MVM's fields
    base = dict(train_path=ds.train_prefix, test_path=ds.test_prefix, epochs=4,
                batch_size=64, table_size_log2=14, max_nnz=24, max_fields=12,
                num_devices=1, model="mvm")
    base.update(kw)
    return base


@pytest.mark.parametrize("mode", [{}, dict(update_mode="sequential", microbatch=4,
                                           sequential_inner="sparse")],
                         ids=["dense", "seq-sparse"])
def test_trainer_mvm_tracks_jax_trainer(toy_dataset, mode):
    """The JAX Trainer and the port's from the same initial state:
    per-epoch train log-loss and the eval log-loss and AUC within 1e-4
    (tests/test_torch_trainer.py's bound), the wire rows equal."""
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


def test_mvm_learns(toy_dataset):
    """tests/test_train.py:47 in the port."""
    with Trainer(Config(**_trainer_kw(toy_dataset, epochs=15, max_nnz=24)), device="cpu",
                 log=lambda _: None) as trainer:
        trainer.train()
        result = trainer.evaluate()
    assert result["auc"] > 0.65, result


def _lines(ds):
    with open(ds.test_prefix + "-00000") as f:
        return f.read().splitlines()


@pytest.mark.parametrize("hot", [False, True], ids=["nohot", "hot"])
def test_mvm_artifacts_score_equal_both_ways(toy_dataset, tmp_path, hot):
    """An MVM artifact the JAX trainer exports scores equal in the
    port's engine, and the port's export of the same model scores equal
    in the JAX engine; convert.py carries the train state both ways."""
    extra = dict(hot_size_log2=6, hot_nnz=8, freq_sample_mib=1) if hot else {}
    kw = _trainer_kw(toy_dataset, epochs=1, v_dim=D, **extra)
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
    # the train state through convert.py, and the port's export
    cfg = Config(**kw)
    state = state_from_numpy(cfg, ref_tables, "cpu")
    back = state_to_numpy(state, aux=True)
    assert set(back["v"]) == set(ref_tables["v"])
    for k, a in ref_tables["v"].items():
        assert np.array_equal(back["v"][k], a)
    port_art = write_artifact(str(tmp_path / "port_art"), cfg,
                              {"v": back["v"]["param"]}, step=3, remap=remap)
    again = RefEngine.load(port_art, buckets=(8, 64), warm=False)
    np.testing.assert_allclose(again.score_text(lines), want, atol=PCTR_ATOL)
    # and the port's Trainer exports what its engine serves
    with Trainer(cfg, device="cpu", log=lambda _: None) as trainer:
        trainer.state = state_from_numpy(cfg, ref_tables, "cpu")
        exported = export_artifact(trainer, str(tmp_path / "trainer_art"))
    np.testing.assert_allclose(
        PredictEngine.load(exported, device="cpu", buckets=(8, 64)).score_text(lines), want,
        atol=PCTR_ATOL)
    assert os.path.exists(os.path.join(exported, "manifest.json"))


@pytest.mark.parametrize("flag", ["mvm", "2"])
def test_cli_trains_mvm(toy_dataset, tmp_path, flag):
    art = str(tmp_path / "art")
    rc = cli_main(["--model", flag, "--train", toy_dataset.train_prefix, "--test",
                   toy_dataset.test_prefix, "--epochs", "2", "--batch-size", "64",
                   "--table-size-log2", "14", "--max-nnz", "24", "--device", "cpu",
                   "--export-artifact", art])
    assert rc in (0, None)
    engine = PredictEngine.load(art, device="cpu", buckets=(64,))
    assert engine.cfg.model == "mvm"
    assert np.isfinite(engine.score_text(_lines(toy_dataset))).all()


# -- C1: FM past 32 factors --------------------------------------------------


def test_fm_v_dim_64_step_and_serving_match_reference(toy_dataset, tmp_path):
    """FM at v_dim=64 (refused before: the kernels held 32 factors in
    registers): one step against the JAX TrainStep, and a JAX artifact
    served in the port."""
    kw = dict(model="fm", optimizer="ftrl", table_size_log2=T_LOG2, max_nnz=KC, batch_size=64,
              v_dim=64, num_devices=1, wire_dedup="off")
    rcfg = RefConfig(**kw)
    mdl, opt = ref_make_model(rcfg), ref_make_optimizer(rcfg)
    rstep = RefTrainStep(mdl, opt, rcfg, make_mesh(1))
    state = ref_init_state(mdl, opt, rcfg, make_mesh(1))
    cfg = Config(**kw)
    check_servable(cfg)
    step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    ours = state_from_numpy(cfg, {n: {k: np.asarray(a) for k, a in t.items()}
                                  for n, t in state["tables"].items()}, "cpu")
    raw = _zipf_raw(4, 64, KC, 0, T_LOG2, 0)
    state, m = rstep.train(state, rstep.put_batch(ref_batch.make_batch(*raw)))
    got = step.train(ours, step.put_batch(port_batch.make_batch(*raw)))
    np.testing.assert_allclose(float(got["logloss"]), float(m["logloss"]), rtol=RTOL, atol=ATOL)
    for n, t in state["tables"].items():
        for k, a in t.items():
            np.testing.assert_allclose(ours["tables"][n][k].numpy(), np.asarray(a), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{n}.{k}")
    trainer = RefTrainer(RefConfig(train_path=toy_dataset.train_prefix,
                                   test_path=toy_dataset.test_prefix, model="fm", v_dim=64,
                                   epochs=1, batch_size=64, table_size_log2=14, max_nnz=24,
                                   num_devices=1))
    trainer.train()
    art = str(tmp_path / "fm64")
    ref_export_artifact(trainer, art)
    trainer.close()
    lines = _lines(toy_dataset)
    np.testing.assert_allclose(
        PredictEngine.load(art, device="cpu", buckets=(8, 64)).score_text(lines),
        RefEngine.load(art, buckets=(8, 64), warm=False).score_text(lines), atol=PCTR_ATOL)
