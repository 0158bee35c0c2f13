"""FFM (B10) in the port: one K2 step against the JAX ``TrainStep`` on
the CPU, on the same numpy-seeded batches from the same state (carried
with convert.py), in every update mode FFM takes (dense microbatch 1
and 4, sparse, sequential with the sparse and dense inners; with the
hot table dense, dense microbatch 4 and the hybrid), FTRL and SGD, on
the compact, dictionary and full wires (the cases of
tests/test_update_modes.py:72-85 and tests/test_sequential.py:66-70);
the bf16 hot flag on w alone; the hot inner refused with the
reference's message, and dense + ``sequential_inner="hot"`` still
legal (tests/test_sequential.py:512-545).  The model, the Trainer and
artifacts are tests/test_torch_ffm.py's.

Tolerances: one step's tables and log-losses rtol 1e-5 / atol 1e-6
(ROADMAP's parity bar: the sums run in another order); bfloat16 tables
atol 1e-4 (one bfloat16 step of a hot w gradient,
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
from xflow_tpu_torch.convert import state_from_numpy, state_to_numpy
from xflow_tpu_torch.io import batch as port_batch
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.optim import make_optimizer
from xflow_tpu_torch.parallel.step import TrainStep

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6


# -- one train step against the JAX TrainStep ---------------------------------

T_LOG2, KC, KH, SF, VD = 12, 8, 4, 6, 3


def _zipf_raw(seed, b, kc, kh, h, full=False, slot_lo=0):
    """Seed-made [B, Kc + Kh] planes: zipf-like keys (rows carry more hot
    keys than Kh: the overflow spills), field ids (some past max_fields,
    and below 0 from ``slot_lo``), masked holes, the last 3 examples
    padding."""
    rng = np.random.default_rng(seed)
    ktot = kc + kh
    keys = rng.integers(0, 1 << T_LOG2, (b, ktot))
    if h:
        head = np.minimum(rng.zipf(1.3, (b, ktot)) - 1, 2 * h)
        keys = np.where(rng.random((b, ktot)) < 0.6, head, keys)
    keys = keys.astype(np.int32)
    slots = rng.integers(slot_lo, SF, (b, ktot)).astype(np.int32)
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
    # the update modes FFM takes; "hot-*" run with the hot table
    # (H = 2^6, 4 hot slots): its w rides the head, its v the plain rows
    "dense": {},
    "dense-mb4": dict(microbatch=4),
    "sparse": dict(update_mode="sparse"),
    "seq-sparse-mb4": dict(update_mode="sequential", microbatch=4, sequential_inner="sparse"),
    "seq-dense-mb4": dict(update_mode="sequential", microbatch=4),
    "hot-dense": dict(hot_size_log2=6),
    "hot-dense-mb4": dict(hot_size_log2=6, microbatch=4),
    "hot-hybrid-mb4": dict(hot_size_log2=6, update_mode="sequential", microbatch=4,
                           sequential_inner="sparse"),
    "hot-hybrid-mb1": dict(hot_size_log2=6, update_mode="sequential",
                           sequential_inner="sparse"),
}


def _step_kw(optimizer, wire, **mode):
    h_log2 = mode.pop("hot_size_log2", 0)
    return dict(model="ffm", optimizer=optimizer, table_size_log2=T_LOG2, max_nnz=KC,
                hot_size_log2=h_log2, hot_nnz=KH if h_log2 else 0, batch_size=64,
                ffm_v_dim=VD, max_fields=SF, num_devices=1, sgd_lr=0.05,
                hash_mode=wire != "full", wire_mode="full" if wire == "full" else "auto",
                wire_dedup="on" if wire == "dict" else "off", **mode)


def _check_step_parity(kw, atol=ATOL, edge=None):
    """Two steps from the reference's initial state (the second starts
    with n > 0): tables and log-losses; the batches cut by ``edge``
    (_edge) when given."""
    full = not kw["hash_mode"]
    h = (1 << kw["hot_size_log2"]) if kw["hot_size_log2"] else 0
    raws = [_zipf_raw(s, 64, KC, kw["hot_nnz"], h, full=full, slot_lo=-2 if full else 0)
            for s in (1, 2)]
    if edge is not None:
        raws = [_edge(r, edge) for r in raws]
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
            np.testing.assert_allclose(back[n][k], np.asarray(a), rtol=RTOL, atol=atol,
                                       err_msg=f"{n}.{k}")
    return step


@pytest.mark.parametrize("optimizer, wire", [("ftrl", "compact"), ("ftrl", "dict"),
                                             ("ftrl", "full"), ("sgd", "compact")])
@pytest.mark.parametrize("mode", list(MODES))
def test_ffm_step_matches_reference(mode, optimizer, wire):
    step = _check_step_parity(_step_kw(optimizer, wire, **MODES[mode]))
    assert step.row_chunks == (4 if mode in ("dense-mb4", "hot-dense-mb4") else 1)


def _edge(raw, edge):
    """A _zipf_raw batch at an edge K2's FFM form is held to on the card:
    every slot of every row in one field, one key live in every example,
    a key twice in one example (in one field, and in two), B = 1 (its
    first, live row)."""
    keys, slots, vals, mask, labels, weights = (a.copy() for a in raw)
    if edge == "one-field":
        slots[:] = 2
    elif edge == "one-key":
        keys[:, 0], slots[:, 0], mask[:-3, 0] = 5, 1, 1.0
    elif edge == "key-twice":
        keys[:2, :2], slots[:2, :2], mask[:2, :2] = 9, 3, 1.0
        slots[1, 1] = 4
    elif edge == "b1":
        return tuple(a[:1] for a in (keys, slots, vals, mask, labels, weights))
    return keys, slots, vals, mask, labels, weights


@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("edge", ["one-field", "one-key", "key-twice", "b1"])
def test_ffm_step_edges_match_reference(edge, mode):
    """One FFM step's plain K2 (dense: at the keys' rows; sparse: at
    K4's slots) against the JAX TrainStep on _edge's batches."""
    kw = _step_kw("ftrl", "compact", **MODES[mode])
    if edge == "b1":
        kw["batch_size"] = 1
    _check_step_parity(kw, edge=edge)


def test_ffm_mxu_bf16_rounds_w_alone():
    """A forced ``hot_impl="mxu"`` with bfloat16: the reference rounds the
    hot rows and gradients of the tables on the hot path, w alone for
    FFM (v opts out), and so does the port.  w within one bfloat16
    step (atol 1e-4), v at the float32 bar."""
    kw = _step_kw("ftrl", "compact", hot_size_log2=6, hot_impl="mxu", hot_dtype="bfloat16")
    raws = [_zipf_raw(s, 64, KC, KH, 64) for s in (1, 2)]
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
    for name, atol in (("w", 1e-4), ("v", ATOL)):
        for k, a in state["tables"][name].items():
            np.testing.assert_allclose(ours["tables"][name][k].numpy(), np.asarray(a),
                                       rtol=RTOL, atol=atol, err_msg=f"{name}.{k}")
    # the flag moved w: an unflagged run lands elsewhere
    plain_cfg = Config(**dict(kw, hot_impl="seg"))
    other = TrainStep(make_model(plain_cfg), make_optimizer(plain_cfg), plain_cfg, CPU)
    again = state_from_numpy(plain_cfg, {n: {k: np.asarray(a) for k, a in t.items()}
                                         for n, t in ref_init_state(
                                             mdl, opt, rcfg, make_mesh(1))["tables"].items()},
                             "cpu")
    for raw in raws:
        other.train(again, other.put_batch(port_batch.make_batch(*raw, 64, KH)))
    assert float((again["tables"]["w"]["z"] - ours["tables"]["w"]["z"]).abs().max()) > 1e-6


def test_ffm_hot_inner_refused_and_dense_inner_knob_legal():
    """``sequential`` with the hot inner is refused for FFM with the
    reference's message (tests/test_sequential.py:512); dense mode with
    ``sequential_inner="hot"`` builds and trains (:529)."""
    kw = _step_kw("ftrl", "compact", hot_size_log2=6, update_mode="sequential",
                  microbatch=4, sequential_inner="hot")
    cfg = Config(**kw)
    with pytest.raises(ValueError, match=r"opts table\(s\) \['v'\] out of the MXU hot path"):
        TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    with pytest.raises(ValueError, match=r"opts table\(s\) \['v'\]"):
        RefTrainStep(ref_make_model(RefConfig(**kw)), ref_make_optimizer(RefConfig(**kw)),
                     RefConfig(**kw), make_mesh(1))
    step = _check_step_parity(_step_kw("ftrl", "compact", hot_size_log2=6,
                                       sequential_inner="hot"))
    assert not step.window
