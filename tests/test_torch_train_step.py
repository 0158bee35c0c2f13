"""One train step of the port (K2's and K3's plain versions, on the CPU)
against the reference's jitted ``TrainStep.train`` from the same state
on the same ``toy_dataset`` batch, and the step's host wire, state
init, refusals and conversion.  Tolerance rtol 1e-5 / atol 1e-6 on
every table and the log-loss — tests/test_ftrl.py's bar: XLA contracts
``n + g*g`` into an FMA and sums the scatter in its own order, eager
PyTorch does neither (ROADMAP parity bar)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.io.batch import pack_batch as ref_pack_batch
from xflow_tpu.io.libffm import parse_block as ref_parse_block
from xflow_tpu.models import make_model as ref_make_model
from xflow_tpu.optim import make_optimizer as ref_make_optimizer
from xflow_tpu.parallel.mesh import make_mesh
from xflow_tpu.parallel.step import TrainStep as RefTrainStep
from xflow_tpu.parallel.step import init_state as ref_init_state
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import state_from_numpy, state_to_numpy
from xflow_tpu_torch.io.batch import pack_batch
from xflow_tpu_torch.io.libffm import parse_block
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.ops.train import train_plain, train_step
from xflow_tpu_torch.optim import make_optimizer
from xflow_tpu_torch.parallel.step import TrainStep, init_state

RTOL, ATOL = 1e-5, 1e-6
B, K = 64, 24


def _kw(model, optimizer, hash_mode, **extra):
    return dict(model=model, optimizer=optimizer, table_size_log2=12,
                max_nnz=K, batch_size=B, num_devices=1, hash_mode=hash_mode,
                sgd_lr=0.05, v_dim=6, **extra)


def _tables_np(state):
    return {n: {k: np.asarray(a).copy() for k, a in t.items()}
            for n, t in state["tables"].items()}


@pytest.mark.parametrize("dedup", ["off", "auto"])
@pytest.mark.parametrize("hash_mode", [True, False], ids=["compact", "full"])
@pytest.mark.parametrize("optimizer", ["ftrl", "sgd"])
@pytest.mark.parametrize("model", ["lr", "fm"])
def test_one_step_matches_reference(toy_dataset, model, optimizer, hash_mode, dedup):
    data = open(toy_dataset.train_prefix + "-00000", "rb").read()
    rcfg = RefConfig(**_kw(model, optimizer, hash_mode, wire_dedup=dedup))
    ref_model, ref_opt = ref_make_model(rcfg), ref_make_optimizer(rcfg)
    ref = RefTrainStep(ref_model, ref_opt, rcfg, make_mesh(1))
    state = ref_init_state(ref_model, ref_opt, rcfg, make_mesh(1))
    block = ref_parse_block(data, rcfg.table_size, hash_mode, 0)
    # one reference step first, so the compared step starts from a
    # state with n > 0 and w != 0
    state, _ = ref.train(state, ref.put_batch(ref_pack_batch(block, 0, B, B, K)))
    start = _tables_np(state)
    state, ref_metrics = ref.train(
        state, ref.put_batch(ref_pack_batch(block, B, 2 * B, B, K))
    )
    want = _tables_np(state)

    cfg = Config(**_kw(model, optimizer, hash_mode, wire_dedup=dedup))
    ours = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, torch.device("cpu"))
    assert ours.wire_format == ref.wire_format == (
        "full" if not hash_mode else "dict" if dedup == "auto" else "compact")
    pstate = state_from_numpy(cfg, start, "cpu", step=1)
    ports_block = parse_block(data, cfg.table_size, hash_mode, 0)
    metrics = ours.train(pstate, ours.put_batch(pack_batch(ports_block, B, 2 * B, B, K)))
    assert pstate["step"] == 2
    np.testing.assert_allclose(
        float(metrics["logloss"]), float(ref_metrics["logloss"]), rtol=RTOL
    )
    assert float(metrics["count"]) == float(ref_metrics["count"])
    got = state_to_numpy(pstate, aux=True)
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name])
        for key in want[name]:
            np.testing.assert_allclose(
                got[name][key], want[name][key], rtol=RTOL, atol=ATOL,
                err_msg=f"{name}.{key}",
            )
        assert not pstate["tables"][name]["g"].any()  # K3 cleared it


def _planes(seed=0, t=1 << 10, d=4, b=16, k=8, full=False):
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, t, size=(b, k)).astype(np.int32)
    keys[:, k // 2:][rng.random((b, k - k // 2)) > 0.5] = -1
    keys[3] = -1  # an all-padding row
    x = None
    if full:
        x = np.where(keys >= 0, rng.uniform(0.25, 2.0, (b, k)), 0.0).astype(np.float32)
    w = (rng.standard_normal((t, 1)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((t, d)) * 0.3).astype(np.float32)
    labels = (rng.random(b) > 0.5).astype(np.float32)
    return keys, x, w, v, labels


def _run_plain(keys, x, w, v, labels, weights, num_real):
    t = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    g_w = torch.zeros(w.shape)
    g_v = torch.zeros(v.shape) if v is not None else None
    acc = torch.zeros(2, dtype=torch.float64)
    train_step(t(keys), t(x), t(labels), t(weights), num_real, t(w), t(v), g_w, g_v, acc)
    return g_w, g_v, acc


@pytest.mark.parametrize("full", [False, True], ids=["compact", "full"])
@pytest.mark.parametrize("with_v", [False, True], ids=["lr", "fm"])
def test_padding_never_writes_and_all_padding_rows_add_nothing(with_v, full):
    keys, x, w, v, labels = _planes(full=full)
    v = v if with_v else None
    b = keys.shape[0]
    weights = np.ones(b, np.float32)
    g_w, g_v, acc = _run_plain(keys, x, w, v, labels, weights, 16.0)
    # no live key is 0, so row 0 (where padding clamps to) stays exactly 0
    assert not (keys == 0).any()
    assert float(g_w[0, 0]) == 0.0 and (g_v is None or not g_v[0].any())
    # appending all-padding rows with weight 0 (padding examples) adds
    # nothing; with weight 1 it adds only to the loss and the count
    pad = np.full((5, keys.shape[1]), -1, np.int32)
    keys2 = np.concatenate([keys, pad])
    x2 = None if x is None else np.concatenate([x, np.zeros((5, keys.shape[1]), np.float32)])
    labels2 = np.concatenate([labels, np.ones(5, np.float32)])
    for wpad, dcount in ((0.0, 0.0), (1.0, 5.0)):
        weights2 = np.concatenate([weights, np.full(5, wpad, np.float32)])
        h_w, h_v, acc2 = _run_plain(keys2, x2, w, v, labels2, weights2, 16.0)
        assert torch.equal(h_w, g_w) and (g_v is None or torch.equal(h_v, g_v))
        assert float(acc2[1]) == float(acc[1]) + dcount
        # a featureless example scores pctr = 0.5: -log(0.5) each
        np.testing.assert_allclose(
            float(acc2[0]), float(acc[0]) + dcount * np.log(2.0), rtol=1e-6
        )


@pytest.mark.parametrize("with_v", [False, True], ids=["lr", "fm"])
def test_repeated_keys_sum(with_v):
    """Two halves of a batch that share keys: the whole batch's gradient
    is the sum of the halves' at the same num_real."""
    keys, x, w, v, labels = _planes(seed=4)
    keys[: 8, 0] = 7  # the same key in 8 examples
    keys[8:, 0] = 7
    v = v if with_v else None
    weights = np.ones(keys.shape[0], np.float32)
    whole = _run_plain(keys, x, w, v, labels, weights, 16.0)
    a = _run_plain(keys[:8], x, w, v, labels[:8], weights[:8], 16.0)
    b = _run_plain(keys[8:], x, w, v, labels[8:], weights[8:], 16.0)
    np.testing.assert_allclose(whole[0].numpy(), (a[0] + b[0]).numpy(), rtol=RTOL, atol=1e-9)
    if with_v:
        np.testing.assert_allclose(whole[1].numpy(), (a[1] + b[1]).numpy(), rtol=RTOL, atol=1e-9)
    assert float(whole[0][7, 0]) != 0.0


def test_train_wrapper_rejects_bad_inputs():
    keys, _, w, v, labels = _planes()
    t = torch.tensor
    args = dict(keys=t(keys), x=None, labels=t(labels), weights=t(labels),
                num_real=1.0, w=t(w), v=None, g_w=torch.zeros(w.shape), g_v=None,
                acc=torch.zeros(2, dtype=torch.float64))
    train_step(**args)
    for bad, match in (
        (dict(keys=t(keys.astype(np.int64))), "keys must be int32"),
        (dict(labels=t(labels.astype(np.float64))), "labels must be"),
        (dict(weights=t(labels.astype(np.uint8))), "one dtype"),
        (dict(v=t(v)), "come together"),
        (dict(g_w=torch.zeros((4, 1))), "g_w must be"),
        (dict(acc=torch.zeros(3)), "acc must be"),
        (dict(x=torch.zeros((2, 2))), "x must be"),
    ):
        with pytest.raises(ValueError, match=match):
            train_step(**{**args, **bad})


def test_plain_is_the_cpu_path_and_counts_no_launch():
    keys, x, w, v, labels = _planes(full=True)
    weights = np.ones(keys.shape[0], np.float32)
    before = train_step.launches
    got = _run_plain(keys, x, w, v, labels, weights, 16.0)
    assert train_step.launches == before
    want_w, want_v = torch.zeros(w.shape), torch.zeros(v.shape)
    want_acc = torch.zeros(2, dtype=torch.float64)
    t = torch.tensor
    train_plain(t(keys), t(x), t(labels), t(weights), 16.0, t(w), t(v), want_w, want_v, want_acc)
    assert torch.equal(got[0], want_w) and torch.equal(got[1], want_v)
    assert torch.equal(got[2], want_acc)


def test_init_state_tables_and_v_distribution():
    cfg = Config(model="fm", table_size_log2=14, v_dim=8, v_init_scale=0.02, seed=3)
    model, opt = make_model(cfg), make_optimizer(cfg)
    state = init_state(model, opt, cfg, torch.device("cpu"))
    assert state["step"] == 0 and state["dense"] == {}
    w, v = state["tables"]["w"], state["tables"]["v"]
    assert set(w) == set(v) == {"param", "n", "z", "g"}
    assert not w["param"].any()
    for t in (w, v):
        assert not t["n"].any() and not t["z"].any() and not t["g"].any()
    vals = v["param"].double()
    assert abs(float(vals.mean())) < 0.02 * 5 / np.sqrt(vals.numel())
    assert abs(float(vals.std()) / 0.02 - 1.0) < 0.01
    again = init_state(model, opt, cfg, torch.device("cpu"))
    assert torch.equal(again["tables"]["v"]["param"], v["param"])  # seeded
    other = init_state(model, opt, dataclasses.replace(cfg, seed=4), torch.device("cpu"))
    assert not torch.equal(other["tables"]["v"]["param"], v["param"])


def test_put_batch_wires_and_num_real(toy_dataset):
    data = open(toy_dataset.test_prefix + "-00000", "rb").read()
    for hash_mode, planes in ((True, {"ckeys", "labels_u8", "weights_u8"}),
                              (False, {"ckeys", "x", "labels", "weights"})):
        cfg = Config(**_kw("lr", "ftrl", hash_mode))
        step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, torch.device("cpu"))
        batch = pack_batch(parse_block(data, cfg.table_size, hash_mode, 0), 0, 37, B, K)
        arrays = step.put_batch(batch)
        assert set(arrays) == planes | {"num_real"}
        assert isinstance(arrays["num_real"], float) and arrays["num_real"] == 37.0
        assert arrays["ckeys"].dtype == torch.int32
        assert int((arrays["ckeys"] < 0).sum()) == int((batch.mask == 0).sum())
        assert set(step.put_batch(batch, predict=True)) <= {"ckeys", "x"}
        # the predict batch is booked too, as the reference books it
        snap = step.obs.registry.snapshot()
        assert snap.counters["wire.examples"] == 74 and "phase.h2d" in snap.counters


@pytest.mark.parametrize("kw, item", [
    # the update modes train now (tests/test_torch_update_modes.py), with
    # the hot table too (tests/test_torch_hot_train.py); what stays
    # refused beside it names its own item
    ({"update_mode": "sequential", "microbatch": 2, "hot_size_log2": 8,
      "sequential_inner": "hot", "num_devices": 2}, "A13"),
    ({"update_mode": "sequential", "microbatch": 2, "hot_size_log2": 8,
      "input_streams": 2}, "A10"),
    ({"microbatch": 2, "hot_size_log2": 8, "num_devices": 2}, "A13"),
    ({"cold_consolidate": True, "hot_size_log2": 8, "input_streams": 2}, "A10"),
    ({"update_mode": "sequential", "microbatch": 2, "hot_size_log2": 8,
      "sequential_inner": "sparse", "num_devices": 2}, "A13"),
    # the dictionary wire trains (tests/test_torch_dict_wire.py), with
    # the hot table too, but not on two devices
    ({"wire_dedup": "on", "hot_size_log2": 8, "num_devices": 2}, "A13"),
    ({"wire_dedup": "on", "num_devices": 2}, "A13"),
    ({"store_mode": "tiered", "hot_capacity_log2": 10}, "A11"),
    ({"num_devices": 2}, "A13"),
    ({"input_streams": 2}, "A10"),
    # MVM trains now (tests/test_torch_mvm.py), on one device
    ({"model": "mvm", "num_devices": 2}, "A13"),
    # FFM trains now (tests/test_torch_ffm.py), on one device
    ({"model": "ffm", "num_devices": 2}, "A13"),
    ({"model": "wide_deep"}, "A9"),
    ({"model": "two_tower"}, "A9"),
    ({"model": "dcn"}, "A9"),
])
def test_train_step_refuses_unported(kw, item):
    cfg = Config(**{**_kw("lr", "ftrl", True), **kw})
    with pytest.raises(NotImplementedError, match=item):
        TrainStep(make_model(cfg) if cfg.model in ("lr", "fm", "mvm", "ffm") else None,
                  make_optimizer(cfg), cfg, torch.device("cpu"))


def test_jax_train_state_converts_both_ways():
    rcfg = RefConfig(model="fm", table_size_log2=10, v_dim=4, num_devices=1)
    ref_model, ref_opt = ref_make_model(rcfg), ref_make_optimizer(rcfg)
    state = ref_init_state(ref_model, ref_opt, rcfg, make_mesh(1))
    rng = np.random.default_rng(0)
    tables = {
        n: {k: (np.asarray(a) + rng.random(np.asarray(a).shape)).astype(np.float32)
            for k, a in t.items()}
        for n, t in state["tables"].items()
    }
    cfg = Config.from_json(rcfg.to_json())
    ours = state_from_numpy(cfg, tables, "cpu", step=5)
    assert ours["step"] == 5
    for n in tables:  # a train state comes in with the zeroed gradient buffer
        assert ours["tables"][n]["g"].shape == ours["tables"][n]["param"].shape
        assert not ours["tables"][n]["g"].any()
    back = state_to_numpy(ours, aux=True)
    for n in tables:
        assert set(back[n]) == {"param", "n", "z"}
        for k in tables[n]:
            assert np.array_equal(back[n][k], tables[n][k])
    # and back into the reference's state layout
    ref_state = {"tables": {n: {k: jnp.asarray(a) for k, a in t.items()}
                            for n, t in back.items()}}
    assert set(ref_state["tables"]["v"]) == set(state["tables"]["v"])
    with pytest.raises(ValueError, match="must be float32"):
        state_from_numpy(cfg, {**tables, "w": {"param": tables["w"]["param"][:5]}}, "cpu")

