"""The port's tiered parameter store (xflow_tpu_torch/store/) against the
JAX package's (xflow_tpu/store/), piece by piece: the config refusals
and CLI flags, the cold store and its lazy per-row init (bitwise), the
hot tier's key→slot maps and row moves, the promotion worker and its
self-healing, and one tiered step of every family in both update
modes from the same hand-made tier placement.

The lazy init is bitwise the reference's (``row_init_values``), so a
tiered run of either package starts from the same logical table and
the one-step test compares trained rows, not two initialisations.
Tolerance: rtol 1e-5 / atol 1e-6 on every plane of the touched rows
and on the log-loss (ROADMAP's parity bar: the sums run in another
order)."""

import inspect
import threading
import time

import numpy as np
import pytest
import torch

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.io.batch import Batch as RefBatch
from xflow_tpu.models import make_model as ref_make_model
from xflow_tpu.optim import make_optimizer as ref_make_optimizer
from xflow_tpu.parallel.mesh import make_mesh
from xflow_tpu.parallel.step import TrainStep as RefTrainStep
from xflow_tpu.store import cold as ref_cold
from xflow_tpu.store import promote as ref_promote
from xflow_tpu.store.hot import HotTier as RefHotTier
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.io.batch import Batch, pack_batch
from xflow_tpu_torch.io.libffm import parse_block
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.obs import Obs
from xflow_tpu_torch.optim import make_optimizer
from xflow_tpu_torch.parallel.step import TrainStep
from xflow_tpu_torch.store import cold, promote
from xflow_tpu_torch.store.hot import HotTier

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
B, K = 64, 24


def _geometry(**kw):
    """The reference tests' toy geometry (tests/test_store.py:22-36)."""
    base = dict(model="fm", epochs=1, batch_size=B, table_size_log2=16, max_nnz=K,
                num_devices=1, store_mode="tiered", hot_capacity_log2=10)
    base.update(kw)
    return base


# -- config (tests/test_store.py:42-90) --------------------------------------


@pytest.mark.parametrize("kw, match", [
    ({"table_size_log2": 14, "hot_capacity_log2": 15}, "hot_capacity_log2"),
    ({"hot_capacity_log2": 10, "update_mode": "sequential"}, "sequential"),
    ({"hot_capacity_log2": 10, "hot_size_log2": 8}, "subsumes"),
    ({"hot_capacity_log2": 10, "microbatch": 4}, "microbatch"),
    ({"hot_capacity_log2": 10, "input_streams": 2}, "input_streams"),
    ({"store_mode": "paged"}, "store_mode"),
])
def test_config_refusals_match_reference(kw, match):
    kw = {"store_mode": "tiered", **kw}
    with pytest.raises(ValueError, match=match) as ours:
        Config(**kw)
    with pytest.raises(ValueError) as ref:
        RefConfig(**kw)
    assert str(ours.value) == str(ref.value)


def test_cli_store_flags():
    from xflow_tpu_torch.train import build_parser, config_from_args

    args = build_parser().parse_args([
        "--train", "x", "--store-mode", "tiered",
        "--hot-capacity-log2", "11", "--store-promote-every", "4",
        "--table-size-log2", "16",
    ])
    cfg = config_from_args(args)
    assert (cfg.store_mode, cfg.hot_capacity_log2, cfg.store_promote_every) == (
        "tiered", 11, 4)
    assert cfg.digest() == RefConfig(**{k: getattr(cfg, k) for k in (
        "train_path", "store_mode", "hot_capacity_log2", "store_promote_every",
        "table_size_log2")}).digest()


# -- the cold store --------------------------------------------------------


def test_cold_store_is_a_copy():
    """Every function and class of the cold store is the reference's
    source, line for line (the module docstring alone differs)."""
    for name in ("_splitmix64", "_tag64", "row_init_values", "ColdTableSpec", "ColdStore"):
        assert inspect.getsource(getattr(cold, name)) == inspect.getsource(
            getattr(ref_cold, name)), name


@pytest.mark.parametrize("dim", [1, 4, 10])
@pytest.mark.parametrize("kind, scale", [("normal", 1e-2), ("zeros", 0.0), ("normal", 0.0)])
def test_row_init_values_bitwise(kind, scale, dim):
    rng = np.random.default_rng(dim)
    rows = np.concatenate([
        np.arange(0, 64), (1 << 28) - 1 - np.arange(64),
        rng.integers(0, 1 << 28, 256),
    ]).astype(np.int64)
    for seed, table, arr in ((0, "v", "param"), (3, "w", "param"), (7, "emb", "n")):
        got = cold.row_init_values(seed, table, arr, rows, dim, kind, scale)
        want = ref_cold.row_init_values(seed, table, arr, rows, dim, kind, scale)
        assert got.dtype == np.float32 and got.shape == (len(rows), dim)
        assert got.tobytes() == want.tobytes()
    if kind == "normal" and scale:
        assert 0.001 < np.abs(got).mean() < 0.02


def test_cold_store_calls_match_reference():
    """fetch / write / take / delete / load_rows on both stores, the same
    calls in the same order: every result and the packed arrays equal."""
    specs = {"w": ({"param": ("zeros", 0.0), "n": ("zeros", 0.0)}, 1),
             "v": ({"param": ("normal", 1e-2), "n": ("zeros", 0.0)}, 4)}
    ours = cold.ColdStore({t: cold.ColdTableSpec(d, a) for t, (a, d) in specs.items()}, seed=5)
    ref = ref_cold.ColdStore({t: ref_cold.ColdTableSpec(d, a) for t, (a, d) in specs.items()},
                             seed=5)
    rng = np.random.default_rng(0)

    def same(a, b):
        for t in a:
            for k in a[t]:
                assert a[t][k].tobytes() == b[t][k].tobytes(), (t, k)

    for step in range(12):
        keys = np.unique(rng.integers(0, 5000, 300)).astype(np.int64)
        same(ours.fetch(keys), ref.fetch(keys))
        same(ours.fetch(keys, planes=("param",)), ref.fetch(keys, planes=("param",)))
        rows = {t: {k: rng.standard_normal((len(keys), d)).astype(np.float32)
                    for k in a} for t, (a, d) in specs.items()}
        ours.write(keys, rows)
        ref.write(keys, rows)
        gone = keys[::5]
        same(ours.take(gone), ref.take(gone))
        ours.delete(keys[1::7])
        ref.delete(keys[1::7])
        assert len(ours) == len(ref)
        assert ours.keys_view().tobytes() == ref.keys_view().tobytes()
        assert ours.nbytes() == ref.nbytes()
    for t, (a, _) in specs.items():
        for k in a:
            ok, orows = ours.export_array(t, k)
            rk, rrows = ref.export_array(t, k)
            assert ok.tobytes() == rk.tobytes() and orows.tobytes() == rrows.tobytes()
    keys = ours.keys_view().copy()
    data = {t: {k: ours.export_array(t, k)[1].copy() for k in a} for t, (a, _) in specs.items()}
    ours.load_rows(keys[::-1].copy(), {t: {k: v[::-1].copy() for k, v in a.items()}
                                       for t, a in data.items()})
    same(ours.fetch(keys), ref.fetch(keys))


# -- the hot tier ------------------------------------------------------------


def _tiers(**kw):
    cfg = Config(**_geometry(**kw))
    rcfg = RefConfig(**_geometry(**kw))
    ours = HotTier(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    ref = RefHotTier(ref_make_model(rcfg), ref_make_optimizer(rcfg), rcfg, make_mesh(1))
    return ours, ref


def test_hot_maps_match_reference():
    """lookup / assign / release / reset_maps on both tiers, the same
    calls: the same slots, the same maps."""
    ours, ref = _tiers(hot_capacity_log2=6)
    rng = np.random.default_rng(1)
    for _ in range(20):
        hot = np.asarray(sorted(ours.slot_of), np.int64)
        if len(hot):
            out = hot[rng.random(len(hot)) < 0.4]
            assert np.array_equal(ours.release(out), ref.release(out))
        fresh = np.setdiff1d(np.unique(rng.integers(0, 1 << 16, 40)), list(ours.slot_of))
        fresh = fresh[:ours.free_count]
        assert np.array_equal(ours.assign(fresh), ref.assign(fresh))
        probe = rng.integers(0, 1 << 16, 200).astype(np.int64)
        probe[:10] = fresh[:10] if len(fresh) >= 10 else probe[:10]
        assert np.array_equal(ours.lookup(probe), ref.lookup(probe))
        assert ours.slot_of == ref.slot_of and np.array_equal(ours.key_of, ref.key_of)
        assert (ours.occupancy, ours.free_count) == (ref.occupancy, ref.free_count)
    ours.reset_maps()
    ref.reset_maps()
    assert ours.occupancy == ref.occupancy == 0
    assert np.array_equal(ours.lookup(np.arange(5, dtype=np.int64)), -np.ones(5))


@pytest.mark.parametrize("update_mode", ["dense", "sparse"])
def test_fill_then_read_round_trips(update_mode):
    """Rows filled into slots read back exactly, every plane; slots not
    filled keep their rows; the combined buffer's miss rows are untouched."""
    ours, _ = _tiers(hot_capacity_log2=6, update_mode=update_mode)
    state = ours.init_device_state()
    assert set(state["tables"]) == {"w", "v"}
    assert set(state["tables"]["v"]) == {"param", "n", "z"}
    assert all(t.shape[0] == 64 for tab in state["tables"].values() for t in tab.values())
    assert ("g" in ours.bufs["v"]) == (update_mode == "dense")
    rng = np.random.default_rng(2)
    slots = rng.permutation(64)[:20]
    rows = {t: {p: rng.standard_normal((20, tab["param"].shape[1])).astype(np.float32)
                for p in tab} for t, tab in state["tables"].items()}
    ours.fill(state, slots, rows)
    back = ours.read(state, slots)
    for t in rows:
        for p in rows[t]:
            assert back[t][p].tobytes() == rows[t][p].tobytes()
    rest = np.setdiff1d(np.arange(64), slots)
    assert not ours.read(state, rest)["v"]["param"].any()
    assert not ours.bufs["v"]["param"][64:].any()
    assert (ours.fill_calls, ours.read_calls) == (6, 12)


# -- the promotion worker ----------------------------------------------------


def test_promotion_worker_is_a_copy():
    """The policy and its constants are the reference's."""
    for name in ("POLL_S", "DECAY_EVERY", "DECAY", "SCORE_FLOOR", "SCORES_MAX_FACTOR",
                 "MAX_SWAPS", "SWAP_EVERY", "SWAP_MARGIN"):
        assert getattr(promote, name) == getattr(ref_promote, name), name
    for name in ("_run_inner", "_build_plan", "note", "poll_plan", "ack", "alive"):
        assert inspect.getsource(getattr(promote.PromotionWorker, name)) == inspect.getsource(
            getattr(ref_promote.PromotionWorker, name)), name


def test_promotion_worker_closes_without_leak():
    before = {t.ident for t in threading.enumerate()}
    w = promote.PromotionWorker(64)
    w.note(np.asarray([3, 5], np.int64), np.asarray([4, 1], np.int64),
           np.asarray([True, True]))
    plan = None
    for _ in range(200):
        plan = w.poll_plan()
        if plan is not None:
            break
        time.sleep(0.01)
    assert plan is not None and set(plan["promote"]) == {3, 5}
    assert w.close()
    assert not {t.ident for t in threading.enumerate()} - before


class _Rows:
    def __init__(self):
        self.rows = []

    def log(self, kind, row):
        self.rows.append((kind, row))


def test_dead_promoter_restarts_once_then_freezes(monkeypatch, toy_dataset):
    """A promotion worker that dies is restarted once with a
    ``store_promote_restarted`` health row; a second death freezes
    placement with ``store_promote_dead`` and training goes on."""
    def die(self):
        raise RuntimeError("injected")

    cfg = Config(**_geometry(train_path=toy_dataset.train_prefix))
    step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU, obs=Obs())
    sink = _Rows()
    step.obs.metrics_logger = sink
    store = step.store
    state = store.init_device_state()
    monkeypatch.setattr(promote.PromotionWorker, "_run_inner", die)
    data = open(toy_dataset.train_prefix + "-00000", "rb").read()
    block = parse_block(data, cfg.table_size, True, 0)
    for i in range(3):
        step.train(state, step.put_batch(pack_batch(block, i * B, (i + 1) * B, B, K)))
        for _ in range(200):
            if not store.promoter.alive():
                break
            time.sleep(0.01)
        state = store.maintain(state, obs=step.obs)
    causes = [r["cause"] for kind, r in sink.rows if kind == "health"]
    assert causes == ["store_promote_restarted", "store_promote_dead"]
    assert store._promoter_dead and store.hot.occupancy == 0
    assert state["step"] == 3
    store.close()


# -- one tiered step, every family and mode ----------------------------------


FAMILIES = {
    "lr": {}, "fm": {}, "mvm": {"max_fields": 10}, "ffm": {"max_fields": 10},
    "wide_deep": {"max_fields": 10}, "dcn": {"max_fields": 10},
    "two_tower": {"max_fields": 10, "tower_split_field": 5},
}
CASES = [(f, m, "ftrl") for f in FAMILIES for m in ("dense", "sparse")] + [
    ("fm", m, "sgd") for m in ("dense", "sparse")]


def _batches(toy_dataset, cfg, n):
    data = open(toy_dataset.train_prefix + "-00001", "rb").read()
    block = parse_block(data, cfg.table_size, True, cfg.seed)
    return [pack_batch(block, i * B, (i + 1) * B, B, K) for i in range(n)]


@pytest.mark.parametrize("family, mode, optimizer", CASES,
                         ids=[f"{f}-{m}-{o}" for f, m, o in CASES])
def test_one_tiered_step_matches_reference(toy_dataset, family, mode, optimizer):
    """Batch 1 through an empty tier (every key a miss, written back
    cold), then half of its keys promoted by hand in both packages (the
    same slots: the maps are the reference's), then batch 2 over a tier
    that holds some of its keys: the port's logical rows of every
    touched key, every plane, and both steps' log-losses match the JAX
    package's."""
    kw = _geometry(model=family, update_mode=mode, optimizer=optimizer, sgd_lr=0.05,
                   **FAMILIES[family])
    rcfg, cfg = RefConfig(**kw), Config(**kw)
    ref = RefTrainStep(ref_make_model(rcfg), ref_make_optimizer(rcfg), rcfg, make_mesh(1))
    ours = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    assert ours.wire_format == ref.wire_format == "tiered"
    rstate = ref.store.init_device_state()
    state = ours.store.init_device_state()
    for name, arr in rstate["dense"].items():  # the same dense parameters
        state["dense"][name] = torch.tensor(np.asarray(arr))
    b1, b2 = _batches(toy_dataset, cfg, 2)
    touched = np.unique(np.concatenate([b.keys[b.mask > 0] for b in (b1, b2)])).astype(
        np.int64)
    losses = []
    for i, batch in enumerate((b1, b2)):
        rbatch = RefBatch(**{f: getattr(batch, f) for f in (
            "keys", "slots", "vals", "mask", "labels", "weights")})
        rstate, rm = ref.dispatch_train(rstate, ref.put_batch(rbatch))
        m = ours.train(state, ours.put_batch(batch))
        losses.append((float(m["logloss"]), float(rm["logloss"])))
        ref.store.complete_pending()
        ours.store.complete_pending()
        if i == 0:
            promote_keys = [int(k) for k in np.unique(b1.keys[b1.mask > 0])[::2]]
            rstate = ref.store._promote(rstate, promote_keys)
            state = ours.store._promote(state, promote_keys)
            assert ours.store.hot.slot_of == ref.store.hot.slot_of
    assert ours.store.hot.occupancy > 0 and len(ours.store.cold) > 0
    assert state["step"] == int(rstate["step"]) == 2
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=RTOL)
    for table in ours.store.cold.tables:
        got = ours.store.logical_rows(state, table, touched)
        want = ref.store.logical_rows(rstate, table, touched)
        assert set(got) == set(want)
        for plane in want:
            np.testing.assert_allclose(got[plane], want[plane], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{table}.{plane}")
    for name, arr in rstate["dense"].items():
        np.testing.assert_allclose(state["dense"][name].numpy(), np.asarray(arr),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    ours.store.close()
    ref.store.close()


def test_tiered_predict_matches_reference(toy_dataset):
    """A predict plan ships the param plane alone and scores over the
    combined rows: pctr equal to the JAX tiered predict."""
    kw = _geometry(model="fm")
    rcfg, cfg = RefConfig(**kw), Config(**kw)
    ref = RefTrainStep(ref_make_model(rcfg), ref_make_optimizer(rcfg), rcfg, make_mesh(1))
    ours = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    rstate, state = ref.store.init_device_state(), ours.store.init_device_state()
    b1, b2 = _batches(toy_dataset, cfg, 2)
    rstate, _ = ref.dispatch_train(rstate, ref.put_batch(RefBatch(**{f: getattr(b1, f) for f in (
        "keys", "slots", "vals", "mask", "labels", "weights")})))
    ours.train(state, ours.put_batch(b1))
    arrays = ours.put_batch(b2, predict=True)
    assert set(arrays["miss"]["v"]) == {"param"}
    got = ours.predict(state, arrays).numpy()
    rb2 = RefBatch(**{f: getattr(b2, f) for f in ("keys", "slots", "vals", "mask", "labels",
                                                  "weights")})
    want = np.asarray(ref.predict(rstate, ref.put_batch(rb2, predict=True)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(RuntimeError, match="predict-staged"):
        ours.train(state, arrays)
    ours.store.close()
    ref.store.close()


def test_a_batch_wider_than_the_geometry_grows_the_buffers(toy_dataset):
    """A batch of more rows than ``batch_size`` carries more misses than
    the combined buffers were sized for: they grow, the hot rows move
    with them, the state follows, and the step still matches the JAX
    package's (whose concatenation takes any width)."""
    kw = _geometry(model="fm", hot_capacity_log2=6)
    rcfg, cfg = RefConfig(**kw), Config(**kw)
    ref = RefTrainStep(ref_make_model(rcfg), ref_make_optimizer(rcfg), rcfg, make_mesh(1))
    ours = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    rstate, state = ref.store.init_device_state(), ours.store.init_device_state()
    data = open(toy_dataset.train_prefix + "-00002", "rb").read()
    small = pack_batch(parse_block(data, cfg.table_size, True, cfg.seed), 0, B, B, K)
    rng = np.random.default_rng(5)  # 128 rows of distinct keys: ~3,000 misses
    wide = Batch(keys=rng.integers(0, cfg.table_size, (2 * B, K)).astype(np.int32),
                 slots=np.zeros((2 * B, K), np.int32), vals=np.ones((2 * B, K), np.float32),
                 mask=(rng.random((2 * B, K)) < 0.9).astype(np.float32),
                 labels=(rng.random(2 * B) < 0.3).astype(np.float32),
                 weights=np.ones(2 * B, np.float32))
    for batch in (small, wide):
        rbatch = RefBatch(**{f: getattr(batch, f) for f in (
            "keys", "slots", "vals", "mask", "labels", "weights")})
        rstate, _ = ref.dispatch_train(rstate, ref.put_batch(rbatch))
        ours.train(state, ours.put_batch(batch))
        ref.store.complete_pending()
        ours.store.complete_pending()
        if batch is small:
            keys = [int(k) for k in np.unique(small.keys[small.mask > 0])[:40]]
            rstate = ref.store._promote(rstate, keys)
            state = ours.store._promote(state, keys)
            rows = ours.store.hot.bufs["v"]["param"].shape[0]
    assert ours.store.hot.bufs["v"]["param"].shape[0] > rows
    touched = np.unique(np.concatenate([b.keys[b.mask > 0] for b in (small, wide)]))
    for table in ("w", "v"):
        got = ours.store.logical_rows(state, table, touched.astype(np.int64))
        want = ref.store.logical_rows(rstate, table, touched.astype(np.int64))
        for plane in want:
            np.testing.assert_allclose(got[plane], want[plane], rtol=RTOL, atol=ATOL)
    ours.store.close()
    ref.store.close()
