"""The dictionary wire in the port, on the CPU, against the reference:

* K6's plain version (ops/wire.py::dict_decode_plain, the CPU path of
  ``dict_decode``) against the reference's
  ``TrainStep._expand_dict_wire`` called eagerly on the same numpy
  planes: keys under the mask, the mask, labels and weights exactly
  equal, for u24 and u32 keys, an empty dictionary, no tail, all
  padding, and a B that is not a multiple of 8; and at the shapes K6's
  scan tiles make hard (one row past a 4,096-row tile, a bitmap that
  is not whole words with a row straddling a 1,024-word tile, all tail
  over two tiles, a u12 hot tier whose bitmap spans two tiles);
* one train step over the dictionary wire against the JAX TrainStep
  with ``wire_dedup="on"``, for LR and FM x FTRL and SGD x dense,
  sparse and sequential (sparse inner), at the bar of
  tests/test_compact.py:317-359 (rtol 1e-5 / atol 1e-6), and bit-equal
  to the port's own compact-wire step (the decoded planes are the
  compact wire's, and the CPU kernels' plain versions are
  deterministic);
* eligibility: the port's ``check_trainable`` / ``TrainStep.dict_wire``
  against the reference's TrainStep on the cases of
  tests/test_compact.py:362-391;
* K2's plain index mode fed the reference decode's ``cold_uidx``
  against the reference's ``consolidate_indexed`` (the port runs dense
  ``cold_consolidate`` as the plain dense step, so nothing on its path
  calls it; ROADMAP B5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.io import compact as ref_compact
from xflow_tpu.io.batch import make_batch as ref_make_batch
from xflow_tpu.models import make_model as ref_make_model
from xflow_tpu.ops.sparse import consolidate_indexed
from xflow_tpu.optim import make_optimizer as ref_make_optimizer
from xflow_tpu.parallel.mesh import make_mesh
from xflow_tpu.parallel.step import TrainStep as RefTrainStep
from xflow_tpu.parallel.step import init_state as ref_init_state
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import state_from_numpy, state_to_numpy
from xflow_tpu_torch.io.batch import Batch
from xflow_tpu_torch.io.compact import CompactBatch
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.ops.train import train_step
from xflow_tpu_torch.ops.wire import dict_decode, dict_decode_plain, to_device
from xflow_tpu_torch.optim import make_optimizer
from xflow_tpu_torch.parallel.step import TrainStep, check_trainable

RTOL, ATOL = 1e-5, 1e-6
CPU = torch.device("cpu")


def _raw(seed, b, k, t_log2, unique=False, padding=False, full=False):
    """Seed-made left-compacted planes: keys with a duplicated head (or
    all distinct), binary features, 0/1 labels, the last 3 examples
    padding; ``full`` rows hold all k entries."""
    rng = np.random.default_rng(seed)
    cnt = np.zeros(b, int) if padding else rng.integers(0, k + 1, b)
    if full:
        cnt[:] = k
    mask = (np.arange(k)[None, :] < cnt[:, None]).astype(np.float32)
    if unique:
        keys = rng.permutation(1 << t_log2)[: b * k].reshape(b, k)
    else:
        keys = rng.integers(0, 1 << t_log2, (b, k))
        keys = np.where(rng.random((b, k)) < 0.5, rng.integers(0, 50, (b, k)), keys)
    keys = np.where(mask > 0, keys, 0).astype(np.int32)
    weights = (np.arange(b) < b - 3).astype(np.float32)
    labels = (rng.random(b) < 0.4).astype(np.float32) * weights
    return keys, np.zeros_like(keys), mask.copy(), mask, labels, weights


def _ref_step(**kw):
    cfg = RefConfig(num_devices=1, wire_dedup="on", **kw)
    return RefTrainStep(ref_make_model(cfg), ref_make_optimizer(cfg), cfg, make_mesh(1))


DECODE_CASES = {
    "u24": dict(b=61, k=24, t_log2=14),
    "u32": dict(b=61, k=24, t_log2=25),
    "empty-dictionary": dict(b=40, k=8, t_log2=14, unique=True, dict_cap=16),
    "no-tail": dict(b=16, k=8, t_log2=14),
    "all-padding": dict(b=13, k=8, t_log2=14, padding=True),
    # K6 scans in tiles of 4,096 rows of counts and 1,024 flag words
    # (32,768 entries): one row past a row tile, with two word tiles
    "row-tile-plus-one": dict(b=4097, k=24, t_log2=14),
    # full rows: the bitmap's 4,610 bytes are not whole words, and row
    # 3,640 (entries 32,760-32,768) straddles the first word tile's end
    "straddling-row": dict(b=4097, k=9, t_log2=14, full=True),
    # all tail (no dictionary) over two row tiles
    "all-tail-two-tiles": dict(b=4100, k=8, t_log2=16, unique=True, dict_cap=16),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_plain_decode_equals_reference_expand(case):
    kw = dict(DECODE_CASES[case])
    dict_cap = kw.pop("dict_cap", ref_compact.DICT_CAP)
    raw = _raw(3, **kw)
    cb = ref_compact.compact_batch(ref_make_batch(*raw), 1 << kw["t_log2"], 0,
                                   dict_cap=dict_cap)
    if case in ("empty-dictionary", "all-tail-two-tiles"):
        assert cb.n_dict == 0 and cb.n_cold > 0
    if case == "straddling-row":
        assert cb.cf.shape[0] % 4 != 0 and cb.n_cold > 32768 and 32768 % kw["k"] != 0
    if case == "no-tail":
        assert cb.n_dict_occ == cb.n_cold > 0
    if case == "u32":
        assert cb.key_bytes == 4
    wire = cb.wire(ship_slots=False)
    step = _ref_step(model="lr", batch_size=kw["b"], max_nnz=kw["k"],
                     table_size_log2=kw["t_log2"])
    want = step._expand_dict_wire({n: jnp.asarray(a) for n, a in wire.items()})
    ckeys, labels, weights = dict_decode(to_device(wire, CPU), kw["k"])
    assert ckeys.dtype == torch.int32 and ckeys.shape == (kw["b"], kw["k"])
    mask = np.asarray(want["mask"]) > 0
    np.testing.assert_array_equal(ckeys.numpy() >= 0, mask)
    np.testing.assert_array_equal(ckeys.numpy()[mask], np.asarray(want["keys"])[mask])
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want["labels"]))
    np.testing.assert_array_equal(weights.numpy(), np.asarray(want["weights"]))
    np.testing.assert_array_equal(ckeys.numpy(), np.where(raw[3] > 0, raw[0], -1))
    # dict_decode on CPU tensors is the plain version, with no launch
    before = dict_decode.launches
    again = dict_decode_plain(to_device(wire, CPU), kw["k"])
    assert dict_decode.launches == before and torch.equal(again[0], ckeys)


# (table_size_log2, hot_size_log2, hot_nnz, hot share): a u12 hot tier
# (H = 2^12) over 4,097 rows, whose hot bitmap spans two of K6's word
# tiles
HOT_DECODE_CASES = {"u12-hot-tier-two-tiles": (14, 12, 12, 0.9)}


@pytest.mark.parametrize("case", list(HOT_DECODE_CASES))
def test_plain_hot_decode_equals_reference_expand(case):
    t_log2, h_log2, kh, share = HOT_DECODE_CASES[case]
    t, h = 1 << t_log2, 1 << h_log2
    rng = np.random.default_rng(8)
    b, ktot = 4097, 24
    keys = rng.integers(h, t, (b, ktot))
    hot_keys = np.where(rng.random((b, ktot)) < 0.5, rng.integers(0, 256, (b, ktot)),
                        rng.integers(256, h, (b, ktot)))
    keys = np.where(rng.random((b, ktot)) < share, hot_keys, keys).astype(np.int32)
    cnt = rng.integers(0, ktot + 1, b)
    mask = (np.arange(ktot)[None, :] < cnt[:, None]).astype(np.float32)
    keys = np.where(mask > 0, keys, 0).astype(np.int32)
    weights = (np.arange(b) < b - 3).astype(np.float32)
    labels = (rng.random(b) < 0.4).astype(np.float32) * weights
    batch = ref_make_batch(keys, np.zeros_like(keys), mask.copy(), mask, labels, weights, h, kh)
    cb = ref_compact.compact_batch(batch, t, h)
    assert not cb.hx16 and cb.n_h8 > 0 and cb.n_hot > 32768
    wire = cb.wire(ship_slots=False)
    step = _ref_step(model="lr", batch_size=b, max_nnz=ktot - kh, hot_size_log2=h_log2,
                     hot_nnz=kh, table_size_log2=t_log2)
    want = step._expand_dict_wire({n: jnp.asarray(a) for n, a in wire.items()})
    ckeys, labels_u8, weights_u8, hot = dict_decode(to_device(wire, CPU), ktot - kh, kh)
    hmask = np.asarray(want["hot_mask"]) > 0
    np.testing.assert_array_equal(hot.numpy(), np.where(hmask, np.asarray(want["hot_keys"]), -1))
    np.testing.assert_array_equal(hot.numpy(), np.where(batch.hot_mask > 0, batch.hot_keys, -1))
    mask = np.asarray(want["mask"]) > 0
    np.testing.assert_array_equal(ckeys.numpy() >= 0, mask)
    np.testing.assert_array_equal(ckeys.numpy()[mask], np.asarray(want["keys"])[mask])
    np.testing.assert_array_equal(labels_u8.numpy(), np.asarray(want["labels"]))
    np.testing.assert_array_equal(weights_u8.numpy(), np.asarray(want["weights"]))


MODES = {
    "dense": {},
    "sparse": dict(update_mode="sparse"),
    "seq-sparse": dict(update_mode="sequential", microbatch=4, sequential_inner="sparse"),
}
B, K, T_LOG2 = 64, 8, 10


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("optimizer", ["ftrl", "sgd"])
@pytest.mark.parametrize("model", ["lr", "fm"])
def test_dict_wire_step_matches_reference(model, optimizer, mode):
    kw = dict(model=model, optimizer=optimizer, table_size_log2=T_LOG2, max_nnz=K,
              batch_size=B, v_dim=4, sgd_lr=0.05, **MODES[mode])
    raws = [_raw(seed, B, K, T_LOG2) for seed in (11, 12)]
    ref = _ref_step(**kw)
    assert ref.dict_wire
    ref_state = ref_init_state(ref.model, ref.optimizer, ref.cfg, make_mesh(1))
    start = {n: {k: np.asarray(a).copy() for k, a in t.items()}
             for n, t in ref_state["tables"].items()}
    ref_ll = []
    for raw in raws:
        ref_state, m = ref.train(ref_state, ref.put_batch(ref_make_batch(*raw)))
        ref_ll.append(float(m["logloss"]))
    want = {n: {k: np.asarray(a) for k, a in t.items()}
            for n, t in jax.device_get(ref_state["tables"]).items()}

    results = {}
    for dedup in ("on", "off"):
        cfg = Config(wire_dedup=dedup, num_devices=1, **kw)
        step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
        assert step.wire_format == ("dict" if dedup == "on" else "compact")
        state = state_from_numpy(cfg, start, "cpu")
        ll = [float(step.train(state, step.put_batch(Batch(*raw)))["logloss"])
              for raw in raws]
        results[dedup] = (state_to_numpy(state, aux=True), ll)
    got, ll = results["on"]
    np.testing.assert_allclose(ll, ref_ll, rtol=RTOL, atol=ATOL)
    for name in want:
        for key in want[name]:
            np.testing.assert_allclose(got[name][key], want[name][key], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name}.{key}")
    compact, compact_ll = results["off"]
    assert ll == compact_ll
    for name in got:
        for key in got[name]:
            assert np.array_equal(got[name][key], compact[name][key]), f"{name}.{key}"


@pytest.mark.parametrize("kw", [
    {},
    {"hash_mode": False},
    {"max_nnz": 300},
    {"wire_dedup": "off"},
    {"wire_mode": "full"},
    {"model": "fm", "update_mode": "sparse"},
    {"wire_dedup": "on", "hash_mode": False},
    {"wire_dedup": "on", "max_nnz": 300},
    {"wire_dedup": "on", "wire_mode": "full"},
    {"num_devices": 0},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_eligibility_matches_reference(kw):
    kw = {"model": "lr", "batch_size": 64, "table_size_log2": 14, "num_devices": 1, **kw}

    def outcome(build):
        try:
            return build().dict_wire
        except ValueError as e:
            return str(e)

    def ours():
        cfg = Config(**kw)
        check_trainable(cfg)
        return TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)

    def ref():
        cfg = RefConfig(**kw)
        return RefTrainStep(ref_make_model(cfg), ref_make_optimizer(cfg), cfg, make_mesh(1))

    assert outcome(ours) == outcome(ref)


def test_two_devices_refused_where_the_reference_drops_the_dict_wire():
    cfg = RefConfig(model="lr", batch_size=64, table_size_log2=14, num_devices=2)
    step = RefTrainStep(ref_make_model(cfg), ref_make_optimizer(cfg), cfg, make_mesh(2))
    assert not step.dict_wire
    with pytest.raises(NotImplementedError, match="A13"):
        check_trainable(Config.from_json(cfg.to_json()))


@pytest.mark.parametrize("model", ["lr", "fm"])
def test_k2_index_mode_over_cold_uidx_matches_consolidate_indexed(model):
    """The port's counterpart of ``consolidate_indexed``: K2's index
    mode with the host-given slots ``cold_uidx`` (the dictionary slot,
    or cap_d for tail and padding occurrences) sums the same
    per-occurrence gradients into the dictionary's slots."""
    b, k, t_log2, d = 64, 8, 10, 4
    raw = _raw(5, b, k, t_log2)
    cb = ref_compact.compact_batch(ref_make_batch(*raw), 1 << t_log2, 0, dict_cap=16)
    assert 0 < cb.n_dict_occ < cb.n_cold
    step = _ref_step(model=model, batch_size=b, max_nnz=k, table_size_log2=t_log2,
                     cold_consolidate=True)
    plan = step._expand_dict_wire({n: jnp.asarray(a) for n, a in cb.wire(False).items()})
    uidx = np.asarray(plan["cold_uidx"]).astype(np.int32)
    cap_d = int(np.asarray(plan["cold_dict_keys"]).shape[0])
    rng = np.random.default_rng(6)
    w = torch.tensor(rng.normal(0, 0.5, (1 << t_log2, 1)).astype(np.float32))
    v = torch.tensor(rng.normal(0, 0.3, (1 << t_log2, d)).astype(np.float32)) \
        if model == "fm" else None
    keys = torch.tensor(np.where(raw[3] > 0, raw[0], -1).astype(np.int32))
    labels = torch.tensor(raw[4].astype(np.uint8))
    weights = torch.tensor(raw[5].astype(np.uint8))
    m = b * k

    def run(slots):
        g_w = torch.zeros((m, 1))
        g_v = torch.zeros((m, d)) if v is not None else None
        train_step(keys, None, labels, weights, float(raw[5].sum()), w, v, g_w, g_v,
                   torch.zeros(2, dtype=torch.float64), slots=slots)
        return g_w, g_v

    # per-occurrence gradients: every occurrence in its own slot
    occ = run(torch.arange(m, dtype=torch.int32).view(b, k))
    summed = run(torch.tensor(uidx))
    for got, per_occ in zip(summed, occ):
        if got is None:
            continue
        want = np.asarray(consolidate_indexed(jnp.asarray(per_occ.numpy()),
                                              jnp.asarray(uidx.reshape(-1)), cap_d))
        np.testing.assert_allclose(got[:cap_d].numpy(), want, rtol=RTOL, atol=ATOL)


def test_precompact_ships_the_inline_planes():
    """``precompact`` builds, off the consumer thread, the CompactBatch
    that ``put_batch`` would build inline: the shipped planes and the
    wire counters are the same; a batch off the loader's geometry stays
    a Batch."""
    cfg = Config(model="lr", batch_size=B, max_nnz=K, table_size_log2=T_LOG2,
                 num_devices=1)
    batch = Batch(*_raw(21, B, K, T_LOG2))
    shipped, counters = [], []
    for pre in (False, True):
        step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
        item = step.precompact(batch) if pre else batch
        assert isinstance(item, CompactBatch) == pre
        shipped.append(step.put_batch(item))
        counters.append(step.obs.registry.snapshot().counters)
    for name in ("ckeys", "labels_u8", "weights_u8"):
        assert torch.equal(shipped[0][name], shipped[1][name])
    assert shipped[0]["num_real"] == shipped[1]["num_real"]
    for key in ("wire.bytes", "wire.examples", "wire.cold_occ", "wire.cold_touched"):
        assert counters[0][key] == counters[1][key]
    wide = Batch(*_raw(22, B, K + 1, T_LOG2))
    step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    assert step.precompact(wide) is wide
