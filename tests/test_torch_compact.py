"""The port's host compaction (xflow_tpu_torch/io/compact.py) against
the reference's (the cases of tests/test_compact.py:54-300): the native
and numpy dictionary encoders select the same SET; plane_cap buckets as
the reference's; every CompactBatch.wire plane (hot tiers included) is
byte-equal to the reference's for the same Batch, like against like —
the port's native encoder against the reference's native encoder, the
port's numpy encoder against the reference's numpy encoder, since the
two encoders order the dictionary differently; expand round-trips;
the refusals match."""

import numpy as np
import pytest

import xflow_tpu.native as ref_native
from xflow_tpu.io import compact as ref_compact
from xflow_tpu.io.batch import make_batch as ref_make_batch
from xflow_tpu_torch import native
from xflow_tpu_torch.io.batch import Batch
from xflow_tpu_torch.io.compact import (
    DICT_CAP,
    compact_batch,
    dedup_select,
    dedup_select_numpy,
    plane_cap,
)
from xflow_tpu_torch.io.loader import ShardLoader

T = 1 << 14
PLANES = ("cu", "ci", "ct", "cf", "cc", "h8", "hx", "hxh", "hf", "hc",
          "lb", "wb", "cs", "hs")
BATCH_FIELDS = ("keys", "slots", "vals", "mask", "labels", "weights",
                "hot_keys", "hot_slots", "hot_vals", "hot_mask")


def _decode(keys, uniq, codes):
    m = codes != 0xFFFFFFFF
    got = keys.copy()
    got[m] = uniq[codes[m].astype(np.int64)]
    return got, m


def _port_batch(ref_batch) -> Batch:
    return Batch(**{f: getattr(ref_batch, f) for f in BATCH_FIELDS})


def _batches_equal(a, b):
    for f in BATCH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("dist", ["random", "zipf"])
def test_dedup_select_native_numpy_parity(dist):
    rng = np.random.default_rng(3)
    if dist == "random":
        keys = rng.integers(0, 1 << 22, 40000).astype(np.int64)
    else:
        keys = (rng.zipf(1.3, 40000) - 1).astype(np.int64)
    for cap in (64, 1024, DICT_CAP):
        u_np, c_np = dedup_select_numpy(keys, cap)
        assert len(u_np) <= cap
        d_np, m_np = _decode(keys, u_np, c_np)
        np.testing.assert_array_equal(d_np, keys)
        u_nat, c_nat = dedup_select(keys, cap)  # native: the library builds here
        assert set(u_nat.tolist()) == set(u_np.tolist())
        d_nat, m_nat = _decode(keys, u_nat, c_nat)
        np.testing.assert_array_equal(d_nat, keys)
        np.testing.assert_array_equal(m_nat, m_np)
        # like against like: each byte-equal to the reference's
        ref_u, ref_c = ref_native.native_dict_encode(keys, cap)
        assert u_nat.tobytes() == ref_u.tobytes() and c_nat.tobytes() == ref_c.tobytes()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref_native, "has_dict_encode", lambda: False)
            ref_u, ref_c = ref_compact.dedup_select(keys, cap)
        assert u_np.tobytes() == ref_u.tobytes() and c_np.tobytes() == ref_c.tobytes()


def test_dedup_select_small_threshold_and_pathological_cap():
    keys = np.asarray([5, 5, 9, 5, 9, 7], np.int64)
    uniq, codes = dedup_select_numpy(keys, DICT_CAP)
    assert sorted(uniq.tolist()) == [5, 7, 9] and (codes != 0xFFFFFFFF).all()
    rng = np.random.default_rng(0)
    keys = np.concatenate([np.repeat(np.arange(10, dtype=np.int64), 50),
                           rng.integers(1000, 1 << 30, 500).astype(np.int64)])
    rng.shuffle(keys)
    for fn in (dedup_select, dedup_select_numpy):
        uniq, codes = fn(keys, 16)
        assert set(range(10)) <= set(uniq.tolist()) and len(uniq) <= 16
        got, covered = _decode(keys, uniq, codes)
        np.testing.assert_array_equal(got, keys)
        assert covered.sum() >= 500
    keys = np.repeat(np.arange(9, dtype=np.int64), 6)  # 9 keys x 6 > cap 4
    for fn in (dedup_select, dedup_select_numpy):
        uniq, codes = fn(keys, 4)
        assert len(uniq) <= 4
        np.testing.assert_array_equal(_decode(keys, uniq, codes)[0], keys)


def test_plane_cap_bucketing_matches_reference():
    slots = 131072 * 16
    g = max(256, slots // 32)
    for n in (0, 1, g, g + 1, g + 5, g + g // 2, slots - 1, slots, 17, 300):
        assert plane_cap(n, slots) == ref_compact.plane_cap(n, slots)
        assert plane_cap(n, 1000, 4, 16) == ref_compact.plane_cap(n, 1000, 4, 16)
    assert plane_cap(g + 1, slots) == 2 * g and plane_cap(slots - 1, slots) == slots


def _random_ref_batch(seed, b=61, k=24, t_log2=14, hot=None):
    """A seed-made reference Batch, left-compacted rows, keys with a
    duplicated head; ``hot`` = (hot_size, hot_nnz) steers a hot section
    (split_hot)."""
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, k + 1, b)
    mask = (np.arange(k)[None, :] < cnt[:, None]).astype(np.float32)
    keys = rng.integers(0, 1 << t_log2, (b, k))
    keys = np.where(rng.random((b, k)) < 0.5, rng.integers(0, 600, (b, k)), keys)
    keys = np.where(mask > 0, keys, 0).astype(np.int32)
    slots = np.where(mask > 0, rng.integers(0, 300, (b, k)), 0).astype(np.int32)
    weights = (np.arange(b) < b - 3).astype(np.float32)
    labels = (rng.random(b) < 0.4).astype(np.float32) * weights
    hs, hn = hot if hot else (0, 0)
    return ref_make_batch(keys, slots, mask.copy(), mask, labels, weights, hs, hn)


@pytest.mark.parametrize("encoder", ["native", "numpy"])
@pytest.mark.parametrize("case", ["u24", "u32", "hot-u12", "hot-u16", "all-padding"])
def test_wire_planes_byte_equal_to_reference(case, encoder, monkeypatch):
    t_log2 = 25 if case == "u32" else 14
    hot = {"hot-u12": (1 << 10, 6), "hot-u16": (1 << 14, 6)}.get(case)
    ref_batch = _random_ref_batch(7, t_log2=t_log2, hot=hot)
    if case == "all-padding":
        for f in ("mask", "vals", "keys", "slots", "weights", "labels"):
            getattr(ref_batch, f)[...] = 0
    if encoder == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(ref_native, "has_dict_encode", lambda: False)
    hot_size = hot[0] if hot else 0
    ours = compact_batch(_port_batch(ref_batch), 1 << t_log2, hot_size)
    ref = ref_compact.compact_batch(ref_batch, 1 << t_log2, hot_size)
    assert ours.key_bytes == ref.key_bytes == (4 if case == "u32" else 3)
    for f in PLANES:
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    for ship_slots in (False, True):
        wa, wb = ours.wire(ship_slots), ref.wire(ship_slots)
        assert list(wa) == list(wb)
        for name in wa:
            assert wa[name].dtype == wb[name].dtype and wa[name].tobytes() == wb[name].tobytes()
        assert ours.wire_nbytes(ship_slots) == ref.wire_nbytes(ship_slots)
    assert ours.cold_touched == ref.cold_touched
    assert np.array_equal(ours.touched_rows(), ref.touched_rows())
    _batches_equal(ours.expand(), ref.expand())
    _batches_equal(ours.expand(), _port_batch(ref_batch))


def test_compact_roundtrip_loader_batches(toy_dataset):
    loader = ShardLoader(toy_dataset.train_prefix + "-00000", batch_size=64, max_nnz=24,
                         table_size=T)
    n = 0
    for batch, _ in loader.iter_batches():
        cb = compact_batch(batch, T, 0)
        _batches_equal(batch, cb.expand())
        assert cb.num_real() == batch.num_real()
        np.testing.assert_array_equal(cb.labels, batch.labels)
        np.testing.assert_array_equal(cb.weights, batch.weights)
        again = compact_batch(cb.expand(), T, 0)  # the packed-v2 fixed point
        for f in PLANES:
            np.testing.assert_array_equal(getattr(cb, f), getattr(again, f), err_msg=f)
        n += 1
    assert n > 2


def test_compact_refusals_match_reference():
    def both(keys, vals, mask, labels, weights, **kw):
        outcomes = []
        for mk, fn in ((lambda *a: Batch(*a), compact_batch),
                       (ref_make_batch, ref_compact.compact_batch)):
            batch = mk(np.asarray(keys, np.int32), np.zeros_like(np.asarray(keys, np.int32)),
                       np.asarray(vals, np.float32), np.asarray(mask, np.float32),
                       np.asarray(labels, np.float32), np.asarray(weights, np.float32))
            try:
                fn(batch, T, 0, **kw)
                outcomes.append(None)
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1]
        return outcomes[0]

    assert "binary features" in both([[0, 0, 0], [0, 0, 0]], [[0.5, 1, 1], [1, 1, 1]],
                                     np.ones((2, 3)), [0, 0], [1, 1])
    assert "0/1 labels" in both([[1, 2]], [[1, 1]], [[1, 1]], [0.5], [1])
    assert "table_size" in both([[3, 40000]], [[1, 1]], [[1, 1]], [0], [1])
    assert "left-compacted" in both([[3, 0, 5]], [[1, 0, 1]], [[1, 0, 1]], [0], [1],
                                    strict_layout=True)
    # holey rows ride the wire, re-compacted leftward
    assert both([[3, 0, 5]], [[1, 0, 1]], [[1, 0, 1]], [0], [1]) is None
    eb = compact_batch(Batch(np.asarray([[3, 0, 5]], np.int32), np.zeros((1, 3), np.int32),
                             np.asarray([[1, 0, 1]], np.float32),
                             np.asarray([[1, 0, 1]], np.float32),
                             np.zeros(1, np.float32), np.ones(1, np.float32)), T, 0).expand()
    np.testing.assert_array_equal(eb.keys, [[3, 5, 0]])
    np.testing.assert_array_equal(eb.mask, [[1, 1, 0]])
