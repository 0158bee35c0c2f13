"""The port's ops/sparse.py on the CPU against the reference's
xflow_tpu/ops/sparse.py, from the same numpy inputs: the six plain
functions (integer outputs exactly equal, gradient sums within rtol
1e-5 / atol 1e-6: the port sums in another order than XLA's
segment_sum), the cases of tests/test_sparse.py, a Zipf case, and the
plain versions behind the K4 and K5 wrappers (consolidate_keys,
touched_update), which the CPU path of the sparse update modes runs.
The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xflow_tpu.ops import sparse as ref
from xflow_tpu.optim import FTRL as RefFTRL
from xflow_tpu.optim import SGD as RefSGD
from xflow_tpu_torch.ops import sparse as ours
from xflow_tpu_torch.optim import FTRL, SGD

TABLE = 64
RTOL, ATOL = 1e-5, 1e-6


def _keys(dist, m=512, pad=0.2, seed=0):
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        keys = rng.integers(0, TABLE, m)
    elif dist == "zipf":
        keys = np.minimum(rng.zipf(1.3, m) - 1, TABLE - 1)
    elif dist == "single":
        keys = np.full(m, 7)
    else:  # all padding
        keys = np.full(m, TABLE)
    keys = keys.astype(np.int32)
    keys[rng.random(m) < pad] = TABLE
    grads = rng.normal(size=(m, 3)).astype(np.float32)
    grads[keys == TABLE] = 0.0
    return keys, grads


DISTS = ["uniform", "zipf", "single", "padding"]


@pytest.mark.parametrize("dist", DISTS)
def test_plan_and_apply_match_reference(dist):
    keys, grads = _keys(dist)
    r_order, r_seg, r_ukeys = ref.consolidate_plan(jnp.asarray(keys), TABLE)
    order, seg, ukeys = ours.consolidate_plan(torch.tensor(keys), TABLE)
    np.testing.assert_array_equal(order.numpy(), np.asarray(r_order))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(r_seg))
    np.testing.assert_array_equal(ukeys.numpy(), np.asarray(r_ukeys))
    assert ukeys.dtype == torch.int32
    want = np.asarray(ref.consolidate_apply(jnp.asarray(grads), r_order, r_seg))
    got = ours.consolidate_apply(torch.tensor(grads), order, seg).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    r_uk, r_gsum = ref.consolidate(jnp.asarray(keys), jnp.asarray(grads), TABLE)
    uk, gsum = ours.consolidate(torch.tensor(keys), torch.tensor(grads), TABLE)
    np.testing.assert_array_equal(uk.numpy(), np.asarray(r_uk))
    np.testing.assert_allclose(gsum.numpy(), np.asarray(r_gsum), rtol=RTOL, atol=ATOL)
    # tests/test_sparse.py's invariants: each live key once, sentinel
    # slots carry g = 0
    live = uk.numpy() < TABLE
    assert sorted(uk.numpy()[live]) == sorted(set(keys[keys < TABLE].tolist()))
    assert not gsum.numpy()[~live].any()
    if dist == "single":
        assert live.sum() == 1
        np.testing.assert_allclose(gsum.numpy()[0], grads[keys < TABLE].sum(0), rtol=RTOL)


def test_consolidate_indexed_matches_reference():
    rng = np.random.default_rng(4)
    m, slots = 300, 40
    grads = rng.normal(size=(m, 2)).astype(np.float32)
    uidx = rng.integers(0, slots + 1, m).astype(np.int32)  # slots = dump slot
    want = ref.consolidate_indexed(jnp.asarray(grads), jnp.asarray(uidx), slots)
    got = ours.consolidate_indexed(torch.tensor(grads), torch.tensor(uidx), slots)
    assert got.shape == (slots, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_gather_scatter_sentinel_dropped():
    table = np.arange(TABLE, dtype=np.float32)[:, None]
    ukeys = np.asarray([3, TABLE, 5], np.int32)
    r_rows = ref.gather_rows(jnp.asarray(table), jnp.asarray(ukeys))
    rows = ours.gather_rows(torch.tensor(table), torch.tensor(ukeys))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(r_rows))
    np.testing.assert_array_equal(rows.numpy()[:, 0], [3.0, TABLE - 1, 5.0])
    want = ref.scatter_rows(jnp.asarray(table), jnp.asarray(ukeys), r_rows * 10.0)
    got = ours.scatter_rows(torch.tensor(table), torch.tensor(ukeys), rows * 10.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[TABLE - 1, 0] == TABLE - 1  # the sentinel write was dropped
    # only sentinels: nothing is written
    t = torch.tensor(table)
    ours.scatter_rows(t, torch.full((4,), TABLE, dtype=torch.int32), torch.zeros(4, 1))
    np.testing.assert_array_equal(t.numpy(), table)


def _plan(keys2d):
    keys = torch.tensor(keys2d)
    ukeys = torch.empty(keys.numel() + 5, dtype=torch.int32)
    count = torch.zeros(1, dtype=torch.int32)
    slots = torch.empty_like(keys)
    ours.consolidate_keys(keys, TABLE, ukeys, count, slots)
    return ukeys, count, slots


@pytest.mark.parametrize("dist", DISTS)
def test_consolidate_keys_plain(dist):
    """K4's plain version on the compact wire's keys (-1 = padding): the
    unique keys and inverse of torch.unique(sorted=True), which is the
    reference plan's order; padding slots -1; the sentinel past count."""
    keys, _ = _keys(dist)
    wire = np.where(keys == TABLE, -1, keys).astype(np.int32).reshape(32, 16)
    before = ours.consolidate_keys.launches
    ukeys, count, slots = _plan(wire)
    assert ours.consolidate_keys.launches == before  # the CPU launches nothing
    live = wire >= 0
    u, inv = torch.unique(torch.tensor(wire[live]), sorted=True, return_inverse=True)
    n = int(count)
    assert n == u.numel()
    np.testing.assert_array_equal(ukeys[:n].numpy(), u.numpy())
    assert (ukeys[n:] == TABLE).all()
    np.testing.assert_array_equal(slots.numpy()[live], inv.numpy())
    assert (slots.numpy()[~live] == -1).all()
    r_ukeys = np.asarray(ref.consolidate_plan(jnp.asarray(keys), TABLE)[2])
    np.testing.assert_array_equal(ukeys[: keys.size].numpy(), r_ukeys)


def test_wrappers_refuse_bad_inputs():
    keys = torch.zeros((4, 3), dtype=torch.int32)
    ok = dict(ukeys=torch.empty(12, dtype=torch.int32),
              count=torch.zeros(1, dtype=torch.int32),
              slots=torch.empty((4, 3), dtype=torch.int32))
    for bad, match in (({"ukeys": torch.empty(11, dtype=torch.int32)}, "ukeys"),
                       ({"slots": torch.empty(12, dtype=torch.int32)}, "slots"),
                       ({"count": torch.zeros(1)}, "count")):
        with pytest.raises(ValueError, match=match):
            ours.consolidate_keys(keys, TABLE, **{**ok, **bad})
    table = {"param": torch.zeros(TABLE, 2), "n": torch.zeros(TABLE, 2),
             "z": torch.zeros(TABLE, 2)}
    with pytest.raises(ValueError, match="gsum"):
        ours.touched_update(table, FTRL(), ok["ukeys"], ok["count"], torch.zeros(12, 3))
    with pytest.raises(ValueError, match="optimizer"):
        ours.touched_update(table, None, ok["ukeys"], ok["count"], torch.zeros(12, 2))


@pytest.mark.parametrize("dist", ["uniform", "zipf", "padding"])
@pytest.mark.parametrize("opt", ["ftrl", "sgd"])
def test_touched_update_plain_matches_reference(opt, dist):
    """K5's plain version against the reference's _apply_touched_rows
    (gather_rows → update_rows → scatter_rows) on the same consolidated
    gradients: the touched rows within rtol 1e-5 / atol 1e-7, every
    other row bit-identical, and gsum[:count] cleared."""
    keys, grads = _keys(dist, seed=3)
    rng = np.random.default_rng(5)
    d = grads.shape[1]
    r_ukeys, r_gsum = ref.consolidate(jnp.asarray(keys), jnp.asarray(grads), TABLE)
    start = {"param": (rng.normal(size=(TABLE, d)) * 0.1).astype(np.float32)}
    if opt == "ftrl":
        start["n"] = np.abs(rng.normal(size=(TABLE, d))).astype(np.float32) * 0.01
        start["n"][: TABLE // 4] = 0.0  # never touched before
        start["z"] = (rng.normal(size=(TABLE, d)) * 0.01).astype(np.float32)
    r_opt = RefFTRL() if opt == "ftrl" else RefSGD(lr=0.05)
    table = {k: jnp.asarray(a) for k, a in start.items()}
    rows = {k: ref.gather_rows(a, r_ukeys) for k, a in table.items()}
    new = r_opt.update_rows(rows, r_gsum)
    want = {k: np.asarray(ref.scatter_rows(table[k], r_ukeys, new[k])) for k in table}

    wire = np.where(keys == TABLE, -1, keys).astype(np.int32)
    ukeys, count, slots = _plan(wire.reshape(-1, 16))
    gsum = torch.zeros(keys.size, d)
    gsum.index_add_(0, slots.reshape(-1).clamp(min=0).long(),
                    torch.tensor(grads))
    table = {k: torch.tensor(a) for k, a in start.items()}
    before = ours.touched_update.launches
    ours.touched_update(table, FTRL() if opt == "ftrl" else SGD(lr=0.05),
                        ukeys, count, gsum)
    assert ours.touched_update.launches == before
    touched = np.zeros(TABLE, bool)
    touched[keys[keys < TABLE]] = True
    for k in want:
        got = table[k].numpy()
        np.testing.assert_allclose(got, want[k], rtol=RTOL, atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(got[~touched], start[k][~touched])
    assert not gsum.any()


@pytest.mark.parametrize("fold", [False, True], ids=["plain", "fold"])
@pytest.mark.parametrize("widths", [(1, 10), (1, 156)], ids=["1+10", "1+156"])
@pytest.mark.parametrize("opt", ["ftrl", "sgd"])
def test_touched_update_tables_plain_matches_reference(opt, widths, fold):
    """K5's plain version over two tables in one call (the form the
    kernel takes in one launch) against the reference's per-table
    _apply_touched_rows on seed-made rows, and with the fold against
    the reference's hybrid (step.py:1194-1238): the cold keys < H made
    the sentinel, their sums added into the [H, d] head buffer with
    ``.at[].add(mode="drop")``.  rtol 1e-5 / atol 1e-7; rows outside
    the plan bit-identical; every gsum[:count] cleared."""
    keys, _ = _keys("zipf", seed=4)
    hot = 16 if fold else 0
    rng = np.random.default_rng(6)
    wire = np.where(keys == TABLE, -1, keys).astype(np.int32)
    ukeys, count, slots = _plan(wire.reshape(-1, 16))
    r_ukeys = jnp.asarray(ukeys.numpy()[:keys.size])
    n = int(count)
    r_ukeys = jnp.where(jnp.arange(r_ukeys.shape[0]) < n, r_ukeys, TABLE)
    tables, gsums, heads, wants, head_wants = [], [], [], [], []
    r_opt = RefFTRL() if opt == "ftrl" else RefSGD(lr=0.05)
    for d in widths:
        start = {"param": (rng.normal(size=(TABLE, d)) * 0.1).astype(np.float32)}
        if opt == "ftrl":
            start["n"] = np.abs(rng.normal(size=(TABLE, d))).astype(np.float32) * 0.01
            start["n"][: TABLE // 4] = 0.0
            start["z"] = (rng.normal(size=(TABLE, d)) * 0.01).astype(np.float32)
        grads = rng.normal(size=(keys.size, d)).astype(np.float32) * 0.1
        gsum = torch.zeros(keys.size, d)
        gsum.index_add_(0, slots.reshape(-1).clamp(min=0).long(),
                        torch.where(torch.tensor(wire.reshape(-1, 1)) >= 0,
                                    torch.tensor(grads), torch.zeros(1)))
        r_gsum = jnp.asarray(gsum.numpy())
        cold = jnp.where(r_ukeys < hot, TABLE, r_ukeys) if fold else r_ukeys
        table = {k: jnp.asarray(a) for k, a in start.items()}
        rows = {k: ref.gather_rows(a, cold) for k, a in table.items()}
        new = r_opt.update_rows(rows, r_gsum)
        wants.append({k: np.asarray(ref.scatter_rows(table[k], cold, new[k]))
                      for k in table})
        head0 = rng.normal(size=(max(hot, 1), d)).astype(np.float32)
        if fold:
            part = jnp.where(r_ukeys < hot, r_ukeys, hot)
            head_wants.append(np.asarray(jnp.asarray(head0).at[part].add(r_gsum,
                                                                          mode="drop")))
        tables.append({k: torch.tensor(a) for k, a in start.items()})
        gsums.append(gsum)
        heads.append(torch.tensor(head0))
    assert fold is False or int((ukeys[:n] < hot).sum()) > 0
    ours.touched_update(tables, FTRL() if opt == "ftrl" else SGD(lr=0.05), ukeys, count,
                        gsums, head=heads if fold else None, hot_size=hot)
    for i, want in enumerate(wants):
        for k in want:
            np.testing.assert_allclose(tables[i][k].numpy(), want[k], rtol=RTOL, atol=1e-7,
                                       err_msg=f"{widths[i]} {k}")
        if fold:
            np.testing.assert_allclose(heads[i].numpy(), head_wants[i], rtol=RTOL, atol=1e-7)
        assert not gsums[i][:n].any()
