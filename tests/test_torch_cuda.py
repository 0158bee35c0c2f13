"""The port's kernels and training step on the card, against their plain
PyTorch versions on the same inputs.  Every test carries the ``cuda``
marker and skips without a card.  The file imports neither JAX nor the
reference package, so it runs where the port runs:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which the port's
machines need not have.)  Tolerances: K1 and K2 (the FM forms at any
D, and the MVM forms) rtol 1e-5 with an atol of 1e-5 of the largest
magnitude compared — the kernels sum and multiply in another order
than the plain versions (K2's atomics in any order); K3 rtol
1e-5 / atol 1e-6 (tests/test_ftrl.py's bar; nvcc contracts n + g*g to
an FMA), and the same for K2's index mode and K5; K4's keys, count and
slots exactly; K6's decoded planes exactly.  The full-width checks,
with bounds derived per element, are chip_smoke.py's phases 2, 6, 7,
10 and 15."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.io.batch import Batch
from xflow_tpu_torch.io.compact import DICT_CAP, compact_batch
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.ops.optim import optim_plain, optim_update
from xflow_tpu_torch.ops.score import score, score_plain
from xflow_tpu_torch.ops.sparse import (
    consolidate_keys,
    consolidate_keys_plain,
    touched_plain,
    touched_update,
)
from xflow_tpu_torch.ops.hot import hot_scatter
from xflow_tpu_torch.ops.train import occurrence_grads, train_plain, train_step
from xflow_tpu_torch.ops.wire import dict_decode, to_device
from xflow_tpu_torch.optim import FTRL, SGD, make_optimizer
from xflow_tpu_torch.parallel.step import TrainStep, init_state

pytestmark = pytest.mark.cuda
RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed=0, t=1 << 12, d=10, b=256, k=40, full=False):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, t, size=(b, k)).astype(np.int32)
    keys[:, k // 2:][rng.random((b, k - k // 2)) > 0.5] = -1
    keys[3] = -1  # an all-padding row
    keys[5:50, :4] = 11  # a key repeated across examples
    x = None
    if full:
        x = np.where(keys >= 0, rng.uniform(0.25, 2.0, (b, k)), 0.0).astype(np.float32)
    w = (rng.standard_normal((t, 1)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((t, d)) * 0.3).astype(np.float32)
    labels = (rng.random(b) > 0.5).astype(np.float32)
    return keys, x, w, v, labels


def _close(got, want):
    scale = float(want.abs().max()) if want.numel() else 0.0
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("full", [False, True], ids=["compact", "full"])
@pytest.mark.parametrize("with_v", [False, True], ids=["lr", "fm"])
def test_k1_and_k2_match_plain(dev, with_v, full):
    keys, x, w, v, labels = _inputs(full=full)
    t = lambda a: None if a is None else torch.tensor(a, device=dev)  # noqa: E731
    vv = t(v) if with_v else None
    before = (score.launches, train_step.launches)
    _close(score(t(keys), t(x), t(w), vv), score_plain(t(keys), t(x), t(w), vv))
    weights = np.ones(len(labels), np.float32)
    outs = []
    for fn in (train_step, train_plain):
        g_w = torch.zeros(w.shape, device=dev)
        g_v = torch.zeros(v.shape, device=dev) if with_v else None
        acc = torch.zeros(2, device=dev, dtype=torch.float64)
        fn(t(keys), t(x), t(labels), t(weights), 256.0, t(w), vv, g_w, g_v, acc)
        outs.append((g_w, g_v, acc))
    torch.cuda.synchronize()
    assert (score.launches, train_step.launches) == (before[0] + 1, before[1] + 1)
    for got, want in zip(*outs):
        if want is not None:
            _close(got, want)
    assert float(outs[0][2][1]) == float(outs[1][2][1])  # the count is exact


@pytest.mark.parametrize("dim", [1, 10])
@pytest.mark.parametrize("opt", [FTRL(), SGD(lr=0.05)], ids=["ftrl", "sgd"])
def test_k3_matches_plain(dev, opt, dim):
    rng = np.random.default_rng(3)
    rows = 4096
    arr = lambda scale: torch.tensor(  # noqa: E731
        (rng.standard_normal((rows, dim)) * scale).astype(np.float32), device=dev)
    table = {"param": arr(0.01), "g": arr(0.01)}
    table["g"][: rows // 4] = 0.0
    if isinstance(opt, FTRL):
        table.update(n=arr(0.01).abs(), z=arr(1e-3))
        table["n"][: rows // 4] = 0.0  # never touched
    plain = {k: a.clone() for k, a in table.items()}
    before = optim_update.launches
    optim_update(table, opt)
    optim_plain(plain, opt)
    torch.cuda.synchronize()
    assert optim_update.launches == before + 1
    assert not table["g"].any()
    for key in plain:
        np.testing.assert_allclose(table[key].cpu().numpy(), plain[key].cpu().numpy(),
                                   rtol=RTOL, atol=1e-6)
    if isinstance(opt, FTRL):
        assert torch.equal(table["param"][: rows // 4], plain["param"][: rows // 4])
    # the kernel makes 16-byte loads only: a ragged count or an unaligned
    # view is refused before any launch
    ragged = {k: a[:-1] for k, a in table.items()}  # T*D % 4 != 0
    unaligned = {k: a.view(-1)[2:2 + 40 * dim].view(-1, dim)  # 8-byte offset
                 for k, a in table.items()}
    for bad in (ragged, unaligned):
        with pytest.raises(ValueError, match="16-byte"):
            optim_update(bad, opt)
    assert optim_update.launches == before + 1


def _chip_smoke():
    """chip_smoke.py (JAX-free), for its helpers that read K2's launch
    shape and K3's skipped groups."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("g_kind", ["sparse", "zero"])
@pytest.mark.parametrize("dim", [1, 10])
@pytest.mark.parametrize("opt", [FTRL(), SGD(lr=0.05)], ids=["ftrl", "sgd"])
def test_k3_leaves_zero_gradient_groups(dev, opt, dim, g_kind):
    """K3 touches no element of a zero gradient group: w, n, z and g keep
    every bit there (even a w that FTRL did not compute from its z and
    n, which the plain version would rewrite), and the other groups
    match the plain version.  An all-zero g is a no-op."""
    rng = np.random.default_rng(5)
    rows = 4096
    arr = lambda scale: torch.tensor(  # noqa: E731
        (rng.standard_normal((rows, dim)) * scale).astype(np.float32), device=dev)
    table = {"param": arr(0.01), "g": torch.zeros((rows, dim), device=dev)}
    if g_kind == "sparse":
        touched = torch.tensor(rng.random(rows) < 0.03, device=dev)
        table["g"][touched] = arr(0.01)[touched]
    if isinstance(opt, FTRL):
        table.update(n=arr(0.01).abs(), z=arr(1e-3))
        table["n"][: rows // 8] = 0.0  # never touched
    before = {k: a.clone() for k, a in table.items()}
    plain = {k: a.clone() for k, a in table.items()}
    launches = optim_update.launches
    optim_update(table, opt)
    optim_plain(plain, opt)
    torch.cuda.synchronize()
    assert optim_update.launches == launches + 1
    skip = _chip_smoke().k3_untouched(before["g"])
    assert bool(skip.any()) and (g_kind == "zero") == bool(skip.all())
    for key in table:
        assert torch.equal(table[key].view(torch.int32)[skip],
                           before[key].view(torch.int32)[skip]), key
        np.testing.assert_allclose(table[key][~skip].cpu().numpy(),
                                   plain[key][~skip].cpu().numpy(), rtol=RTOL, atol=1e-6)
    assert not table["g"].any()


K2_TABLE_ROWS = {"one-row": 4096, "overflow": 65536}


@pytest.mark.parametrize("case", ["one-row", "overflow"])
@pytest.mark.parametrize("form", ["lr", "fm", "hot-u16", "hot-int32"])
def test_k2_table_matches_plain(dev, form, case):
    """K2's LR/FM form, which sums repeated destinations in a shared-memory
    table before its global atomics, against the plain version: one row
    in every example (cold slot 0, or hot slot 0 with the hot plane),
    and uniform keys with more distinct rows a block than its table
    holds (the direct-to-global path, shown to be taken).  The hot forms put the hot gradients in g's first H
    rows (dense mode)."""
    t_size, h, d = 1 << 20, 1 << 14, 10
    b = K2_TABLE_ROWS[case]
    rng = np.random.default_rng(11)
    kc = 40 if form in ("lr", "fm") else 12
    keys = rng.integers(0, t_size, size=(b, kc)).astype(np.int32)
    keys[:, kc // 2:][rng.random((b, kc - kc // 2)) > 0.8] = -1
    hot = None
    if form.startswith("hot"):
        ids = rng.integers(0, h, size=(b, 32))
        if case == "one-row":
            ids[:, 0] = 3
        hot = (ids.astype(np.uint16).view(np.int16) if form == "hot-u16"
               else ids.astype(np.int32))
    elif case == "one-row":
        keys[:, 0] = 7
    # one sign of residual for the one-row cases: the row's sum then has
    # no cancellation for float32 rounding to stand out against
    labels = (np.zeros(b) if case == "one-row" else rng.random(b) > 0.5).astype(np.float32)
    w = (rng.standard_normal((t_size, 1)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((t_size, d)) * 0.05).astype(np.float32)
    with_v = form != "lr"
    t = lambda a: None if a is None else torch.tensor(a, device=dev)  # noqa: E731
    tk, th = t(keys), t(hot)
    outs = []
    for fn in (train_step, train_plain):
        g_w = torch.zeros((t_size, 1), device=dev)
        g_v = torch.zeros((t_size, d), device=dev) if with_v else None
        acc = torch.zeros(2, dtype=torch.float64, device=dev)
        kw = {}
        if hot is not None:
            kw = dict(hot=th, hot_size=h, hg_w=g_w[:h], hg_v=g_v[:h])
        fn(tk, None, t(labels), t(np.ones(b, np.float32)), float(b), t(w),
           t(v) if with_v else None, g_w, g_v, acc, **kw)
        outs.append((g_w, g_v, acc))
    torch.cuda.synchronize()
    for got, want in zip(*outs):
        if got is not None:
            _close(got, want)
    if case == "overflow":
        cover = _chip_smoke().k2_table_cover(tk, d if with_v else 0, hot=th, hot_size=h,
                                             lw_u8=False)
        assert cover["entries"] > 0 and cover["blocks_over"] > 0


def _plan(keys, t, dev, slot_map=None):
    ukeys = torch.empty(keys.numel(), dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    slots = torch.empty_like(keys)
    if slot_map is None:
        consolidate_keys_plain(keys, t, ukeys, count, slots)
    else:
        consolidate_keys(keys, t, ukeys, count, slots, slot_map)
    return ukeys, count, slots


@pytest.mark.parametrize("case", ["uniform", "one-key", "padding"])
def test_k4_k2_index_k5_match_plain(dev, case):
    """K4's unique keys and count equal the plain plan's as sets, each
    live key in one slot; K2 in index mode sums as its plain version;
    K5 (FTRL, SGD) updates as its plain version, leaves every
    other row bit-identical, clears gsum and restores the slot map."""
    t, d = 1 << 12, 10
    keys, _, w, v, labels = _inputs(seed=5, t=t, d=d)
    if case == "one-key":
        keys[:, 0] = 77
    if case == "padding":
        keys[:] = -1
    keys_d = torch.tensor(keys, device=dev)
    slot_map = torch.full((t,), -1, dtype=torch.int32, device=dev)
    before = (consolidate_keys.launches, touched_update.launches)
    uk, cnt, sl = _plan(keys_d, t, dev, slot_map)
    puk, pcnt, psl = _plan(keys_d, t, dev)
    torch.cuda.synchronize()
    n = int(cnt)
    assert n == int(pcnt) == len(set(keys[keys >= 0].tolist()))
    assert torch.equal(torch.sort(uk[:n]).values, puk[:n])
    live = keys_d >= 0
    assert torch.equal(uk[sl[live].long()], keys_d[live])
    assert bool((sl[~live] == -1).all())
    # K2 index mode: each side's gradients summed at its own slots
    wd, vd = torch.tensor(w, device=dev), torch.tensor(v, device=dev)
    ones = torch.ones(len(labels), device=dev)
    sums = []
    for fn, slots in ((train_step, sl), (train_plain, psl)):
        gw = torch.zeros((keys.size, 1), device=dev)
        gv = torch.zeros((keys.size, d), device=dev)
        acc = torch.zeros(2, device=dev, dtype=torch.float64)
        fn(keys_d, None, torch.tensor(labels, device=dev), ones, 256.0, wd, vd,
           gw, gv, acc, slots=slots)
        sums.append((gw, gv))
    order = torch.argsort(uk[:n])
    for got, want in zip(sums[0], sums[1]):
        _close(got[:n][order], want[:n])
    # K5 on K4's plan and the kernel's sums, against the plain version
    gw, gv = sums[0]
    rng = np.random.default_rng(6)
    for opt, name in ((FTRL(), "ftrl"), (SGD(lr=0.05), "sgd")):
        for grads in (gw, gv):
            dim = grads.shape[1]
            arr = lambda: torch.tensor(  # noqa: E731
                (rng.standard_normal((t, dim)) * 0.01).astype(np.float32), device=dev)
            table = {"param": arr()}
            if name == "ftrl":
                table.update(n=arr().abs(), z=arr())
                table["n"][: t // 2] = 0.0
            plain = {k: a.clone() for k, a in table.items()}
            g1, g2 = grads.clone(), grads.clone()
            # the map as K4 left it, for K5 to restore
            slot_map[uk[:n].long()] = torch.arange(n, dtype=torch.int32, device=dev)
            touched_update(table, opt, uk, cnt, g1, slot_map)
            touched_plain(plain, opt, uk, cnt, g2)
            torch.cuda.synchronize()
            rows = torch.zeros(t, dtype=torch.bool, device=dev)
            rows[uk[:n].long()] = True
            for k in plain:
                np.testing.assert_allclose(table[k].cpu().numpy(), plain[k].cpu().numpy(),
                                           rtol=RTOL, atol=1e-6, err_msg=f"{name} {k}")
                assert torch.equal(table[k][~rows], plain[k][~rows])
            assert not g1[:n].any() and not g2[:n].any()
            assert bool((slot_map == -1).all())
    assert consolidate_keys.launches - before[0] == 1
    assert touched_update.launches - before[1] == 4


@pytest.mark.parametrize("mode", [
    {"update_mode": "sparse"},
    {"update_mode": "sequential", "microbatch": 4, "sequential_inner": "sparse"},
    {"update_mode": "sequential", "microbatch": 4},
    {"microbatch": 4, "cold_consolidate": True},
], ids=["sparse", "seq-sparse", "seq-dense", "mb4-consolidate"])
@pytest.mark.parametrize("model", ["lr", "fm"])
def test_update_modes_on_card_match_cpu(dev, model, mode):
    _card_vs_cpu(dev, model, **mode)


@pytest.mark.parametrize("model", ["lr", "fm"])
def test_train_step_on_card_matches_cpu(dev, model):
    """Three steps of TrainStep on the card and on the CPU from the same
    state: the tables within rtol 1e-4 plus 1e-5 of their largest
    magnitude (float32 noise carried through FTRL's state)."""
    _card_vs_cpu(dev, model)


def _card_vs_cpu(dev, model, **mode):
    cfg = Config(model=model, table_size_log2=12, max_nnz=40, batch_size=256, v_dim=10,
                 **mode)
    mdl, opt = make_model(cfg), make_optimizer(cfg)
    cpu_state = init_state(mdl, opt, cfg, torch.device("cpu"))
    card_state = {"tables": {n: {k: a.to(dev, copy=True) for k, a in t.items()}
                             for n, t in cpu_state["tables"].items()},
                  "dense": {}, "step": 0}
    steps = {d: TrainStep(mdl, opt, cfg, d) for d in (dev, torch.device("cpu"))}
    for seed in range(3):
        keys, _, _, _, labels = _inputs(seed=seed, t=cfg.table_size)
        mask = (keys >= 0).astype(np.float32)
        batch = Batch(keys=np.maximum(keys, 0), slots=np.zeros_like(keys), vals=mask,
                      mask=mask, labels=labels, weights=np.ones(len(labels), np.float32))
        m_card = steps[dev].train(card_state, steps[dev].put_batch(batch))
        m_cpu = steps[torch.device("cpu")].train(
            cpu_state, steps[torch.device("cpu")].put_batch(batch))
        np.testing.assert_allclose(float(m_card["logloss"]), float(m_cpu["logloss"]),
                                   rtol=1e-5)
    for n, t in cpu_state["tables"].items():
        for k, want in t.items():
            got = card_state["tables"][n][k].cpu()
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=1e-4,
                atol=1e-5 * float(want.abs().max()) if want.numel() else 0.0)


def _left_compacted(seed, b, k, t_log2, unique=False, padding=False, full=False):
    """A Batch of left-compacted rows (loader batches are), keys with a
    duplicated head or all distinct, the last 3 examples padding;
    ``full`` rows hold all k entries."""
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
    return Batch(keys=keys, slots=np.zeros_like(keys), vals=mask.copy(), mask=mask,
                 labels=labels, weights=weights)


K6_CASES = {
    "u24": dict(b=1001, k=40, t_log2=14),
    "u32": dict(b=1001, k=40, t_log2=25),
    "empty-dictionary": dict(b=200, k=8, t_log2=14, unique=True),
    "no-tail": dict(b=64, k=8, t_log2=14),
    "all-padding": dict(b=13, k=8, t_log2=14, padding=True),
    # past K6's scan tiles (4,096 rows of counts, 1,024 flag words): one
    # row past a tile; full rows, whose bitmap is not whole words and
    # whose row 3,640 straddles a word tile; all tail over two row
    # tiles; and one row past the path's 65,536
    "row-tile-plus-one": dict(b=4097, k=40, t_log2=14),
    "straddling-row": dict(b=4097, k=9, t_log2=14, full=True),
    "all-tail-two-tiles": dict(b=4100, k=8, t_log2=16, unique=True),
    "b65537": dict(b=65537, k=40, t_log2=24),
}


@pytest.mark.parametrize("case", list(K6_CASES))
def test_k6_matches_plain(dev, case):
    kw = K6_CASES[case]
    batch = _left_compacted(1, **kw)
    cb = compact_batch(batch, 1 << kw["t_log2"], 0,
                       dict_cap=16 if kw.get("unique") else DICT_CAP)
    if kw.get("unique"):
        assert cb.n_dict == 0 and cb.n_cold > 0
    if case == "straddling-row":
        assert cb.cf.shape[0] % 4 != 0 and cb.n_cold > 32768
    wire = cb.wire(ship_slots=False)
    want = dict_decode(to_device(wire, torch.device("cpu")), kw["k"])
    before = dict_decode.launches
    got = dict_decode(to_device(wire, dev), kw["k"])
    torch.cuda.synchronize()
    assert dict_decode.launches - before == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert torch.equal(want[0], torch.tensor(np.where(batch.mask > 0, batch.keys, -1)))


@pytest.mark.parametrize("mode", [{}, {"update_mode": "sparse"}], ids=["dense", "sparse"])
@pytest.mark.parametrize("model", ["lr", "fm"])
def test_dict_wire_training_on_card_matches_compact_wire(dev, model, mode):
    """Three steps on the card over the dictionary wire and over the
    compact wire from the same state: K6's planes equal the compact
    wire's exactly, and the tables agree within _card_vs_cpu's bound
    (K2's atomics add in another order on each run)."""
    states, steps = {}, {}
    for dedup in ("auto", "off"):
        cfg = Config(model=model, table_size_log2=12, max_nnz=40, batch_size=256,
                     v_dim=10, wire_dedup=dedup, **mode)
        mdl, opt = make_model(cfg), make_optimizer(cfg)
        steps[dedup] = TrainStep(mdl, opt, cfg, dev)
        states[dedup] = init_state(mdl, opt, cfg, dev)
    assert steps["auto"].wire_format == "dict" and steps["off"].wire_format == "compact"
    before = dict_decode.launches
    for seed in range(3):
        batch = _left_compacted(seed, 256, 40, 12)
        arrays = {d: steps[d].put_batch(batch) for d in steps}
        for name in ("ckeys", "labels_u8", "weights_u8"):
            assert torch.equal(arrays["auto"][name], arrays["off"][name]), name
        for d in steps:
            steps[d].train(states[d], arrays[d])
    assert dict_decode.launches - before == 3
    for n, t in states["off"]["tables"].items():
        for k, want in t.items():
            got = states["auto"]["tables"][n][k]
            np.testing.assert_allclose(
                got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                atol=1e-5 * float(want.abs().max()) if want.numel() else 0.0)


# -- the hot table (B7 in K1 and K2, K5's fold, K6's hot tiers) ------------


def _hot_plane(seed, b, kh, h, u16):
    """A hot plane [B, Kh]: ids < H with repeats, padding (0xFFFF on u16,
    -1 on int32) past a per-row count, an all-padding row."""
    rng = np.random.default_rng(seed)
    ids = np.minimum(rng.zipf(1.2, (b, kh)) - 1, h - 1)
    cnt = rng.integers(0, kh + 1, b)
    cnt[3] = 0
    live = np.arange(kh)[None, :] < cnt[:, None]
    if u16:
        return np.where(live, ids, 0xFFFF).astype(np.uint16).view(np.int16)
    return np.where(live, ids, -1).astype(np.int32)


HOT_K1_CASES = {
    # (H, u16, bf16, full)
    "u16-2^12": (1 << 12, True, False, False),
    "u16-2^14-bf16": (1 << 14, True, True, False),
    "int32-2^16": (1 << 16, False, False, False),
    "int32-full": (1 << 12, False, False, True),
}


@pytest.mark.parametrize("case", list(HOT_K1_CASES))
@pytest.mark.parametrize("with_v", [False, True], ids=["lr", "fm"])
def test_k1_hot_plane_matches_plain(dev, with_v, case):
    h, u16, bf16, full = HOT_K1_CASES[case]
    keys, x, w, v, _ = _inputs(t=1 << 17, full=full)
    hot = _hot_plane(1, keys.shape[0], 32, h, u16)
    hot_x = None
    if full:
        hot_x = np.where(hot >= 0, np.random.default_rng(2).uniform(0.25, 2.0, hot.shape),
                         0.0).astype(np.float32)
    t = lambda a: None if a is None else torch.tensor(a, device=dev)  # noqa: E731
    vv = t(v) if with_v else None
    kw = dict(hot=t(hot), hot_x=t(hot_x), hot_size=h, hot_bf16=bf16)
    before = score.launches
    got = score(t(keys), t(x), t(w), vv, return_logit=True, **kw)
    want = score_plain(t(keys), t(x), t(w), vv, True, **kw)
    for g, p in zip(got, want):
        _close(g, p)
    assert score.launches - before == 1


K1_PATH_FORMS = ("lr", "fm", "hot", "fm64", "mvm", "ffm")


@pytest.mark.parametrize("b", [512, 16384])
@pytest.mark.parametrize("form", K1_PATH_FORMS)
def test_k1_forms_on_path_like_planes_match_plain(dev, form, b):
    """Every K1 form on planes of the repo's traffic (chip_smoke.py's
    k1_view: zipf ids a field, the hot rows in the remap's order) at a
    serving bucket and the eval batch, against score_plain within
    chip_smoke.py's check_k1 bounds."""
    cs = _chip_smoke()
    w, v = cs.k1_tables(dev, form, torch.Generator(device=dev).manual_seed(71))
    view = cs.k1_view(dev, form, b, 72)
    before = score.launches
    cs.check_k1(f"{form} B={b}", form, view, w, v, cs.k1_kw(form, view))
    assert score.launches - before == 1


K1_SHAPES = {
    # (D, K, Kh, full): v widths whose factor groups cross an 8-byte
    # copy or a 32-lane tile; rows of Kh + K slots past 32 and 64 (the
    # lanes' items wrap), their hot planes with keys past H; LR; values
    "d1": (1, 40, 0, False), "d9": (9, 40, 0, True), "d10": (10, 40, 0, False),
    "d31": (31, 40, 0, False), "d33": (33, 40, 0, True), "d64": (64, 40, 0, False),
    "44-slots-hot": (10, 12, 32, False), "72-slots-hot-x": (10, 40, 32, True),
    "lr-72-slots-hot": (0, 40, 32, False),
}


@pytest.mark.parametrize("b", [512, 16384])
@pytest.mark.parametrize("case", list(K1_SHAPES))
def test_k1_lr_fm_shapes_match_plain(dev, case, b):
    """K1's LR/FM form at the shapes its one-pass stage makes hard, with
    an all-padding row, a key repeated across examples and hot keys past
    H (read as padding), against score_plain."""
    d, k, kh, full = K1_SHAPES[case]
    h = 1 << 10
    keys, x, w, v, _ = _inputs(seed=8, t=1 << 14, d=max(d, 1), b=b, k=k, full=full)
    t = lambda a: None if a is None else torch.tensor(a, device=dev)  # noqa: E731
    kw = {}
    if kh:
        hot = _hot_plane(9, b, kh, h, not full)
        bits = hot.view(np.uint16) if hot.dtype == np.int16 else hot
        pad = 0xFFFF if hot.dtype == np.int16 else -1
        bits[1::5, 0] = np.where(bits[1::5, 0] != pad, h + 5, pad)  # past H
        hot_x = (np.where(hot >= 0, np.random.default_rng(10).uniform(0.25, 2.0, hot.shape),
                          0.0).astype(np.float32) if full else None)
        kw = dict(hot=t(hot), hot_x=t(hot_x), hot_size=h)
    vv = t(v) if d else None
    before = score.launches
    got = score(t(keys), t(x), t(w), vv, return_logit=True, **kw)
    want = score_plain(t(keys), t(x), t(w), vv, True, **kw)
    for g, p in zip(got, want):
        _close(g, p)
    assert score.launches - before == 1
    assert float(got[0][3]) == 0.5 or kh  # the all-padding row: logit 0


@pytest.mark.parametrize("form", ["dense", "index", "window-dense", "window-index", "bf16"])
@pytest.mark.parametrize("with_v", [False, True], ids=["lr", "fm"])
def test_k2_hot_forms_match_plain(dev, with_v, form):
    """K2 with the hot plane: dense (the hot gradients in g's first H
    rows), index mode with a head buffer (the hybrid), the window-start
    mode over g or gsum (the hot inner), and the bf16 rounding."""
    t_size, h, d = 1 << 14, 1 << 10, 10
    keys, _, w, v, labels = _inputs(t=t_size, d=d)
    # cold keys < H: the spill the window-start mode reads from the snapshot
    keys[10:40, 4:8] = np.arange(30 * 4).reshape(30, 4) % h
    hot = _hot_plane(3, keys.shape[0], 16, h, True)
    b = keys.shape[0]
    weights = np.ones(b, np.float32)
    snap_rng = np.random.default_rng(4)
    outs = []
    for kernel in (True, False):
        dv = dev if kernel else torch.device("cpu")
        t = lambda a: torch.tensor(a, device=dv)  # noqa: E731
        tk = t(keys)
        ww, vv = t(w), (t(v) if with_v else None)
        index = form in ("index", "window-index")
        rows = max(keys.size, 1) if index else t_size
        g_w = torch.zeros((rows, 1), device=dv)
        g_v = torch.zeros((rows, d), device=dv) if with_v else None
        slots = None
        if index:
            ukeys = torch.empty(keys.size, dtype=torch.int32, device=dv)
            count = torch.zeros(1, dtype=torch.int32, device=dv)
            slots = torch.empty_like(tk)
            consolidate_keys_plain(tk, t_size, ukeys, count, slots)
        if form in ("dense", "bf16"):
            hg_w, hg_v = g_w[:h], (g_v[:h] if with_v else None)
        else:
            hg_w = torch.zeros((h, 1), device=dv)
            hg_v = torch.zeros((h, d), device=dv) if with_v else None
        snap = {}
        if form.startswith("window"):
            snap_rng = np.random.default_rng(4)
            snap["snap_w"] = t((snap_rng.standard_normal((h, 1)) * 0.5).astype(np.float32))
            if with_v:
                snap["snap_v"] = t((snap_rng.standard_normal((h, d)) * 0.3).astype(np.float32))
        acc = torch.zeros(2, dtype=torch.float64, device=dv)
        fn = train_step if kernel else train_plain
        fn(tk, None, t(labels), t(weights), float(b), ww, vv, g_w, g_v, acc, slots=slots,
           hot=t(hot), hot_size=h, hot_bf16=form == "bf16", hg_w=hg_w, hg_v=hg_v, **snap)
        outs.append((g_w, g_v, hg_w, hg_v, acc))
    if form == "bf16":
        plain = (torch.tensor(keys), None, torch.tensor(labels), torch.tensor(weights),
                 float(b), torch.tensor(w), torch.tensor(v) if with_v else None)
        _check_bf16_k2(outs, plain, torch.tensor(hot), h)
        return
    for got, want in zip(*outs):
        if got is not None:
            _close(got, want)


BF16_STEP = 2.0 ** -7  # one bfloat16 step, relative to the value rounded


def _check_bf16_k2(outs, plain, hot, h, **fields):
    """K2 with the bf16 flag against its plain version with it.  Both
    round each hot gradient to bfloat16 from float32 values that differ
    in their last bits, so one near a rounding tie can land a bfloat16
    step apart (a flip).  Every element is held to the float32
    tolerance of the other forms plus one step per hot occurrence; the
    elements beyond the float32 tolerance alone (the flips) must be at
    most a tenth of those the flag's rounding moves beyond it; the
    log-loss sum (the rounded head in the forward) must sit ten times
    closer to the flagged plain run than the unflagged one does."""
    (kw_, kv, _, _, kacc), (pw, pv, _, _, pacc) = outs
    occ, hk, _, _ = occurrence_grads(*plain, hot=hot, hot_size=h, hot_bf16=True, **fields)
    eff = torch.where(hk >= 0, hk, torch.full_like(hk, h)).reshape(-1)
    beyond = power = 0
    for name, got, want in (("w", kw_, pw), ("v", kv, pv)):
        if got is None:
            continue
        got, want = got.cpu().double(), want.double()
        o = occ[name][:, :hk.shape[1]].reshape(-1, occ[name].shape[-1])
        tol = 1.01 * RTOL * (want.abs() + float(want.abs().max()))
        moved = (hot_scatter(eff, o, h, dtype=torch.bfloat16, impl="mxu")
                 - hot_scatter(eff, o, h)).double().abs()
        envelope = tol.clone()
        envelope[:h] += BF16_STEP * hot_scatter(eff, o.abs(), h).double()
        diff = (got - want).abs()
        assert bool((diff <= envelope).all()), f"{name}: beyond one step per occurrence"
        beyond += int((diff > tol).sum())
        power += int((moved > tol[:h]).sum())
    assert power >= 10 * max(beyond, 1), (power, beyond)
    u_acc = torch.zeros(2, dtype=torch.float64)
    gw = torch.zeros_like(plain[5]) if plain[5] is not None else None
    gv = torch.zeros_like(plain[6]) if plain[6] is not None else None
    train_plain(*plain, gw, gv, u_acc, hot=hot, hot_size=h,
                hg_w=gw[:h] if gw is not None else None,
                hg_v=gv[:h] if gv is not None else None, **fields)
    _close(kacc, pacc)
    assert abs(float(u_acc[0] - pacc[0])) > 10 * abs(float(kacc[0].cpu() - pacc[0]))


EPS32 = 2.0 ** -23


def _k3_tolerances(before: dict, g, new_n, opt) -> dict:
    """Per-element bounds on K3's and K5's FTRL/SGD step against the
    plain version, from the inputs and the plain n' (chip_smoke.py's
    phase 7 bound, ``k3_tolerances``): each array's float32 rounding,
    z's carrying sigma * w's, and w's that of z over the denominator
    (the soft threshold is continuous in z)."""
    w = before["param"].double()
    g = g.double()
    if not isinstance(opt, FTRL):
        return {"param": 2 * EPS32 * (w.abs() + (opt.lr * g).abs())}
    n, z, new_n = before["n"].double(), before["z"].double(), new_n.double()
    sq = torch.sqrt(new_n) + torch.sqrt(n)
    tol_z = 4 * EPS32 * (z.abs() + g.abs() + sq / opt.alpha * w.abs())
    denom = (opt.beta + torch.sqrt(new_n)) / opt.alpha + opt.lambda2
    return {"n": 2 * EPS32 * (n + g * g), "z": tol_z,
            "param": (tol_z + 2 * EPS32 * opt.lambda1) / denom}


@pytest.mark.parametrize("opt", [FTRL(), SGD(lr=0.05)], ids=["ftrl", "sgd"])
def test_k5_fold_matches_plain(dev, opt):
    """K5 with the fold: unique keys < H add their sums into the head
    buffer and take no step; the others step as before, within phase
    7's per-element bound of the plain step (unit-normal state and
    sums)."""
    t_size, h, d = 1 << 12, 1 << 8, 10
    rng = np.random.default_rng(7)
    # unique keys (K5's precondition), some 40 of the first 700 below H
    ukeys_np = rng.permutation(t_size)[:900].astype(np.int32)
    n = 700
    assert (ukeys_np[:n] < h).sum() >= 20
    states = []
    for dv in (dev, torch.device("cpu")):
        r = np.random.default_rng(8)

        def arr(shape, r=r, dv=dv):
            return torch.tensor(r.standard_normal(shape).astype(np.float32), device=dv)

        table = {"param": arr((t_size, d))}
        if isinstance(opt, FTRL):
            table["n"] = arr((t_size, d)).abs()
            table["z"] = arr((t_size, d))
        gsum = arr((1024, d))
        head = arr((h, d))
        before = ({k: a.cpu().clone() for k, a in table.items()}, gsum.cpu().clone())
        ukeys = torch.zeros(1024, dtype=torch.int32, device=dv)
        ukeys[:900] = torch.tensor(ukeys_np, device=dv)
        count = torch.tensor([n], dtype=torch.int32, device=dv)
        smap = None
        if dv.type == "cuda":
            smap = torch.full((t_size,), 5, dtype=torch.int32, device=dv)
        launched = touched_update.launches
        touched_update(table, opt, ukeys, count, gsum, smap, head=head, hot_size=h)
        if dv.type == "cuda":
            torch.cuda.synchronize()
            assert touched_update.launches - launched == 1
            assert bool((smap[ukeys[:n].long()] == -1).all())
        states.append((table, gsum, head))
    (ct, cg, ch), (pt, pg, ph) = states
    _close(ch, ph)
    assert not cg[:n].any() and not pg[:n].any()
    keys = torch.tensor(ukeys_np[:n]).long()
    stepped = keys >= h
    rows = keys[stepped]
    table0, gsum0 = before
    tols = _k3_tolerances({k: a[rows] for k, a in table0.items()}, gsum0[:n][stepped],
                          pt["n"][rows] if "n" in pt else None, opt)
    for k, tol in tols.items():
        got, want = ct[k].cpu()[rows].double(), pt[k][rows].double()
        over = (got - want).abs() - tol
        i = int(torch.argmax(over.flatten()))
        state = {a: float(t_[rows].flatten()[i]) for a, t_ in table0.items()}
        assert float(over.max()) <= 0, (
            f"{k}: card {float(got.flatten()[i])} vs plain {float(want.flatten()[i])}, bound "
            f"{float(tol.flatten()[i])}; before {state}, g {float(gsum0[:n][stepped].flatten()[i])}")
        # rows outside the plan and folded rows keep every array
        untouched = torch.ones(t_size, dtype=torch.bool)
        untouched[rows] = False
        assert torch.equal(ct[k].cpu()[untouched], table0[k][untouched])
        assert torch.equal(pt[k][untouched], table0[k][untouched])


HOT_K6_CASES = {
    # (table_size_log2, hot_size_log2, hot_nnz, hot share)
    "u8+u12": (14, 12, 32, 0.7),
    "u8+u16": (16, 14, 32, 0.7),
    "empty-hot-plane": (14, 12, 32, 0.0),
    "all-overflow": (14, 12, 2, 1.0),
    # 4,097 rows (HOT_K6_ROWS): the hot counts and bitmap past a tile
    "u8+u12-two-tiles": (14, 12, 32, 0.9),
}
HOT_K6_ROWS = {"u8+u12-two-tiles": 4097}


@pytest.mark.parametrize("case", list(HOT_K6_CASES))
def test_k6_hot_tiers_match_plain(dev, case):
    t_log2, h_log2, kh, share = HOT_K6_CASES[case]
    t_size, h = 1 << t_log2, 1 << h_log2
    rng = np.random.default_rng(9)
    b, ktot = HOT_K6_ROWS.get(case, 1001), 40 + kh
    keys = rng.integers(h, t_size, (b, ktot))
    hot_ids = np.where(rng.random((b, ktot)) < 0.5, rng.integers(0, 256, (b, ktot)),
                       rng.integers(256, h, (b, ktot)))
    keys = np.where(rng.random((b, ktot)) < share, hot_ids, keys).astype(np.int32)
    cnt = rng.integers(0, ktot + 1, b)
    mask = (np.arange(ktot)[None, :] < cnt[:, None]).astype(np.float32)
    keys = np.where(mask > 0, keys, 0).astype(np.int32)
    weights = (np.arange(b) < b - 3).astype(np.float32)
    labels = (rng.random(b) < 0.4).astype(np.float32) * weights
    from xflow_tpu_torch.io.batch import make_batch

    batch = make_batch(keys, np.zeros_like(keys), mask.copy(), mask, labels, weights, h, kh)
    wire = compact_batch(batch, t_size, h).wire(ship_slots=False)
    want = dict_decode(to_device(wire, torch.device("cpu")), ktot - kh, kh)
    before = dict_decode.launches
    got = dict_decode(to_device(wire, dev), ktot - kh, kh)
    torch.cuda.synchronize()
    assert dict_decode.launches - before == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert torch.equal(want[3], torch.tensor(np.where(batch.hot_mask > 0, batch.hot_keys, -1)))


@pytest.mark.parametrize("mode", [
    {},
    {"update_mode": "sequential", "microbatch": 4, "sequential_inner": "sparse"},
    {"update_mode": "sequential", "microbatch": 4, "sequential_inner": "hot",
     "hot_windowend": "dense"},
    {"update_mode": "sequential", "microbatch": 4, "sequential_inner": "hot",
     "hot_windowend": "sparse"},
], ids=["dense", "hybrid", "hot-dense-end", "hot-sparse-end"])
@pytest.mark.parametrize("wire", ["off", "auto"], ids=["compact", "dict"])
@pytest.mark.parametrize("model", ["lr", "fm"])
def test_hot_modes_on_card_match_cpu(dev, model, wire, mode):
    """Three steps of a hot-table TrainStep on the card and on the CPU
    from the same state, within _card_vs_cpu's bound."""
    from xflow_tpu_torch.io.batch import make_batch

    cfg = Config(model=model, table_size_log2=12, max_nnz=24, hot_size_log2=8,
                 hot_nnz=16, batch_size=256, v_dim=10, wire_dedup=wire, **mode)
    mdl, opt = make_model(cfg), make_optimizer(cfg)
    cpu_state = init_state(mdl, opt, cfg, torch.device("cpu"))
    card_state = {"tables": {n: {k: a.to(dev, copy=True) for k, a in t.items()}
                             for n, t in cpu_state["tables"].items()},
                  "dense": {}, "step": 0}
    steps = {d: TrainStep(mdl, opt, cfg, d) for d in (dev, torch.device("cpu"))}
    for seed in range(3):
        rng = np.random.default_rng(seed)
        keys = np.where(rng.random((256, 40)) < 0.6,
                        np.minimum(rng.zipf(1.2, (256, 40)) - 1, 1000),
                        rng.integers(0, 1 << 12, (256, 40))).astype(np.int32)
        cnt = rng.integers(0, 41, 256)
        mask = (np.arange(40)[None, :] < cnt[:, None]).astype(np.float32)
        keys = np.where(mask > 0, keys, 0).astype(np.int32)
        batch = make_batch(keys, np.zeros_like(keys), mask.copy(), mask,
                           (rng.random(256) < 0.4).astype(np.float32),
                           np.ones(256, np.float32), cfg.hot_size, cfg.hot_nnz)
        m_card = steps[dev].train(card_state, steps[dev].put_batch(batch))
        m_cpu = steps[torch.device("cpu")].train(
            cpu_state, steps[torch.device("cpu")].put_batch(batch))
        np.testing.assert_allclose(float(m_card["logloss"]), float(m_cpu["logloss"]),
                                   rtol=1e-5)
    for n, t in cpu_state["tables"].items():
        for k, want in t.items():
            got = card_state["tables"][n][k].cpu()
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=1e-4,
                atol=1e-5 * float(want.abs().max()) if want.numel() else 0.0)


# -- D-tiled FM (C1) and MVM (B9, with B4s's field planes) ------------------


@pytest.mark.parametrize("d", [33, 64, 156])
def test_fm_wide_v_matches_plain(dev, d):
    """K1 and K2's FM form past 32 factors (tiles of 32), dense and with
    a hot plane into a head buffer."""
    keys, _, w, v, labels = _inputs(d=d)
    h = 1 << 10
    hot = _hot_plane(5, keys.shape[0], 8, h, True)
    weights = np.ones(len(labels), np.float32)
    for with_hot in (False, True):
        outs = []
        for kernel in (True, False):
            dv = dev if kernel else torch.device("cpu")
            t = lambda a: torch.tensor(a, device=dv)  # noqa: E731
            kw = {}
            if with_hot:
                kw = dict(hot=t(hot), hot_size=h, hg_w=torch.zeros((h, 1), device=dv),
                          hg_v=torch.zeros((h, d), device=dv))
            sc = (score if kernel else score_plain)(
                t(keys), None, t(w), t(v), True,
                **{k: kw[k] for k in ("hot", "hot_size") if k in kw})
            g_w, g_v = torch.zeros(w.shape, device=dv), torch.zeros(v.shape, device=dv)
            acc = torch.zeros(2, dtype=torch.float64, device=dv)
            (train_step if kernel else train_plain)(
                t(keys), None, t(labels), t(weights), 256.0, t(w), t(v), g_w, g_v, acc, **kw)
            outs.append(list(sc) + [g_w, g_v, acc] + [kw.get("hg_w"), kw.get("hg_v")])
        torch.cuda.synchronize()
        for got, want in zip(*outs):
            if want is not None:
                _close(got, want)


def _mvm_inputs(seed, b=256, k=12, kh=32, h=1 << 10, s=39, d=10, t=1 << 14,
                u16=True, full=False, vscale=0.1):
    """MVM planes: keys with padding (and an all-padding row), field ids
    in [0, s) with some at the u8 clamp's 255 (and, on the full wire,
    negative ones), a hot plane with its fields, and seed-made v."""
    rng = np.random.default_rng(seed)
    keys, x, _, v, labels = _inputs(seed=seed, t=t, d=d, b=b, k=k, full=full)
    v = (rng.standard_normal((t, d)) * vscale).astype(np.float32)
    dtype = np.int32 if full else np.uint8
    out_of_range = -3 if full else 255
    fields = rng.integers(0, s, (b, k))
    fields[rng.random((b, k)) < 0.05] = out_of_range
    hot = hot_fields = hot_x = None
    if kh:
        hot = _hot_plane(seed + 1, b, kh, h, u16)
        hot_fields = rng.integers(0, s, (b, kh))
        hot_fields[rng.random((b, kh)) < 0.05] = out_of_range
        hot_fields = hot_fields.astype(dtype)
        if full:
            hot_x = np.where(hot >= 0, rng.uniform(0.25, 2.0, hot.shape), 0).astype(np.float32)
    return dict(keys=keys, x=x, v=v, labels=labels, fields=fields.astype(dtype),
                hot=hot, hot_fields=hot_fields, hot_x=hot_x, h=h, s=s)


MVM_K1_CASES = {
    # _mvm_inputs keywords: the flagship planes (12 + 32 slots, u16 hot
    # ids, H = 2^14), mvm_nohot's 40 cold slots, the full wire's int32
    # fields, 33 factors (two tiles), the bf16 flag
    "mvm": dict(h=1 << 14), "mvm_nohot": dict(k=40, kh=0), "full": dict(full=True, u16=False),
    "d33": dict(d=33), "bf16": dict(h=1 << 14),
}


@pytest.mark.parametrize("case", list(MVM_K1_CASES))
def test_k1_mvm_matches_plain(dev, case):
    m = _mvm_inputs(2, **MVM_K1_CASES[case])
    t = lambda a: None if a is None else torch.tensor(a, device=dev)  # noqa: E731
    kw = dict(hot=t(m["hot"]), hot_x=t(m["hot_x"]), hot_size=m["h"] if m["hot"] is not None
              else 0, hot_bf16=case == "bf16", fields=t(m["fields"]),
              hot_fields=t(m["hot_fields"]), max_fields=m["s"], form="mvm")
    before = score.launches
    got = score(t(m["keys"]), t(m["x"]), None, t(m["v"]), return_logit=True, **kw)
    want = score_plain(t(m["keys"]), t(m["x"]), None, t(m["v"]), True, **kw)
    torch.cuda.synchronize()
    assert score.launches - before == 1
    for g, p in zip(got, want):
        _close(g, p)


def _guard_fires(m):
    """Make field 0's sum exactly -1 in factor 0 for the rows that hold
    field 0 once: own = 1 + (-1) = 0 there, so the guard zeroes the
    slot's gradient and prod = 0.  Returns the rows."""
    keys, fields, v = m["keys"], m["fields"], m["v"]
    one = ((fields == 0) & (keys >= 0)).sum(axis=1) == 1
    if m["hot_fields"] is not None:
        one &= (m["hot_fields"] == 0).sum(axis=1) == 0
    rows = np.nonzero(one)[0]
    slots = [int(np.nonzero((fields[r] == 0) & (keys[r] >= 0))[0][0]) for r in rows]
    for r, j in zip(rows, slots):
        v[keys[r, j], 0] = -1.0  # x = 1 on the compact wire
    return rows, slots


@pytest.mark.parametrize("form", ["dense", "index", "window-dense", "window-index",
                                  "nohot", "full", "d33", "guard", "bf16"])
def test_k2_mvm_forms_match_plain(dev, form):
    """K2's MVM form into each destination: dense (hot gradients in g's
    first H rows), index mode with a head buffer (the hybrid), the
    window-start mode over g or gsum (the hot inner); without a hot
    plane (mvm_nohot), on the full wire, at 33 factors, where the guard
    fires, and under the bf16 flag."""
    kw = {"nohot": dict(k=40, kh=0), "full": dict(full=True, u16=False),
          "d33": dict(d=33)}.get(form, {})
    m = _mvm_inputs(3, t=1 << 14, **kw)
    # cold keys < H: the spill the window-start mode reads from the snapshot
    m["keys"][10:40, 2:6] = np.arange(30 * 4).reshape(30, 4) % m["h"]
    if form == "guard":
        guarded = _guard_fires(m)
        assert len(guarded[0]) > 5
    t_size, h, d = m["v"].shape[0], m["h"], m["v"].shape[1]
    b = m["keys"].shape[0]
    weights = np.ones(b, np.float32)
    outs = []
    for kernel in (True, False):
        dv = dev if kernel else torch.device("cpu")
        t = lambda a: None if a is None else torch.tensor(a, device=dv)  # noqa: E731
        tk = t(m["keys"])
        index = form in ("index", "window-index")
        rows = max(m["keys"].size, 1) if index else t_size
        g_v = torch.zeros((rows, d), device=dv)
        slots = None
        if index:
            ukeys = torch.empty(m["keys"].size, dtype=torch.int32, device=dv)
            count = torch.zeros(1, dtype=torch.int32, device=dv)
            slots = torch.empty_like(tk)
            consolidate_keys_plain(tk, t_size, ukeys, count, slots)
        hot = t(m["hot"])
        hg_v = None
        if hot is not None:
            hg_v = torch.zeros((h, d), device=dv) if index or form.startswith("window") \
                else g_v[:h]
        snap = {}
        if form.startswith("window"):
            r = np.random.default_rng(4)
            snap["snap_v"] = t((r.standard_normal((h, d)) * 0.1).astype(np.float32))
        acc = torch.zeros(2, dtype=torch.float64, device=dv)
        fn = train_step if kernel else train_plain
        fn(tk, t(m["x"]), t(m["labels"]), t(weights), float(b), None, t(m["v"]), None, g_v,
           acc, slots=slots, hot=hot, hot_x=t(m["hot_x"]), hot_size=h if hot is not None
           else (h if snap else 0), hot_bf16=form == "bf16", hg_v=hg_v,
           fields=t(m["fields"]), hot_fields=t(m["hot_fields"]), max_fields=m["s"],
           form="mvm", **snap)
        outs.append((None, g_v, None, hg_v, acc))
    torch.cuda.synchronize()
    if form == "bf16":
        fields = dict(fields=torch.tensor(m["fields"]),
                      hot_fields=torch.tensor(m["hot_fields"]), max_fields=m["s"],
                      form="mvm")
        plain = (torch.tensor(m["keys"]), None, torch.tensor(m["labels"]),
                 torch.tensor(weights), float(b), None, torch.tensor(m["v"]))
        _check_bf16_k2(outs, plain, torch.tensor(m["hot"]), h, **fields)
        return
    for got, want in zip(*outs):
        if got is not None:
            _close(got, want)
    if form == "guard":  # the plain version's guard fired at those slots
        occ, _, _, _ = occurrence_grads(
            torch.tensor(m["keys"]), None, torch.tensor(m["labels"]), torch.tensor(weights),
            float(b), None, torch.tensor(m["v"]), hot=torch.tensor(m["hot"]), hot_size=h,
            fields=torch.tensor(m["fields"]), hot_fields=torch.tensor(m["hot_fields"]),
            max_fields=m["s"], form="mvm")
        kh = m["hot"].shape[1]
        assert all(float(occ["v"][r, kh + j, 0]) == 0.0 for r, j in zip(*guarded))


def _mvm_view(dev, seed, b=256, kc=12, kh=32, h=1 << 14, s=39, d=10, t=1 << 16):
    """A K2 view of seed-made MVM planes (u8 fields, u16 hot ids, 10 %
    cold padding) and its v table, as chip_smoke.py's checks take them."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(h, t, (b, kc)).astype(np.int32)
    keys[rng.random((b, kc)) < 0.1] = -1
    view = {"ckeys": torch.tensor(keys, device=dev),
            "fields": torch.tensor(rng.integers(0, s, (b, kc)).astype(np.uint8), device=dev),
            "labels_u8": torch.tensor(rng.random(b) < 0.4, dtype=torch.uint8, device=dev),
            "weights_u8": torch.ones(b, dtype=torch.uint8, device=dev),
            "num_real": float(b), "max_fields": s}
    if kh:
        hot = rng.integers(0, h, (b, kh)).astype(np.uint16)
        hot[rng.random((b, kh)) < 0.1] = 0xFFFF
        view["hot"] = torch.tensor(hot.view(np.int16), device=dev)
        view["hot_fields"] = torch.tensor(rng.integers(0, s, (b, kh)).astype(np.uint8),
                                          device=dev)
    v = torch.tensor((rng.standard_normal((t, d)) * 0.1).astype(np.float32), device=dev)
    return view, {"v": {"param": v}}


MVM_HARD = {
    # _mvm_view keywords: three fields over 44 slots (every field repeats
    # across the hot and cold planes), 33 factors (two tiles), a field
    # repeated in two slots whose factor-0 sum is -1 (the guard fires on
    # both), 1,600 slots (the device-memory stage), S = 300 (past the
    # first-slot table: the bounded scan)
    "repeats": dict(s=3), "d33": dict(s=3, d=33), "guard-repeated": dict(),
    "c5-1600": dict(b=64, kc=1600, kh=0), "s300": dict(s=300),
}


@pytest.mark.parametrize("case", list(MVM_HARD))
def test_mvm_kernels_within_mvm_tolerances(dev, case):
    """K1's and K2's MVM forms against their plain versions within
    chip_smoke.py's mvm_tolerances (K2 in its dense, hybrid and window
    forms through check_mvm_k2) on rows the field links, the lane
    groups' product, the tiles and the guard find hard."""
    cs = _chip_smoke()
    view, tables = _mvm_view(dev, 41, **MVM_HARD[case])
    h = 1 << 14 if "hot" in view else 0
    if case == "guard-repeated":
        b = view["ckeys"].shape[0]
        fields, keys = view["fields"], view["ckeys"]
        fields[fields == 7] = 8
        view["hot_fields"][view["hot_fields"] == 7] = 8
        fields[:, :2] = 7
        keys[:, 0] = torch.arange(b, device=dev) * 2 + h
        keys[:, 1] = keys[:, 0] + 1
        tables["v"]["param"][keys[:, 0].long(), 0] = -0.25
        tables["v"]["param"][keys[:, 1].long(), 0] = -0.75
        rest = keys[:, 2:]
        rest[(rest >= 0) & (rest < h + 2 * b)] += 2 * b
    fk = dict(hot=view.get("hot"), hot_size=h, fields=view["fields"],
              hot_fields=view.get("hot_fields"), max_fields=view["max_fields"], form="mvm")
    v = tables["v"]["param"]
    before = score.launches
    got = score(view["ckeys"], None, None, v, return_logit=True, **fk)
    want = score_plain(view["ckeys"], None, None, v, True, **fk)
    torch.cuda.synchronize()
    assert score.launches - before == 1
    keys = view["ckeys"].long()
    if h:
        from xflow_tpu_torch.ops.score import hot_plane_keys

        keys = torch.cat([hot_plane_keys(view["hot"], h), keys], dim=1)
    tol = cs.mvm_tolerances(keys, cs.view_fields(view), None, None, None, 1.0, v,
                            view["max_fields"], logit_only=True)
    assert bool(torch.isfinite(got[1]).all())
    assert float(((got[1] - want[1]).abs() - 1.01 * tol["logit"] - 1e-7).max()) <= 0
    worst = {"max_abs_err_g": 0.0, "max_err_over_tol": 0.0, "cases": 0,
             "straddling_slots": 0}
    before = train_step.launches
    for form in ("dense", "hybrid") + (("window",) if h else ()):
        cs.check_mvm_k2(f"{case} {form}", form, view, tables, h, worst)
    assert train_step.launches - before == worst["cases"] == (3 if h else 2)
    if case == "guard-repeated":  # both slots of field 7 in every row
        assert worst["straddling_slots"] >= 2 * b


def _field_batch(seed, b, k, kh, t_log2, h_log2, share, slot_lo=0, slot_hi=39):
    """A left-compacted Batch with field ids (some outside [0, 255])
    and, with ``kh``, its hot plane steered by ``make_batch``."""
    from xflow_tpu_torch.io.batch import make_batch

    rng = np.random.default_rng(seed)
    t_size, h = 1 << t_log2, 1 << h_log2 if h_log2 else 0
    ktot = k + kh
    keys = rng.integers(h, t_size, (b, ktot))
    if kh:
        keys = np.where(rng.random((b, ktot)) < share, rng.integers(0, h, (b, ktot)), keys)
    cnt = rng.integers(0, ktot + 1, b)
    mask = (np.arange(ktot)[None, :] < cnt[:, None]).astype(np.float32)
    keys = np.where(mask > 0, keys, 0).astype(np.int32)
    slots = rng.integers(slot_lo, slot_hi, (b, ktot)).astype(np.int32)
    weights = (np.arange(b) < b - 3).astype(np.float32)
    labels = (rng.random(b) < 0.4).astype(np.float32) * weights
    return make_batch(keys, slots, mask.copy(), mask, labels, weights, h, kh)


K6_FIELD_CASES = {
    # (B, K, Kh, table_size_log2, hot_size_log2, hot share, slot range)
    "cold": (1001, 40, 0, 14, 0, 0.0, (0, 39)),
    "hot-tiers": (1001, 12, 32, 16, 14, 0.8, (0, 39)),
    "empty-hot-plane": (512, 12, 32, 16, 14, 0.0, (0, 39)),
    "overflow": (512, 12, 2, 14, 12, 1.0, (0, 39)),
    "out-of-range": (512, 12, 32, 16, 14, 0.8, (-40, 300)),
}


@pytest.mark.parametrize("case", list(K6_FIELD_CASES))
def test_k6_field_streams_match_plain(dev, case):
    """K6's field streams exactly equal the plain version's, and the
    batch's field ids under the u8 clamp (0 on padding)."""
    b, k, kh, t_log2, h_log2, share, (lo, hi) = K6_FIELD_CASES[case]
    batch = _field_batch(11, b, k, kh, t_log2, h_log2, share, lo, hi)
    wire = compact_batch(batch, 1 << t_log2, (1 << h_log2) if h_log2 else 0).wire(
        ship_slots=True)
    want = dict_decode(to_device(wire, torch.device("cpu")), k, kh)
    before = dict_decode.launches
    got = dict_decode(to_device(wire, dev), k, kh)
    torch.cuda.synchronize()
    assert dict_decode.launches - before == 1
    assert len(got) == len(want) == 4 + (2 if kh else 0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)

    def clamp(slots, mask):
        u8 = np.where((slots < 0) | (slots > 255), 255, slots)
        return torch.tensor(np.where(mask > 0, u8, 0).astype(np.uint8))

    assert torch.equal(want[-1 - bool(kh)], clamp(batch.slots, batch.mask))
    if kh:
        assert torch.equal(want[-1], clamp(batch.hot_slots, batch.hot_mask))


@pytest.mark.parametrize("mode", [
    {},
    {"microbatch": 4, "cold_consolidate": True},
    {"update_mode": "sparse", "hot_size_log2": 0},
    {"update_mode": "sequential", "microbatch": 4},
    {"update_mode": "sequential", "microbatch": 4, "sequential_inner": "sparse"},
    {"update_mode": "sequential", "microbatch": 4, "sequential_inner": "hot",
     "hot_windowend": "dense"},
    {"update_mode": "sequential", "microbatch": 4, "sequential_inner": "hot",
     "hot_windowend": "sparse"},
], ids=["dense", "mb4-consolidate", "sparse-nohot", "seq-dense", "hybrid", "hot-dense-end",
        "hot-sparse-end"])
@pytest.mark.parametrize("wire", ["off", "auto", "full"], ids=["compact", "dict", "full"])
def test_mvm_modes_on_card_match_cpu(dev, wire, mode):
    """Three steps of an MVM TrainStep on the card and on the CPU from
    the same state, within _card_vs_cpu's bound."""
    kw = dict(model="mvm", table_size_log2=12, max_nnz=24, hot_size_log2=8, hot_nnz=16,
              batch_size=256, v_dim=10, max_fields=39, wire_dedup="off" if wire == "full"
              else wire, wire_mode="full" if wire == "full" else "auto",
              hash_mode=wire != "full")
    cfg = Config(**{**kw, **mode})
    mdl, opt = make_model(cfg), make_optimizer(cfg)
    cpu_state = init_state(mdl, opt, cfg, torch.device("cpu"))
    card_state = {"tables": {n: {k: a.to(dev, copy=True) for k, a in t.items()}
                             for n, t in cpu_state["tables"].items()},
                  "dense": {}, "step": 0}
    steps = {d: TrainStep(mdl, opt, cfg, d) for d in (dev, torch.device("cpu"))}
    assert steps[dev].wire_format == {"off": "compact", "auto": "dict"}.get(wire, wire)
    before = train_step.launches
    for seed in range(3):
        batch = _field_batch(seed, 256, cfg.max_nnz, cfg.hot_nnz if cfg.hot_size else 0,
                             12, cfg.hot_size_log2, 0.6)
        if wire == "full":
            rng = np.random.default_rng(seed)
            batch.vals[:] = rng.uniform(0.5, 1.5, batch.vals.shape) * batch.mask
            batch.hot_vals[:] = rng.uniform(0.5, 1.5, batch.hot_vals.shape) * batch.hot_mask
        m_card = steps[dev].train(card_state, steps[dev].put_batch(batch))
        m_cpu = steps[torch.device("cpu")].train(
            cpu_state, steps[torch.device("cpu")].put_batch(batch))
        np.testing.assert_allclose(float(m_card["logloss"]), float(m_cpu["logloss"]),
                                   rtol=1e-5)
    assert train_step.launches > before
    for n, t in cpu_state["tables"].items():
        for k, want in t.items():
            got = card_state["tables"][n][k].cpu()
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=1e-4,
                atol=1e-5 * float(want.abs().max()) if want.numel() else 0.0)


# -- FFM (B10): K1's and K2's FFM forms -----------------------------------------


def _ffm_inputs(seed, b=256, k=40, kh=0, h=1 << 10, f=39, d=4, t=1 << 14, u16=True,
                full=False, vscale=0.1):
    """FFM planes: _inputs' keys (padding, an all-padding row, a repeated
    key) and w, field ids in [0, f) with some past it (the u8 clamp's
    255, or negative on the full wire), a hot plane with its fields, and
    seed-made v [T, f * d]."""
    rng = np.random.default_rng(seed)
    keys, x, w, _, labels = _inputs(seed=seed, t=t, d=1, b=b, k=k, full=full)
    v = (rng.standard_normal((t, f * d)) * vscale).astype(np.float32)
    dtype = np.int32 if full else np.uint8
    out_of_range = -3 if full else 255
    fields = rng.integers(0, f, (b, k))
    fields[rng.random((b, k)) < 0.05] = out_of_range
    hot = hot_fields = hot_x = None
    if kh:
        hot = _hot_plane(seed + 1, b, kh, h, u16)
        hot_fields = rng.integers(0, f, (b, kh))
        hot_fields[rng.random((b, kh)) < 0.05] = out_of_range
        hot_fields = hot_fields.astype(dtype)
        if full:
            hot_x = np.where(hot >= 0, rng.uniform(0.25, 2.0, hot.shape), 0).astype(np.float32)
    return dict(keys=keys, x=x, w=w, v=v, labels=labels, fields=fields.astype(dtype),
                hot=hot, hot_fields=hot_fields, hot_x=hot_x, h=h, f=f)


FFM_CASES = {
    # _ffm_inputs keywords: the flagship's 40 slots (F = 39, D = 4: one
    # tile), a hot plane (12 + 32 slots, u16 ids at H = 2^14), the full
    # wire's int32 fields and values, the bf16 flag (w alone), D = 16 and
    # F = 64 (two tiles each)
    "ffm": {}, "hot": dict(k=12, kh=32, h=1 << 14), "full": dict(full=True, u16=False, kh=8),
    "bf16": dict(k=12, kh=32, h=1 << 14), "d16": dict(d=16), "f64": dict(f=64),
}


def _ffm_kw(m, t, bf16=False):
    return dict(hot=t(m["hot"]), hot_x=t(m["hot_x"]),
                hot_size=m["h"] if m["hot"] is not None else 0, hot_bf16=bf16,
                fields=t(m["fields"]), hot_fields=t(m["hot_fields"]), max_fields=m["f"],
                form="ffm")


@pytest.mark.parametrize("case", list(FFM_CASES))
def test_k1_ffm_matches_plain(dev, case):
    from xflow_tpu_torch.ops.score import ffm_tile

    m = _ffm_inputs(2, **FFM_CASES[case])
    t = lambda a: None if a is None else torch.tensor(a, device=dev)  # noqa: E731
    kw = _ffm_kw(m, t, bf16=case == "bf16")
    d = m["v"].shape[1] // m["f"]
    slots = m["keys"].shape[1] + (m["hot"].shape[1] if m["hot"] is not None else 0)
    assert (ffm_tile(m["f"], d, slots) < d) == (case in ("d16", "f64"))
    before = score.launches
    got = score(t(m["keys"]), t(m["x"]), t(m["w"]), t(m["v"]), return_logit=True, **kw)
    want = score_plain(t(m["keys"]), t(m["x"]), t(m["w"]), t(m["v"]), True, **kw)
    torch.cuda.synchronize()
    assert score.launches - before == 1
    for g, p in zip(got, want):
        _close(g, p)


def _ffm_k2(dev, m, form, labels=None):
    """K2's FFM form (kernel, then plain) into ``form``'s destinations:
    dense (hot gradients in g's first H rows) or index mode with a head
    buffer (the hybrid); returns [(g_w, g_v, hg_w, hg_v, acc)] for each."""
    t_size, h, e = m["v"].shape[0], m["h"], m["v"].shape[1]
    b = m["keys"].shape[0]
    weights = np.ones(b, np.float32)
    labels = m["labels"] if labels is None else labels
    outs = []
    for kernel in (True, False):
        dv = dev if kernel else torch.device("cpu")
        t = lambda a: None if a is None else torch.tensor(a, device=dv)  # noqa: E731
        tk = t(m["keys"])
        index = form == "index"
        rows = max(m["keys"].size, 1) if index else t_size
        g_w, g_v = torch.zeros((rows, 1), device=dv), torch.zeros((rows, e), device=dv)
        slots = None
        if index:
            ukeys = torch.empty(m["keys"].size, dtype=torch.int32, device=dv)
            count = torch.zeros(1, dtype=torch.int32, device=dv)
            slots = torch.empty_like(tk)
            consolidate_keys_plain(tk, t_size, ukeys, count, slots)
        hg_w = hg_v = None
        if m["hot"] is not None:
            hg_w, hg_v = ((torch.zeros((h, 1), device=dv), torch.zeros((h, e), device=dv))
                          if index else (g_w[:h], g_v[:h]))
        acc = torch.zeros(2, dtype=torch.float64, device=dv)
        fn = train_step if kernel else train_plain
        fn(tk, t(m["x"]), t(labels), t(weights), float(b), t(m["w"]), t(m["v"]), g_w, g_v,
           acc, slots=slots, hg_w=hg_w, hg_v=hg_v, **_ffm_kw(m, t, bf16=form == "bf16"))
        outs.append((g_w, g_v, hg_w if index else None, hg_v if index else None, acc))
    torch.cuda.synchronize()
    return outs


def _one_key(m):
    m["keys"][:, 0] = 5
    m["fields"][:, 0] = 3


def _key_twice(m):  # in one field (row 0) and in two (row 1)
    m["keys"][0, :2] = 77
    m["fields"][0, :2] = 4
    m["keys"][1, :2] = 78
    m["fields"][1, :2] = (4, 9)


@pytest.mark.parametrize("form", ["dense", "index", "hot-dense", "hot-index", "full",
                                  "d16", "f64", "bf16", "unclamped", "d3", "d3-index",
                                  "one-key", "one-key-index", "key-twice",
                                  "key-twice-index"])
def test_k2_ffm_forms_match_plain(dev, form):
    """K2's FFM form into each destination (dense, index mode; with the
    hot plane's gradients in g's first H rows or a head buffer), on the
    full wire, at two tiles (D = 16, F = 64), under the bf16 flag (w
    alone rounds), and at logits below -30 with every label 0, where
    the residual is the unclamped sigmoid's (about 1e-26): the clamped
    one's 1e-6 would show in every gradient.  D = 4 lands its rows with
    vector reductions, D = 3 and the tiles with scalar atomics; a key
    in every example and a key twice in one example sum many slots'
    rows into one destination."""
    kw = {"hot-dense": dict(k=12, kh=32, h=1 << 14), "hot-index": dict(k=12, kh=32, h=1 << 14),
          "full": dict(full=True, u16=False, kh=8), "d16": dict(d=16), "f64": dict(f=64),
          "bf16": dict(k=12, kh=32, h=1 << 14), "d3": dict(d=3),
          "d3-index": dict(d=3)}.get(form, {})
    m = _ffm_inputs(3, **kw)
    if form.startswith("one-key"):
        _one_key(m)
    elif form.startswith("key-twice"):
        _key_twice(m)
    labels = None
    if form == "unclamped":
        m["w"][:] = -2.0
        labels = np.zeros_like(m["labels"])
    before = train_step.launches
    outs = _ffm_k2(dev, m, "index" if form.endswith("index") else form, labels)
    assert train_step.launches - before == 1
    if form == "bf16":
        (kw_, kv, _, _, kacc), (pw, pv, _, _, pacc) = outs
        _close(kv, pv)  # v opts out of the hot path: float32 throughout
        fields = _ffm_kw(m, lambda a: None if a is None else torch.tensor(a))
        fields.pop("hot"), fields.pop("hot_x"), fields.pop("hot_size"), fields.pop("hot_bf16")
        plain = (torch.tensor(m["keys"]), None, torch.tensor(m["labels"]),
                 torch.ones(m["keys"].shape[0]), float(m["keys"].shape[0]),
                 torch.tensor(m["w"]), torch.tensor(m["v"]))
        _check_bf16_k2([(kw_, None, None, None, kacc), (pw, None, None, None, pacc)], plain,
                       torch.tensor(m["hot"]), m["h"], **fields)
        return
    for got, want in zip(*outs):
        if got is not None:
            _close(got, want)
    if form == "unclamped":
        for g in outs[0][:2] + outs[1][:2]:
            assert 0 < float(g.abs().max()) < 1e-20


@pytest.mark.parametrize("mode", [
    {},
    {"microbatch": 4},
    {"update_mode": "sparse", "hot_size_log2": 0},
    {"update_mode": "sequential", "microbatch": 4},
    {"update_mode": "sequential", "microbatch": 4, "sequential_inner": "sparse"},
    {"hot_size_log2": 0},
], ids=["hot-dense", "hot-mb4", "sparse-nohot", "hot-seq-dense", "hybrid", "nohot"])
@pytest.mark.parametrize("wire", ["off", "auto", "full"], ids=["compact", "dict", "full"])
def test_ffm_modes_on_card_match_cpu(dev, wire, mode):
    """Three steps of an FFM TrainStep on the card and on the CPU from
    the same state, within _card_vs_cpu's bound."""
    kw = dict(model="ffm", table_size_log2=12, max_nnz=24, hot_size_log2=8, hot_nnz=16,
              batch_size=256, ffm_v_dim=4, max_fields=39,
              wire_dedup="off" if wire == "full" else wire,
              wire_mode="full" if wire == "full" else "auto", hash_mode=wire != "full")
    cfg = Config(**{**kw, **mode})
    mdl, opt = make_model(cfg), make_optimizer(cfg)
    cpu_state = init_state(mdl, opt, cfg, torch.device("cpu"))
    card_state = {"tables": {n: {k: a.to(dev, copy=True) for k, a in t.items()}
                             for n, t in cpu_state["tables"].items()},
                  "dense": {}, "step": 0}
    steps = {d: TrainStep(mdl, opt, cfg, d) for d in (dev, torch.device("cpu"))}
    before = train_step.launches
    for seed in range(3):
        batch = _field_batch(seed, 256, cfg.max_nnz, cfg.hot_nnz if cfg.hot_size else 0,
                             12, cfg.hot_size_log2, 0.6, slot_lo=-2, slot_hi=42)
        if wire == "full":
            rng = np.random.default_rng(seed)
            batch.vals[:] = rng.uniform(0.5, 1.5, batch.vals.shape) * batch.mask
            batch.hot_vals[:] = rng.uniform(0.5, 1.5, batch.hot_vals.shape) * batch.hot_mask
        m_card = steps[dev].train(card_state, steps[dev].put_batch(batch))
        m_cpu = steps[torch.device("cpu")].train(
            cpu_state, steps[torch.device("cpu")].put_batch(batch))
        np.testing.assert_allclose(float(m_card["logloss"]), float(m_cpu["logloss"]),
                                   rtol=1e-5)
    assert train_step.launches > before
    for n, t in cpu_state["tables"].items():
        for k, want in t.items():
            got = card_state["tables"][n][k].cpu()
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=1e-4,
                atol=1e-5 * float(want.abs().max()) if want.numel() else 0.0)


def test_ffm_card_path_runs_kernels_only(dev, monkeypatch):
    """An FFM TrainStep and its predict on the card launch K1 and K2 and
    never reach a plain version (each is replaced by a raise here)."""
    import xflow_tpu_torch.ops.score as score_mod
    import xflow_tpu_torch.ops.train as train_mod

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card path")

    monkeypatch.setattr(train_mod, "train_plain", refuse)
    monkeypatch.setattr(train_mod, "occurrence_grads", refuse)
    monkeypatch.setattr(score_mod, "score_plain", refuse)
    cfg = Config(model="ffm", table_size_log2=12, max_nnz=24, hot_size_log2=8, hot_nnz=16,
                 batch_size=256, ffm_v_dim=4, max_fields=39, microbatch=4)
    mdl, opt = make_model(cfg), make_optimizer(cfg)
    state = init_state(mdl, opt, cfg, dev)
    step = TrainStep(mdl, opt, cfg, dev)
    before = (score.launches, train_step.launches)
    batch = _field_batch(5, 256, cfg.max_nnz, cfg.hot_nnz, 12, cfg.hot_size_log2, 0.6)
    step.train(state, step.put_batch(batch))
    pctr = step.predict(state, step.put_batch(batch, predict=True))
    torch.cuda.synchronize()
    assert (score.launches - before[0], train_step.launches - before[1]) == (1, 1)
    assert bool(torch.isfinite(pctr).all())


# -- B11: K7 field_pool and K8 field_pool_grad (wide_deep, dcn, two_tower) --


def _pool_planes(dev, seed, b=300, k=24, kh=0, h=0, t=1 << 13, f=39, e=8, full=False,
                 u16=True, with_w=True, edit=None):
    """Planes on ``dev`` and on the CPU: keys with padding (all-padding
    rows), fields u8 (255 past the clamp) or int32 (negative and past
    F), values on the full wire, a hot plane whose keys past H count as
    padding, tables; then ``edit`` (POOL_EDITS)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, t, (b, k)).astype(np.int32)
    keys[rng.random((b, k)) < 0.2] = -1
    keys[:2] = -1
    if full:
        fields = rng.integers(-3, f + 3, (b, k)).astype(np.int32)
        x = rng.uniform(0.5, 1.5, (b, k)).astype(np.float32)
    else:
        fields = rng.integers(0, f + 2, (b, k)).astype(np.uint8)
        fields[rng.random((b, k)) < 0.1] = 255
        x = None
    p = {"keys": keys, "fields": fields, "x": x,
         "emb": (rng.standard_normal((t, e)) * 0.3).astype(np.float32),
         "w": (rng.standard_normal((t, 1)) * 0.3).astype(np.float32) if with_w else None}
    if kh:
        hk = rng.integers(0, h + 16, (b, kh))
        hk[rng.random((b, kh)) < 0.3] = -1
        p["hot"] = (np.where(hk >= 0, hk, 0xFFFF).astype(np.uint16).view(np.int16) if u16
                    else hk.astype(np.int32))
        p["hot_fields"] = rng.integers(0, f, (b, kh)).astype(fields.dtype)
        p["hot_x"] = rng.uniform(0.5, 1.5, (b, kh)).astype(np.float32) if full else None
    if edit is not None:
        POOL_EDITS[edit](p)
    on = {n: (torch.tensor(a, device=dev) if a is not None else None) for n, a in p.items()}
    cpu = {n: (torch.tensor(a) if a is not None else None) for n, a in p.items()}
    return on, cpu


def _one_field(p):
    p["fields"][:] = 7
    if "hot_fields" in p:
        p["hot_fields"][:] = 7


def _field_of_34(p):
    p["fields"][:, :34] = 3


def _negative_and_255(p):
    p["fields"][:, 0::3] = -5
    p["fields"][:, 1::3] = 255


def _live_row(p):  # row 2 alone: rows 0 and 1 are all padding
    for n in ("keys", "fields", "x", "hot", "hot_fields", "hot_x"):
        if p.get(n) is not None:
            p[n] = p[n][2:3].copy()


# K7's per-field slot lists at their edges: every slot of a row in one
# field (40 + 16: more than a warp's 32), a field of 34 slots, fields
# outside [0, F) both negative and 255, B = 1 (a live row)
POOL_EDITS = {"one-field": _one_field, "field-of-34": _field_of_34,
              "negative-and-255": _negative_and_255, "b1": _live_row}

POOL_CASES = {
    # (kh, h, full, u16, with_w, bf16, b, k, edit)
    "compact": (0, 0, False, True, True, False, 300, 24, None),
    "full-negative-fields": (0, 0, True, True, True, False, 300, 24, None),
    "no-w": (0, 0, False, True, False, False, 300, 24, None),
    "hot-u16": (16, 1 << 10, False, True, True, False, 300, 24, None),
    "hot-i32-full": (16, 1 << 10, True, False, True, False, 300, 24, None),
    "hot-bf16": (16, 1 << 10, False, True, True, True, 300, 24, None),
    "every-slot-in-one-field": (16, 1 << 10, False, True, True, False, 300, 40, "one-field"),
    "field-of-34-slots": (0, 0, True, True, True, False, 300, 40, "field-of-34"),
    "fields-negative-and-255": (0, 0, True, True, True, False, 300, 40, "negative-and-255"),
    "b1": (16, 1 << 10, False, True, True, False, 3, 24, "b1"),
    "b301-not-a-multiple-of-4": (0, 0, False, True, True, False, 301, 24, None),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_k7_field_pool_matches_plain(dev, case):
    from xflow_tpu_torch.ops.pool import field_pool, field_pool_plain

    kh, h, full, u16, with_w, bf16, b, k, edit = POOL_CASES[case]
    on, cpu = _pool_planes(dev, 3, b=b, k=k, kh=kh, h=h, full=full, u16=u16,
                           with_w=with_w, edit=edit)
    f = 39
    args = lambda p: (p["keys"], p["x"], p["fields"], p["emb"], f)  # noqa: E731
    kw = lambda p: dict(w=p["w"], hot=p.get("hot"), hot_x=p.get("hot_x"),  # noqa: E731
                        hot_fields=p.get("hot_fields"), hot_size=h, hot_bf16=bf16)
    before = field_pool.launches
    pooled, wide = field_pool(*args(on), **kw(on))
    torch.cuda.synchronize()
    assert field_pool.launches == before + 1
    want_p, want_w = field_pool_plain(*args(cpu), **kw(cpu))
    _close(pooled, want_p)
    assert float(pooled[:2].abs().max()) == 0.0 or kh or edit == "b1"  # all-padding rows
    if with_w:
        _close(wide, want_w)
    else:
        assert wide is None
    if kh:  # window-start mode: cold keys < H from a snapshot
        g = torch.Generator().manual_seed(4)
        snap = {"emb": torch.randn(h, 8, generator=g), "w": torch.randn(h, 1, generator=g)}
        on["keys"][:, :4] = on["keys"][:, :4].remainder(h)
        cpu["keys"] = on["keys"].cpu()
        got = field_pool(*args(on), **kw(on), snap_w=snap["w"].to(dev) if with_w else None,
                         snap_emb=snap["emb"].to(dev))
        want = field_pool_plain(*args(cpu), **kw(cpu), snap_w=snap["w"] if with_w else None,
                                snap_emb=snap["emb"])
        _close(got[0], want[0])


@pytest.mark.parametrize("form", ["dense", "index", "hot-dense", "hot-head-buffer",
                                  "hot-bf16", "full", "no-w"])
def test_k8_field_pool_grad_matches_plain(dev, form):
    """K8's scatter into the [T, D] buffers (dense), K4's [M, D] sums
    (index) and the hot plane's [H, D] destination, and its log-loss and
    weight sums, against the plain version (rtol 1e-5, atol 1e-5 of the
    largest magnitude: atomics add in any order)."""
    from xflow_tpu_torch.ops.pool import field_pool_grad, field_pool_grad_plain

    hot = form.startswith("hot")
    h = 1 << 10 if hot else 0
    on, cpu = _pool_planes(dev, 5, kh=16 if hot else 0, h=h, full=form == "full",
                           with_w=form != "no-w")
    b, f, e, t = on["keys"].shape[0], 39, 8, on["emb"].shape[0]
    rng = np.random.default_rng(6)
    src = {"dP": rng.standard_normal((b, f, e)).astype(np.float32) * 1e-3,
           "r": rng.standard_normal(b).astype(np.float32) * 1e-3,
           "logit": rng.standard_normal(b).astype(np.float32) * 40,
           "labels": (rng.random(b) < 0.4).astype(np.uint8),
           "weights": (np.arange(b) < b - 5).astype(np.uint8)}
    index = form == "index" or form == "hot-head-buffer"
    results = {}
    for side, p in (("card", on), ("plain", cpu)):
        d = p["keys"].device
        t_ = {n: torch.tensor(a, device=d) for n, a in src.items()}
        rows = p["keys"].numel() if index else t
        bufs = {"g_emb": torch.zeros(rows, e, device=d),
                "g_w": torch.zeros(rows, 1, device=d) if p["w"] is not None else None,
                "hg_emb": torch.zeros(h, e, device=d) if hot else None,
                "hg_w": torch.zeros(h, 1, device=d) if hot and p["w"] is not None else None}
        slots = None
        if index:
            # K4's plain plan, the same slots on both sides
            plan = torch.empty_like(p["keys"].cpu())
            consolidate_keys_plain(p["keys"].cpu(), t, torch.empty(rows, dtype=torch.int32),
                                   torch.zeros(1, dtype=torch.int32), plan)
            slots = plan.to(d)
        acc = torch.zeros(2, dtype=torch.float64, device=d)
        fn = field_pool_grad if side == "card" else field_pool_grad_plain
        fn(p["keys"], p["x"], p["fields"], t_["dP"], t_["r"], t_["logit"], t_["labels"],
           t_["weights"], f, bufs["g_emb"], acc, g_w=bufs["g_w"], slots=slots,
           hot=p.get("hot"), hot_x=p.get("hot_x"), hot_fields=p.get("hot_fields"),
           hot_size=h, hot_bf16=form == "hot-bf16", hg_w=bufs["hg_w"],
           hg_emb=bufs["hg_emb"])
        results[side] = (bufs, acc)
    torch.cuda.synchronize()
    for name, got in results["card"][0].items():
        if got is not None:
            _close(got, results["plain"][0][name])
    got_acc, want_acc = results["card"][1].cpu(), results["plain"][1]
    np.testing.assert_allclose(float(got_acc[0]), float(want_acc[0]), rtol=1e-5)
    assert float(got_acc[1]) == float(want_acc[1])


K8_SHAPES = {
    # (E, B, edit): emb widths of scalar atomics (1, 3) and 16-byte
    # vector reductions (8, 12), over batches that are no multiple of a
    # block's examples; one hot row in every example (the table's
    # hottest entry); a remap-skewed wide_deep batch (12 + 32 slots,
    # H = 2^14, every field's hottest id in the head's first rows)
    "e1": (1, 1001, None), "e3": (3, 1001, None), "e8": (8, 1001, None),
    "e12": (12, 1001, None), "one-hot-row": (8, 4099, "one-hot-row"),
    "remap-skewed": (8, 16384, "remap"),
}


@pytest.mark.parametrize("case", list(K8_SHAPES))
def test_k8_shapes_within_pool_bound(dev, case):
    """K8 against field_pool_grad_plain in dense mode, index mode (K4's
    plain slots, -1 at padding) and the hybrid (index mode with head
    buffers), each destination within chip_smoke.py's check_k8 bound
    (twice its occurrences times 2^-23 times its terms' magnitudes), the
    log-loss within B 2^-23 and the weight sum exact."""
    from xflow_tpu_torch.ops.pool import field_pool_grad

    cs = _chip_smoke()
    e, b, edit = K8_SHAPES[case]
    t = 1 << 16
    if edit == "remap":
        h = 1 << 14
        view = cs.steered_planes(dev, cs.path_like_ranks(b, 73), t, h, 12, 32,
                                 remap_order=True)
    else:
        h = 1 << 10
        on, _ = _pool_planes(dev, 9, b=b, k=24, kh=16, h=h, t=t, e=e)
        if edit == "one-hot-row":
            on["hot"][:, 0] = 3
            on["hot_fields"][:, 0] = 1
        view = {"ckeys": on["keys"], "fields": on["fields"], "hot": on["hot"],
                "hot_fields": on["hot_fields"]}
    rng = np.random.default_rng(74)
    view.update(labels_u8=torch.tensor(rng.random(b) < 0.4, dtype=torch.uint8, device=dev),
                weights_u8=torch.ones(b, dtype=torch.uint8, device=dev), num_real=float(b))
    tables = {"emb": {"param": torch.tensor(rng.normal(0, 0.3, (t, e)).astype(np.float32),
                                            device=dev)},
              "w": {"param": torch.tensor(rng.normal(0, 0.3, (t, 1)).astype(np.float32),
                                          device=dev)}}
    dp = torch.tensor(rng.normal(0, 1e-3, (b, 39, e)).astype(np.float32), device=dev)
    r = torch.tensor(rng.normal(0, 1e-3, b).astype(np.float32), device=dev)
    logit = torch.tensor(rng.normal(0, 4, b).astype(np.float32), device=dev)
    worst = {"k8_max_abs_err": 0.0, "k8_max_err_over_tol": 0.0, "cases": 0}
    before = field_pool_grad.launches
    cs.check_k8(case, view, tables, h, dp, r, logit, worst, ("dense", "index", "hybrid"))
    assert field_pool_grad.launches - before == worst["cases"] == 3


@pytest.mark.parametrize("mode", [
    {},
    {"microbatch": 4, "hot_size_log2": 0},
    {"update_mode": "sparse", "hot_size_log2": 0},
    {"update_mode": "sequential", "microbatch": 4},
    {"update_mode": "sequential", "microbatch": 4, "sequential_inner": "sparse"},
    {"update_mode": "sequential", "microbatch": 4, "sequential_inner": "hot"},
], ids=["hot-dense", "mb4", "sparse", "hot-seq-dense", "hybrid", "hot-inner"])
@pytest.mark.parametrize("model", ["wide_deep", "dcn", "two_tower"])
def test_pooled_modes_on_card_match_cpu(dev, model, mode):
    """Three steps of a pooled family's TrainStep on the card and on the
    CPU from the same state: log-losses, tables and dense parameters
    within _card_vs_cpu's bound."""
    kw = dict(model=model, table_size_log2=12, max_nnz=24, hot_size_log2=8, hot_nnz=16,
              batch_size=256, emb_dim=8, hidden_dim=16, max_fields=39,
              tower_split_field=20, tower_dim=6, sgd_lr=0.05)
    cfg = Config(**{**kw, **mode})
    mdl, opt = make_model(cfg), make_optimizer(cfg)
    cpu_state = init_state(mdl, opt, cfg, torch.device("cpu"))
    card_state = {"tables": {n: {k: a.to(dev, copy=True) for k, a in t.items()}
                             for n, t in cpu_state["tables"].items()},
                  "dense": {k: a.to(dev, copy=True) for k, a in cpu_state["dense"].items()},
                  "step": 0}
    steps = {d: TrainStep(mdl, opt, cfg, d) for d in (dev, torch.device("cpu"))}
    for seed in range(3):
        batch = _field_batch(seed, 256, cfg.max_nnz, cfg.hot_nnz if cfg.hot_size else 0,
                             12, cfg.hot_size_log2, 0.6, slot_lo=-2, slot_hi=42)
        m_card = steps[dev].train(card_state, steps[dev].put_batch(batch))
        m_cpu = steps[torch.device("cpu")].train(
            cpu_state, steps[torch.device("cpu")].put_batch(batch))
        np.testing.assert_allclose(float(m_card["logloss"]), float(m_cpu["logloss"]),
                                   rtol=1e-5)
    for n, t in cpu_state["tables"].items():
        for k, want in t.items():
            got = card_state["tables"][n][k].cpu()
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-5 * float(want.abs().max()))
    for k, want in cpu_state["dense"].items():
        np.testing.assert_allclose(card_state["dense"][k].cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-5 * float(want.abs().max()))


def test_pooled_card_path_runs_kernels_only(dev, monkeypatch):
    """A wide_deep TrainStep and its predict on the card launch K7 twice
    and K8 once, never reach a plain version (each replaced by a raise),
    and leave the float32 matmul flags at their defaults (no TF32)."""
    import xflow_tpu_torch.ops.pool as pool_mod

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card path")

    monkeypatch.setattr(pool_mod, "field_pool_plain", refuse)
    monkeypatch.setattr(pool_mod, "field_pool_grad_plain", refuse)
    cfg = Config(model="wide_deep", table_size_log2=12, max_nnz=24, hot_size_log2=8,
                 hot_nnz=16, batch_size=256, emb_dim=8, hidden_dim=16, max_fields=39,
                 microbatch=4)
    mdl, opt = make_model(cfg), make_optimizer(cfg)
    state = init_state(mdl, opt, cfg, dev)
    step = TrainStep(mdl, opt, cfg, dev)
    before = (pool_mod.field_pool.launches, pool_mod.field_pool_grad.launches,
              score.launches, train_step.launches)
    batch = _field_batch(5, 256, cfg.max_nnz, cfg.hot_nnz, 12, cfg.hot_size_log2, 0.6)
    step.train(state, step.put_batch(batch))
    pctr = step.predict(state, step.put_batch(batch, predict=True))
    torch.cuda.synchronize()
    after = (pool_mod.field_pool.launches, pool_mod.field_pool_grad.launches,
             score.launches, train_step.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 1, 0, 0)
    assert bool(torch.isfinite(pctr).all())
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


# -- K4's forms at their edges, K5 over every table in one launch -----------

def _k4_keys(case: str, t: int) -> np.ndarray:
    """K4's edge cases: no key, one key, all padding, one key in every
    row, the keys -1, T - 1 and T (padding), M at the slice form's
    threshold and one past it (the batch form), the path's 65,536-row
    batch."""
    from xflow_tpu_torch.ops.sparse import K4_SLICE_MAX

    rng = np.random.default_rng(12)

    def rows(b, k):
        keys = rng.integers(0, t, (b, k)).astype(np.int32)
        keys[rng.random((b, k)) < 0.25] = -1
        return keys

    if case == "m0":
        return np.zeros((0, 40), np.int32)
    if case == "m1":
        return np.array([[t - 1]], np.int32)
    if case == "all-padding":
        return np.full((512, 40), -1, np.int32)
    if case == "one-key-every-row":
        keys = rows(512, 40)
        keys[:, 0] = 4242
        return keys
    if case == "keys-minus-one-last-and-t":
        keys = rows(512, 40)
        keys[:, 1], keys[:, 2], keys[:, 3] = -1, t - 1, t
        return keys
    if case == "threshold":
        return rows(K4_SLICE_MAX // 32, 32)
    if case == "past-threshold":
        return rows(1, K4_SLICE_MAX + 1)
    return rows(65_536, 40)


K4_EDGE_CASES = ("m0", "m1", "all-padding", "one-key-every-row",
                 "keys-minus-one-last-and-t", "threshold", "past-threshold", "batch-65536")


@pytest.mark.parametrize("case", K4_EDGE_CASES)
def test_k4_edge_cases_match_plain(dev, case):
    """K4 against its plain version, exactly: the same count and key set,
    every live occurrence's slot holding its own key, padding -1, and
    the map holding each unique key's slot and -1 elsewhere; one launch
    a call (the slice form up to K4_SLICE_MAX keys, the batch form past
    it: both sides of the threshold are cases)."""
    t = 1 << 20
    keys = torch.tensor(_k4_keys(case, t), device=dev)
    m = keys.numel()
    live = (keys >= 0) & (keys < t)
    distinct = torch.unique(keys[live])
    slot_map = torch.full((t,), -1, dtype=torch.int32, device=dev)
    puk, pcnt, psl = _plan(keys, t, dev)
    ukeys = torch.full((max(m, 1),), 123, dtype=torch.int32, device=dev)
    count = torch.full((1,), 77, dtype=torch.int32, device=dev)
    slots = torch.empty_like(keys)
    before = consolidate_keys.launches
    consolidate_keys(keys, t, ukeys, count, slots, slot_map)
    torch.cuda.synchronize()
    assert consolidate_keys.launches - before == 1
    n = int(count)
    assert n == int(pcnt) == distinct.numel()
    assert torch.equal(torch.sort(ukeys[:n]).values, puk[:n])
    assert torch.equal(ukeys[slots[live].long()], keys[live])
    assert bool((slots[~live] == -1).all())
    assert int((slot_map >= 0).sum()) == n
    assert torch.equal(slot_map[ukeys[:n].long()],
                       torch.arange(n, dtype=torch.int32, device=dev))


K5_WIDTHS = {"fm": (1, 10), "ffm": (1, 156), "wide_deep": (1, 8)}


def _k5_tables(widths, opt, dv, t_size, cap, h, fold):
    r = np.random.default_rng(8)

    def arr(shape):
        return torch.tensor(r.standard_normal(shape).astype(np.float32), device=dv)

    tables, gsums, heads = [], [], []
    for d in widths:
        table = {"param": arr((t_size, d))}
        if isinstance(opt, FTRL):
            table["n"] = arr((t_size, d)).abs()
            table["z"] = arr((t_size, d))
        tables.append(table)
        gsums.append(arr((cap, d)))
        heads.append(arr((h, d)) if fold else None)
    return tables, gsums, heads if fold else None


@pytest.mark.parametrize("fold", [False, True], ids=["plain", "fold"])
@pytest.mark.parametrize("widths", list(K5_WIDTHS))
@pytest.mark.parametrize("opt", [FTRL(), SGD(lr=0.05)], ids=["ftrl", "sgd"])
def test_k5_tables_in_one_launch_match_plain(dev, opt, widths, fold):
    """One K5 launch steps both tables of an update (widths 1 + 10, 1 +
    156, 1 + 8), with and without the fold: the stepped rows within
    phase 7's per-element bound of the plain per-table version, every
    other row bit-identical, the head buffers as the plain fold's,
    gsum cleared and the map reset at the keys, once a row."""
    t_size, h, cap, n = 1 << 12, 1 << 8, 1024, 700
    rng = np.random.default_rng(7)
    ukeys_np = rng.permutation(t_size)[:900].astype(np.int32)
    states = []
    for dv in (dev, torch.device("cpu")):
        tables, gsums, heads = _k5_tables(K5_WIDTHS[widths], opt, dv, t_size, cap, h, fold)
        before = [{k: a.cpu().clone() for k, a in tb.items()} for tb in tables]
        g_before = [g.cpu().clone() for g in gsums]
        ukeys = torch.zeros(cap, dtype=torch.int32, device=dv)
        ukeys[:900] = torch.tensor(ukeys_np, device=dv)
        count = torch.tensor([n], dtype=torch.int32, device=dv)
        smap = torch.full((t_size,), 5, dtype=torch.int32, device=dv) \
            if dv.type == "cuda" else None
        launched = touched_update.launches
        touched_update(tables, opt, ukeys, count, gsums, smap, head=heads,
                       hot_size=h if fold else 0)
        if dv.type == "cuda":
            torch.cuda.synchronize()
            assert touched_update.launches - launched == 1
            assert bool((smap[ukeys[:n].long()] == -1).all())
            untouched_map = torch.ones(t_size, dtype=torch.bool, device=dv)
            untouched_map[ukeys[:n].long()] = False
            assert bool((smap[untouched_map] == 5).all())
        states.append((tables, gsums, heads))
    (ct, cg, ch), (pt, pg, ph) = states
    keys = torch.tensor(ukeys_np[:n]).long()
    stepped = keys >= h if fold else torch.ones(n, dtype=torch.bool)
    rows = keys[stepped]
    for i in range(len(ct)):
        assert not cg[i][:n].any() and not pg[i][:n].any()
        assert torch.equal(cg[i][n:].cpu(), g_before[i][n:])
        if fold:
            _close(ch[i], ph[i])
        tols = _k3_tolerances({k: a[rows] for k, a in before[i].items()},
                              g_before[i][:n][stepped],
                              pt[i]["n"][rows] if "n" in pt[i] else None, opt)
        for k, tol in tols.items():
            got, want = ct[i][k].cpu()[rows].double(), pt[i][k][rows].double()
            assert float(((got - want).abs() - tol).max()) <= 0, (widths, i, k)
            untouched = torch.ones(t_size, dtype=torch.bool)
            untouched[rows] = False
            assert torch.equal(ct[i][k].cpu()[untouched], before[i][k][untouched])


K5_LIVE = {  # (table rows, cap, live rows, H): row-major, and table-major
    # past the rows one pass of the grid covers (with the fold)
    "u0": (1 << 12, 512, 0, 0), "ucap": (1 << 12, 512, 512, 0),
    "table-major": (1 << 18, 65_536, 65_536, 0),
    "table-major-fold": (1 << 18, 65_536, 60_000, 1 << 10),
}


@pytest.mark.parametrize("live", list(K5_LIVE))
def test_k5_no_rows_and_every_row(dev, live):
    """K5 over two tables (widths 1 + 10) with count 0 (nothing moves,
    gsum kept), with count = cap (every slot's row steps), and past the
    rows one pass of its grid covers (the table-major order), with and
    without the fold: within phase 7's bound of the plain version, the
    map reset at the live keys alone."""
    t_size, cap, n, h = K5_LIVE[live]
    opt = FTRL()
    ukeys_np = np.random.default_rng(9).permutation(t_size)[:cap].astype(np.int32)
    states = []
    for dv in (dev, torch.device("cpu")):
        tables, gsums, heads = _k5_tables((1, 10), opt, dv, t_size, cap, h, h > 0)
        before = [{k: a.cpu().clone() for k, a in tb.items()} for tb in tables]
        g_before = [g.cpu().clone() for g in gsums]
        ukeys = torch.tensor(ukeys_np, device=dv)
        count = torch.tensor([n], dtype=torch.int32, device=dv)
        smap = torch.full((t_size,), 3, dtype=torch.int32, device=dv) \
            if dv.type == "cuda" else None
        touched_update(tables, opt, ukeys, count, gsums, smap, head=heads, hot_size=h)
        if dv.type == "cuda":
            torch.cuda.synchronize()
            assert int((smap == -1).sum()) == n
            assert bool((smap[ukeys[:n].long()] == -1).all())
        states.append((tables, gsums, heads))
    (ct, cg, ch), (pt, pg, ph) = states
    for i in range(2):
        if n == 0:
            assert torch.equal(cg[i].cpu(), g_before[i])
            for k in ct[i]:
                assert torch.equal(ct[i][k].cpu(), before[i][k])
            continue
        assert not cg[i][:n].any() and not pg[i][:n].any()
        if h:
            _close(ch[i], ph[i])
        keys = torch.tensor(ukeys_np[:n]).long()
        rows = keys[keys >= h]
        tols = _k3_tolerances({k: a[rows] for k, a in before[i].items()},
                              g_before[i][:n][keys >= h], pt[i]["n"][rows], opt)
        for k, tol in tols.items():
            diff = (ct[i][k].cpu()[rows].double() - pt[i][k][rows].double()).abs()
            assert float((diff - tol).max()) <= 0, (i, k)
            untouched = torch.ones(t_size, dtype=torch.bool)
            untouched[rows] = False
            assert torch.equal(ct[i][k].cpu()[untouched], before[i][k][untouched])


# -- C5: the field forms' device-memory stage past the shared-memory caps ----

def _k2_field_pair(dev, m, form, index, with_w):
    """K2 (kernel, then plain) in the MVM or FFM form over the planes
    ``m``, into [T, D] buffers or (``index``) K4's plain slots; returns
    [(g_w, g_v, acc)] for each side."""
    t_size, e = m["v"].shape
    b = m["keys"].shape[0]
    outs = []
    for kernel in (True, False):
        dv = dev if kernel else torch.device("cpu")
        t = lambda a: None if a is None else torch.tensor(a, device=dv)  # noqa: E731
        tk = t(m["keys"])
        rows = m["keys"].size if index else t_size
        g_w = torch.zeros((rows, 1), device=dv) if with_w else None
        g_v = torch.zeros((rows, e), device=dv)
        slots = None
        if index:
            slots = torch.empty_like(tk)
            consolidate_keys_plain(tk, t_size, torch.empty(rows, dtype=torch.int32, device=dv),
                                   torch.zeros(1, dtype=torch.int32, device=dv), slots)
        hot = t(m["hot"])
        hg = {}
        if hot is not None:
            hg["hg_v"] = torch.zeros((m["h"], e), device=dv) if index else g_v[:m["h"]]
            if with_w:
                hg["hg_w"] = torch.zeros((m["h"], 1), device=dv) if index else g_w[:m["h"]]
        acc = torch.zeros(2, dtype=torch.float64, device=dv)
        fn = train_step if kernel else train_plain
        fn(tk, t(m["x"]), t(m["labels"]), t(np.ones(b, np.float32)), float(b),
           t(m.get("w")), t(m["v"]), g_w, g_v, acc, slots=slots, hot=hot, hot_x=t(m["hot_x"]),
           hot_size=m["h"] if hot is not None else 0, fields=t(m["fields"]),
           hot_fields=t(m["hot_fields"]), max_fields=m.get("s", m.get("f")), form=form,
           **hg)
        outs.append((g_w, g_v, hg.get("hg_v"), acc))
    torch.cuda.synchronize()
    return outs


C5_CASES = ("mvm-1600", "ffm-f256", "pooled-4200")


@pytest.mark.parametrize("case", C5_CASES)
def test_c5_device_memory_stage_matches_plain(dev, case):
    """Past each shared-memory cap (MVM at 1,600 slots, FFM at
    max_fields 256 with 40 slots, a pooled row of 4,200 slots) the
    kernels stage a row in device memory (K1, K2, K7; K8 stages a chunk
    of the row's slots at a time), dense and index mode, against their
    plain versions at B = 64."""
    from xflow_tpu_torch.ops.pool import (
        POOL_MAX_SLOTS,
        field_pool,
        field_pool_grad,
        field_pool_grad_plain,
        field_pool_plain,
    )
    from xflow_tpu_torch.ops.score import ffm_stage_global, mvm_stage_global

    before = (score.launches, train_step.launches, field_pool.launches,
              field_pool_grad.launches)
    if case != "pooled-4200":
        if case == "mvm-1600":
            m = _mvm_inputs(5, b=64, k=1568, kh=32, h=1 << 10, vscale=0.01)
            form, w = "mvm", None
            assert mvm_stage_global(1600)
        else:
            m = _ffm_inputs(5, b=64, k=40, f=256, d=4, t=1 << 12)
            form, w = "ffm", m["w"]
            assert ffm_stage_global(256, 40)
        t = lambda a: None if a is None else torch.tensor(a, device=dev)  # noqa: E731
        kw = dict(hot=t(m["hot"]), hot_x=t(m["hot_x"]),
                  hot_size=m["h"] if m["hot"] is not None else 0, fields=t(m["fields"]),
                  hot_fields=t(m["hot_fields"]), max_fields=m.get("s", m.get("f")), form=form)
        got = score(t(m["keys"]), t(m["x"]), t(w), t(m["v"]), return_logit=True, **kw)
        want = score_plain(t(m["keys"]), t(m["x"]), t(w), t(m["v"]), True, **kw)
        torch.cuda.synchronize()
        for g, p in zip(got, want):
            _close(g, p)
        for index in (False, True):
            for got_t, want_t in zip(*_k2_field_pair(dev, m, form, index, w is not None)):
                if got_t is not None:
                    _close(got_t, want_t)
        assert (score.launches - before[0], train_step.launches - before[1]) == (1, 2)
        return
    on, cpu = _pool_planes(dev, 7, b=64, k=4200)
    assert 4200 > POOL_MAX_SLOTS
    f, e, t_size = 39, 8, on["emb"].shape[0]
    pooled, wide = field_pool(on["keys"], on["x"], on["fields"], on["emb"], f, w=on["w"])
    want_p, want_w = field_pool_plain(cpu["keys"], cpu["x"], cpu["fields"], cpu["emb"], f,
                                      w=cpu["w"])
    torch.cuda.synchronize()
    _close(pooled, want_p)
    _close(wide, want_w)
    rng = np.random.default_rng(6)
    b = on["keys"].shape[0]
    src = {"dP": rng.standard_normal((b, f, e)).astype(np.float32) * 1e-3,
           "r": rng.standard_normal(b).astype(np.float32) * 1e-3,
           "logit": rng.standard_normal(b).astype(np.float32) * 4,
           "labels": (rng.random(b) < 0.4).astype(np.uint8),
           "weights": np.ones(b, np.uint8)}
    for index in (False, True):
        results = []
        for fn, p in ((field_pool_grad, on), (field_pool_grad_plain, cpu)):
            d = p["keys"].device
            s = {n: torch.tensor(a, device=d) for n, a in src.items()}
            rows = p["keys"].numel() if index else t_size
            g_emb, g_w = torch.zeros(rows, e, device=d), torch.zeros(rows, 1, device=d)
            slots = None
            if index:
                plan = torch.empty_like(p["keys"].cpu())
                consolidate_keys_plain(p["keys"].cpu(), t_size,
                                       torch.empty(rows, dtype=torch.int32),
                                       torch.zeros(1, dtype=torch.int32), plan)
                slots = plan.to(d)
            acc = torch.zeros(2, dtype=torch.float64, device=d)
            fn(p["keys"], p["x"], p["fields"], s["dP"], s["r"], s["logit"], s["labels"],
               s["weights"], f, g_emb, acc, g_w=g_w, slots=slots)
            results.append((g_emb, g_w, acc))
        torch.cuda.synchronize()
        (ge, gw, ga), (pe, pw, pa) = results
        _close(ge, pe)
        _close(gw, pw)
        np.testing.assert_allclose(float(ga[0]), float(pa[0]), rtol=1e-5)
    assert (field_pool.launches - before[2], field_pool_grad.launches - before[3]) == (1, 2)
