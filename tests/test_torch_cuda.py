"""The port's kernels and training step on the card, against their plain
PyTorch versions on the same inputs.  Every test carries the ``cuda``
marker and skips without a card.  The file imports neither JAX nor the
reference package, so it runs where the port runs:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which the port's
machines need not have.)  Tolerances: K1 and K2 rtol 1e-5 with an atol
of 1e-5 of the largest magnitude compared — the kernels sum in another
order than the plain versions (K2's atomics in any order); K3 rtol
1e-5 / atol 1e-6 (tests/test_ftrl.py's bar; nvcc contracts n + g*g to
an FMA), and the same for K2's index mode and K5; K4's keys, count and
slots exactly.  The full-width checks, with bounds derived per element,
are chip_smoke.py's phases 2, 6, 7 and 10."""

import numpy as np
import pytest
import torch

from xflow_tpu_torch.config import Config
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.ops.optim import optim_plain, optim_update
from xflow_tpu_torch.ops.score import score, score_plain
from xflow_tpu_torch.ops.sparse import (
    consolidate_keys,
    consolidate_keys_plain,
    touched_plain,
    touched_update,
)
from xflow_tpu_torch.ops.train import train_plain, train_step
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
    from xflow_tpu_torch.io.batch import Batch

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
