"""K1's plain version and the port's predict step against the
reference's predict (``_expand_wire`` → gather → model logit →
``sigmoid_ref``), run as the reference's own tests run it, on the CPU.
Tolerance rtol 1e-5 / atol 1e-6 (tests/test_ftrl.py's bar): the
reference jits through XLA, the port runs eager PyTorch, and the two
sum in different orders.  For the logit, rtol applies to the magnitude
of the summed terms (``_logit_scale``), not to the result: FM's
``sum_d(s_d^2 - s2_d)`` cancels, so a logit near 0 can carry the
rounding of terms in the hundreds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.io.batch import Batch as RefBatch
from xflow_tpu.models import make_model as ref_make_model
from xflow_tpu.optim import make_optimizer
from xflow_tpu.parallel.mesh import make_mesh
from xflow_tpu.parallel.step import TrainStep
from xflow_tpu.utils.metrics import sigmoid_ref as ref_sigmoid
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.io.batch import Batch
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.ops.score import MAX_DIM, score, score_plain
from xflow_tpu_torch.parallel.step import PredictStep
from xflow_tpu_torch.utils.metrics import sigmoid_ref

B, K, D, T_LOG2 = 64, 40, 10, 12
RTOL, ATOL = 1e-5, 1e-6


def _tables(seed=0):
    """w/v with rows [0, 16) at +20 and [16, 32) at -20: rows steered
    onto them land past the +-30 clamps."""
    rng = np.random.default_rng(seed)
    t = 1 << T_LOG2
    w = (rng.standard_normal((t, 1)) * 2.0).astype(np.float32)
    v = (rng.standard_normal((t, D)) * 0.3).astype(np.float32)
    w[:16], w[16:32] = 20.0, -20.0
    return w, v


def _planes(seed=1, values=False):
    """Padded [B, K] planes: ragged rows with holes, all-padding rows,
    clamp rows; values other than 1 when ``values``."""
    rng = np.random.default_rng(seed)
    t = 1 << T_LOG2
    keys = rng.integers(32, t, size=(B, K)).astype(np.int32)
    lengths = rng.integers(1, K + 1, size=(B, 1))
    mask = (np.arange(K)[None, :] < lengths) & (rng.random((B, K)) > 0.1)
    mask[::9] = False  # rows that are all padding
    rows = np.arange(B)
    keys[rows % 5 == 1, :3] = rng.integers(0, 16, size=(np.sum(rows % 5 == 1), 3))
    keys[rows % 5 == 2, :3] = rng.integers(16, 32, size=(np.sum(rows % 5 == 2), 3))
    mask[(rows % 5 == 1) | (rows % 5 == 2), :3] = True
    mask = mask.astype(np.float32)
    keys = np.where(mask > 0, keys, 0).astype(np.int32)
    vals = (rng.uniform(0.25, 2.0, size=(B, K)) if values else np.ones((B, K))).astype(np.float32)
    # padding slots carry junk values: the mask must kill them
    vals = np.where(mask > 0, vals, 7.0).astype(np.float32)
    return keys, vals, mask


def _batch(cls, keys, vals, mask):
    return cls(
        keys=keys, slots=np.zeros_like(keys), vals=vals, mask=mask,
        labels=np.zeros(B, np.float32), weights=np.ones(B, np.float32),
    )


def _reference(model, wire, w, v, keys, vals, mask):
    """(pctr, logit) of the reference's predict on these planes."""
    cfg = RefConfig(model=model, table_size_log2=T_LOG2, max_nnz=K,
                    v_dim=D, wire_mode=wire)
    ref_model = ref_make_model(cfg)
    step = TrainStep(ref_model, make_optimizer(cfg), cfg, make_mesh(1))
    tables = {"w": {"param": jnp.asarray(w)}}
    if model == "fm":
        tables["v"] = {"param": jnp.asarray(v)}
    state = {"tables": tables, "dense": {}, "step": jnp.zeros((), jnp.int32)}
    arrays = step.put_batch(_batch(RefBatch, keys, vals, mask))
    pctr = step.predict(state, arrays)
    exp = step._expand_wire(arrays)
    logit = ref_model.logit(step._gather_model_rows(tables, exp), exp)
    return np.asarray(pctr), np.asarray(logit)


def _logit_scale(w_rows, v_rows, x):
    """float64 sum of the absolute terms each logit adds up, from
    gathered rows and masked values: sum_k |w x| + sum_d (s_d^2 + s2_d)
    for FM (v_rows not None)."""
    x = x.astype(np.float64)
    scale = np.abs(w_rows[..., 0] * x).sum(1)
    if v_rows is not None:
        vx = v_rows * x[..., None]
        scale += (vx.sum(1) ** 2 + (vx * vx).sum(1)).sum(1)
    return scale


def _assert_logit_close(got, want, scale):
    excess = np.abs(got - want) - (ATOL + RTOL * scale)
    assert excess.max() <= 0, f"logit off by {np.abs(got - want).max()}"


CASES = [("lr", "compact"), ("lr", "full"), ("fm", "compact"), ("fm", "full")]


@pytest.mark.parametrize("model,wire", CASES)
def test_score_plain_matches_reference_predict(model, wire):
    w, v = _tables()
    keys, vals, mask = _planes(values=wire == "full")
    want_p, want_l = _reference(model, wire, w, v, keys, vals, mask)
    ckeys = torch.from_numpy(np.where(mask > 0, keys, -1).astype(np.int32))
    x = torch.from_numpy(vals * mask) if wire == "full" else None
    got_p, got_l = score_plain(
        ckeys, x, torch.from_numpy(w),
        torch.from_numpy(v) if model == "fm" else None, return_logit=True,
    )
    # the cases must reach both clamps and all-padding rows
    assert (want_l > 30).any() and (want_l < -30).any()
    assert (mask.sum(1) == 0).any()
    _assert_logit_close(got_l.numpy(), want_l, _logit_scale(
        w[keys], v[keys] if model == "fm" else None, vals * mask))
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("model,wire", CASES)
def test_predict_step_matches_reference_step(model, wire):
    """PredictStep's wire + predict on the CPU against TrainStep's
    put_batch + jitted predict, from the same Batch."""
    w, v = _tables(seed=2)
    keys, vals, mask = _planes(seed=3, values=wire == "full")
    want, _ = _reference(model, wire, w, v, keys, vals, mask)
    cfg = Config(model=model, table_size_log2=T_LOG2, max_nnz=K, v_dim=D,
                 wire_mode=wire)
    step = PredictStep(make_model(cfg), cfg, torch.device("cpu"))
    assert step.compact_wire == (wire == "compact")
    tables = {"w": {"param": torch.from_numpy(w)}}
    if model == "fm":
        tables["v"] = {"param": torch.from_numpy(v)}
    got = step.predict({"tables": tables}, step.put_batch(_batch(Batch, keys, vals, mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("model", ["lr", "fm"])
def test_model_logit_matches_reference(model):
    rng = np.random.default_rng(4)
    rows = {"w": rng.standard_normal((B, K, 1)).astype(np.float32),
            "v": rng.standard_normal((B, K, D)).astype(np.float32)}
    keys, vals, mask = _planes(seed=5, values=True)
    batch = {"keys": keys, "vals": vals, "mask": mask}
    cfg = dict(model=model, v_dim=D)
    want = ref_make_model(RefConfig(**cfg)).logit(
        {k: jnp.asarray(a) for k, a in rows.items()},
        {k: jnp.asarray(a) for k, a in batch.items()},
    )
    got = make_model(Config(**cfg)).logit(
        {k: torch.from_numpy(a) for k, a in rows.items()},
        {k: torch.from_numpy(a) for k, a in batch.items()},
    )
    _assert_logit_close(got.numpy(), np.asarray(want), _logit_scale(
        rows["w"], rows["v"] if model == "fm" else None, vals * mask))


def test_sigmoid_ref_clamps_like_reference():
    x = np.array([-1e4, -30.5, -30.0, -29.99, -5, 0, 5, 29.99, 30.0,
                  30.0001, 1e4], np.float32)
    got = sigmoid_ref(torch.from_numpy(x)).numpy()
    want = np.asarray(ref_sigmoid(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[0] == np.float32(1e-6) and got[-1] == 1.0


def test_wrapper_on_cpu_takes_plain_version_without_counting():
    w, v = _tables()
    keys, vals, mask = _planes()
    ckeys = torch.from_numpy(np.where(mask > 0, keys, -1).astype(np.int32))
    before = score.launches
    got = score(ckeys, None, torch.from_numpy(w), torch.from_numpy(v))
    want = score_plain(ckeys, None, torch.from_numpy(w), torch.from_numpy(v))
    assert torch.equal(got, want)
    assert score.launches == before  # counts kernel launches only


def test_wrapper_rejects_bad_inputs():
    w = torch.zeros((64, 1))
    keys = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        score(keys.long(), None, w, None)
    with pytest.raises(ValueError, match="w must be"):
        score(keys, None, w.double(), None)
    with pytest.raises(ValueError, match="x must be"):
        score(keys, torch.ones((2, 4)), w, None)
    with pytest.raises(ValueError, match="outside"):
        score(keys, None, w, torch.zeros((64, MAX_DIM + 1)))
    with pytest.raises(ValueError, match="contiguous"):
        score(torch.zeros((3, 2), dtype=torch.int32).t(), None, w, None)


@pytest.mark.cuda
@pytest.mark.parametrize("model,wire", CASES)
def test_kernel_matches_plain_on_card(model, wire):
    """K1 against its plain version on the card (chip_smoke.py runs the
    same check at full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    w, v = _tables()
    keys, vals, mask = _planes(values=wire == "full")
    dev = torch.device("cuda")
    ckeys = torch.from_numpy(np.where(mask > 0, keys, -1).astype(np.int32)).to(dev)
    x = torch.from_numpy(vals * mask).to(dev) if wire == "full" else None
    wt = torch.from_numpy(w).to(dev)
    vt = torch.from_numpy(v).to(dev) if model == "fm" else None
    before = score.launches
    got_p, got_l = score(ckeys, x, wt, vt, return_logit=True)
    want_p, want_l = score_plain(ckeys, x, wt, vt, return_logit=True)
    torch.cuda.synchronize()
    assert score.launches == before + 1
    # logit rtol/atol 1e-5 (another summation order); pctr atol 1e-6 plus
    # that logit tolerance through the sigmoid's slope p(1-p)
    ltol = 1e-5 + 1e-5 * want_l.abs()
    assert bool(((got_l - want_l).abs() <= ltol).all())
    ptol = 1e-6 + want_p * (1 - want_p) * ltol
    assert bool(((got_p - want_p).abs() <= ptol).all())
