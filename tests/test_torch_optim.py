"""The port's optimizers and K3's plain version against the reference's
``FTRL.update_rows`` / ``SGD.update_rows`` (jitted, on the CPU) on the
same numpy rows, and against the scalar golden recurrence.  Tolerance
rtol 1e-5 / atol 1e-6 — tests/test_ftrl.py:50-52's bar: jitted XLA
contracts ``n + g*g`` into an FMA and eager PyTorch does not (ROADMAP
parity bar).  FTRL's soft threshold is continuous in z', so a last-ulp
difference at |z'| = lambda1 moves w' by far less than that bar."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xflow_tpu.optim.ftrl import FTRL as RefFTRL
from xflow_tpu.optim.sgd import SGD as RefSGD
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.ops.optim import optim_plain, optim_update
from xflow_tpu_torch.optim import FTRL, SGD, make_optimizer

ALPHA, BETA, L1, L2 = 5e-2, 1.0, 5e-5, 10.0  # ftrl.h:17-20
RTOL, ATOL = 1e-5, 1e-6
ROWS = 4096


def ftrl_scalar(w, n, z, g):
    """Direct transcription of the recurrence (a copy of
    tests/test_ftrl.py::ftrl_scalar), in float32 like the reference's
    C++ floats (ftrl.h:27-36)."""
    f = np.float32
    w, n, z, g = f(w), f(n), f(z), f(g)
    n_new = f(n + f(g * g))
    sigma = f(f(np.sqrt(n_new) - np.sqrt(n)) / f(ALPHA))
    z_new = f(f(z + g) - f(sigma * w))
    if abs(z_new) <= f(L1):
        w_new = f(0.0)
    else:
        sign = f(1.0) if z_new > 0 else (f(-1.0) if z_new < 0 else f(0.0))
        w_new = f(
            f(f(sign * f(L1)) - z_new)
            / f(f(f(f(BETA) + np.sqrt(n_new)) / f(ALPHA)) + f(L2))
        )
    return w_new, n_new, z_new


def _rows(dim, seed=0):
    """[ROWS, dim] FTRL state and gradient: a quarter of the rows never
    touched (n = 0, g = 0), a quarter with g = 0 but n > 0, a band whose
    z' lands on +-lambda1 (w = 0, z = +-lambda1 - g), the rest random."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((ROWS, dim)) * 0.01).astype(np.float32)
    n = (rng.random((ROWS, dim)) * 1e-3).astype(np.float32)
    z = (rng.standard_normal((ROWS, dim)) * 1e-3).astype(np.float32)
    g = (rng.standard_normal((ROWS, dim)) * 0.01).astype(np.float32)
    q = ROWS // 4
    n[:q] = 0.0
    g[:q] = 0.0
    g[q:2 * q] = 0.0
    band = slice(2 * q, 2 * q + 256)
    sign = np.where(rng.random((256, dim)) > 0.5, 1.0, -1.0).astype(np.float32)
    z[band] = sign * np.float32(L1) - g[band]
    w[band] = 0.0
    return w, n, z, g


def _jax_ftrl(w, n, z, g):
    out = jax.jit(RefFTRL(ALPHA, BETA, L1, L2).update_rows)(
        {"param": jnp.asarray(w), "n": jnp.asarray(n), "z": jnp.asarray(z)},
        jnp.asarray(g),
    )
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("dim", [1, 10])
def test_ftrl_plain_matches_reference(dim):
    w, n, z, g = _rows(dim)
    want = _jax_ftrl(w, n, z, g)
    got = FTRL(ALPHA, BETA, L1, L2).update_rows(
        {"param": torch.tensor(w), "n": torch.tensor(n), "z": torch.tensor(z)},
        torch.tensor(g),
    )
    for key in ("param", "n", "z"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=RTOL, atol=ATOL)
    # never-touched rows keep their init exactly, in both packages
    q = ROWS // 4
    assert np.array_equal(got["param"][:q].numpy(), w[:q])
    assert np.array_equal(want["param"][:q], w[:q])
    # the band sits on the threshold: both zero or within the bar
    band = slice(2 * q, 2 * q + 256)
    assert np.all(np.abs(np.abs(want["z"][band]) - L1) < 1e-8)


@pytest.mark.parametrize("dim", [1, 10])
def test_sgd_plain_matches_reference(dim):
    w, _, _, g = _rows(dim, seed=1)
    want = np.asarray(jax.jit(RefSGD(lr=0.05).update_rows)(
        {"param": jnp.asarray(w)}, jnp.asarray(g)
    )["param"])
    got = SGD(lr=0.05).update_rows({"param": torch.tensor(w)}, torch.tensor(g))
    np.testing.assert_allclose(got["param"].numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("opt_name", ["ftrl", "sgd"])
@pytest.mark.parametrize("dim", [1, 10])
def test_k3_wrapper_on_cpu_updates_in_place_and_clears_g(opt_name, dim):
    w, n, z, g = _rows(dim, seed=2)
    opt = FTRL(ALPHA, BETA, L1, L2) if opt_name == "ftrl" else SGD(lr=0.05)
    table = {"param": torch.tensor(w), "g": torch.tensor(g)}
    if opt_name == "ftrl":
        table.update(n=torch.tensor(n), z=torch.tensor(z))
        want = _jax_ftrl(w, n, z, g)
    else:
        want = {"param": np.asarray(RefSGD(lr=0.05).update_rows(
            {"param": jnp.asarray(w)}, jnp.asarray(g))["param"])}
    ptrs = {k: t.data_ptr() for k, t in table.items()}
    before = optim_update.launches
    optim_update(table, opt)
    assert optim_update.launches == before  # CPU: the plain version, no launch
    assert {k: t.data_ptr() for k, t in table.items()} == ptrs  # in place
    assert not table["g"].any()
    for key, arr in want.items():
        np.testing.assert_allclose(table[key].numpy(), arr, rtol=RTOL, atol=ATOL)


def test_ftrl_sequence_golden():
    rng = np.random.default_rng(1)
    grads = rng.normal(0, 0.3, size=50)
    w = n = z = 0.0
    table = {k: torch.zeros((1, 1)) for k in ("param", "n", "z", "g")}
    opt = FTRL(ALPHA, BETA, L1, L2)
    for gv in grads:
        w, n, z = ftrl_scalar(w, n, z, float(gv))
        table["g"].fill_(float(np.float32(gv)))
        optim_plain(table, opt)
        assert np.isclose(float(table["param"][0, 0]), w, rtol=RTOL, atol=ATOL)
        assert np.isclose(float(table["n"][0, 0]), n, rtol=RTOL)
        assert np.isclose(float(table["z"][0, 0]), z, rtol=RTOL, atol=ATOL)


def test_ftrl_zero_grad_is_idempotent():
    """g=0 recomputes the same w from (z, n): the property that lets the
    dense pass run over every row."""
    rng = np.random.default_rng(2)
    opt = FTRL()
    rows = {
        "param": torch.zeros((8, 3)),
        "n": torch.tensor(np.abs(rng.normal(1, 1, (8, 3))), dtype=torch.float32),
        "z": torch.tensor(rng.normal(0, 1, (8, 3)), dtype=torch.float32),
    }
    once = opt.update_rows(rows, torch.zeros((8, 3)))
    twice = opt.update_rows(once, torch.zeros((8, 3)))
    for key in ("param", "n", "z"):
        assert torch.equal(once[key], twice[key])


def test_ftrl_l1_sparsity_and_sign_of_zero():
    opt = FTRL(lambda1=0.5)
    zero = torch.zeros((1, 1))
    out = opt.update_rows({"param": zero, "n": zero, "z": zero}, torch.full((1, 1), 0.1))
    assert float(out["param"][0, 0]) == 0.0 and float(out["z"][0, 0]) != 0.0
    # z' exactly 0 with n' > 0: sign(0) = 0 gives w' = 0, as the reference
    rows = {"param": torch.zeros((1, 1)), "n": torch.ones((1, 1)), "z": torch.zeros((1, 1))}
    assert float(FTRL(lambda1=0.0).update_rows(rows, torch.zeros((1, 1)))["param"]) == 0.0


def test_make_optimizer_and_aux():
    ftrl = make_optimizer(Config(optimizer="ftrl", alpha=0.1, lambda2=3.0))
    assert isinstance(ftrl, FTRL) and ftrl.alpha == 0.1 and ftrl.lambda2 == 3.0
    sgd = make_optimizer(Config(optimizer="sgd", sgd_lr=0.2))
    assert isinstance(sgd, SGD) and sgd.lr == 0.2
    param = torch.ones((4, 2))
    aux = ftrl.init_aux(param)
    assert set(aux) == {"n", "z"} and all(not a.any() for a in aux.values())
    assert sgd.init_aux(param) == {}


def test_k3_wrapper_rejects_bad_tables():
    opt = FTRL()
    good = {k: torch.zeros((8, 2)) for k in ("param", "n", "z", "g")}
    with pytest.raises(KeyError):
        optim_update({"param": good["param"], "g": good["g"]}, opt)
    with pytest.raises(ValueError, match="must be float32"):
        optim_update(dict(good, z=torch.zeros((8, 3))), opt)
    with pytest.raises(ValueError, match="contiguous"):
        optim_update(dict(good, g=torch.zeros((2, 8)).t()), opt)
    with pytest.raises(ValueError, match="unsupported optimizer"):
        optim_update(good, object())

