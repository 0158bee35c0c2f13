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



# K3 (csrc/optim.cu) leaves every 16-byte group whose gradient is zero as
# it is.  That is exact because FTRL and SGD leave a row whose g is 0 bit
# for bit as it was, for any state they produced: the tests below pin
# that property on the port's plain version and on the reference's
# jitted update_rows, over the kinds of rows a trained table holds.
ZERO_G_KINDS = ("touched", "never_touched", "at_l1")
STEPS = 5


def _trained_rows(opt_name, dim, seed=7):
    """A [ROWS, dim] table after STEPS plain steps from the port's init
    (w random, n = z = 0) on random sparse gradients, with the last
    step's g: rows [0, 64) never get a gradient (n == 0, the init kept);
    rows [64, 128) start at w = 0 and take +-lambda1 (and its float32
    neighbours) once, so |z| lands at lambda1 with w = 0; the others take
    a gradient on a tenth of the steps' rows.  The last g is zero on
    every other row.  Returns the initial state, the gradients and the
    row kinds."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((ROWS, dim)) * 0.01).astype(np.float32)
    w[64:128] = 0.0
    grads = []
    for step in range(STEPS + 1):
        g = np.where(rng.random((ROWS, 1)) < 0.1,
                     rng.standard_normal((ROWS, dim)) * 0.01, 0.0).astype(np.float32)
        g[:128] = 0.0
        if step == 0:
            sign = np.where(rng.random((64, dim)) > 0.5, 1.0, -1.0)
            nudge = rng.integers(-1, 2, (64, dim))
            g[64:128] = (sign * np.float32(L1)).astype(np.float32)
            g[64:128] = np.where(nudge > 0, np.nextafter(g[64:128], np.float32(np.inf)),
                                 np.where(nudge < 0, np.nextafter(g[64:128], np.float32(0)),
                                          g[64:128])).astype(np.float32)
        if step == STEPS:
            g[1::2] = 0.0  # the last step: every other row untouched
        grads.append(g)
    kinds = {"touched": np.arange(128, ROWS), "never_touched": np.arange(0, 64),
             "at_l1": np.arange(64, 128)}
    return w, grads, kinds


def _steps_port(opt, w, grads):
    table = {"param": torch.tensor(w), "g": torch.zeros(w.shape)}
    table.update(opt.init_aux(table["param"]))
    for g in grads[:-1]:
        table["g"].copy_(torch.tensor(g))
        optim_plain(table, opt)
    before = {k: t.clone() for k, t in table.items() if k != "g"}
    table["g"].copy_(torch.tensor(grads[-1]))
    optim_plain(table, opt)
    return before, {k: t for k, t in table.items() if k != "g"}


def _steps_reference(opt_name, w, grads):
    ref = RefFTRL(ALPHA, BETA, L1, L2) if opt_name == "ftrl" else RefSGD(lr=0.05)
    update = jax.jit(ref.update_rows)
    rows = {"param": jnp.asarray(w)}
    if opt_name == "ftrl":
        rows.update(n=jnp.zeros_like(rows["param"]), z=jnp.zeros_like(rows["param"]))
    for g in grads[:-1]:
        rows = update(rows, jnp.asarray(g))
    before = {k: torch.tensor(np.asarray(a)) for k, a in rows.items()}
    after = {k: torch.tensor(np.asarray(a))
             for k, a in update(rows, jnp.asarray(grads[-1])).items()}
    return before, after


@pytest.mark.parametrize("kind", ZERO_G_KINDS)
@pytest.mark.parametrize("dim", [1, 10])
@pytest.mark.parametrize("opt_name", ["ftrl", "sgd"])
@pytest.mark.parametrize("side", ["port", "reference"])
def test_zero_gradient_rows_stay_bit_identical(side, opt_name, dim, kind):
    w, grads, kinds = _trained_rows(opt_name, dim)
    opt = FTRL(ALPHA, BETA, L1, L2) if opt_name == "ftrl" else SGD(lr=0.05)
    if side == "port":
        before, after = _steps_port(opt, w, grads)
    else:
        before, after = _steps_reference(opt_name, w, grads)
    zero = np.flatnonzero(~grads[-1].any(axis=1))
    rows = torch.tensor(np.intersect1d(zero, kinds[kind]))
    moved = np.flatnonzero(grads[-1].any(axis=1))
    assert len(rows) >= 32
    for key in before:
        b, a = before[key][rows], after[key][rows]
        assert torch.equal(b.view(torch.int32), a.view(torch.int32)), key
        # the step did move the rows it had a gradient for
        assert not torch.equal(before[key][moved], after[key][moved]), key
    if opt_name == "ftrl":
        n = before["n"][rows]
        if kind == "never_touched":
            assert not n.any()
            assert torch.equal(before["param"][rows], torch.tensor(w)[rows])
        elif kind == "at_l1":
            z = before["z"][rows].abs()
            assert bool((n > 0).all())
            assert bool(((z - L1).abs() <= 2 * np.spacing(np.float32(L1))).all())
            assert bool((z == np.float32(L1)).any())


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("opt_name", ["ftrl", "sgd"])
@pytest.mark.parametrize("case", ["sparse", "zero", "dense", "ragged"])
def test_k3_bounds_count_touched_sectors(opt_name, case):
    """chip_smoke.py's k3_bounds, K3's least bytes for a given g: 4 B an
    element of g read, plus 7 (FTRL) or 3 (SGD) 32-byte sectors of state
    and g for each sector of g with a nonzero bit (-0.0 included);
    ``bound_full_ms`` the old full pass's 32 or 16 B an element."""
    cs = _chip_smoke()
    ftrl = opt_name == "ftrl"
    shape = (12, 1) if case == "ragged" else (64, 10)
    g = torch.zeros(shape)
    if case == "sparse":
        g[3, 0] = 1.0  # element 30: sector 3
        g[3, 9] = 2.0  # element 39: sector 4
        g[10, 5] = -0.0  # element 105: sector 13, by its sign bit alone
        g[10, 6] = 5.0  # element 106: sector 13 again
        touched = 3
    elif case == "zero":
        touched = 0
    elif case == "dense":
        g.fill_(0.5)
        touched = g.numel() // 8
    else:  # 12 elements: a second, padded sector holds elements 8-11
        g[9, 0] = 1.0
        touched = 1
    count = g.numel()
    got = cs.k3_bounds(g, ftrl)
    per_sector = 32 * (7 if ftrl else 3)
    assert got["touched_sectors"] == touched
    assert got["sectors"] == -(-count // 8)
    assert got["bound_bytes"] == 4 * count + touched * per_sector
    assert got["bound_full_bytes"] == count * (32 if ftrl else 16)
    assert got["bound_ms"] == pytest.approx(max(
        got["bound_bytes"] / cs.HBM_BYTES_PER_S * 1e3,
        got["bound_ops"] / cs.FP32_FLOPS_PER_S * 1e3))
    assert got["bound_ms"] <= got["bound_full_ms"]


@pytest.mark.parametrize("second_g", [0.0, 2.0 ** -24 / 65536 * 0.008, 1e-6])
def test_compare_states_verifies_the_n0_split(second_g):
    """chip_smoke.py's compare_states on two FTRL runs of one step from
    the same init, the first element's gradient 0 on one side and
    ``second_g`` on the other (the rest of the table identical): equal
    runs pass with no split; a saturated example's gradient (2^-24 /
    num_real x |S - v|) keeps w's init on one side and zeroes it on the
    other, which passes as one rounding touch; a real gradient there is
    a breach, and raises."""
    from xflow_tpu_torch.ops.optim import optim_plain
    from xflow_tpu_torch.optim import FTRL

    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(3)
    init = torch.randn((64, 10), generator=gen) * 0.01
    g = torch.randn((64, 10), generator=gen) * 1e-4
    g[0, 0] = 0.0
    states = []
    for first in (0.0, second_g):
        table = {"param": init.clone(), "n": torch.zeros_like(init),
                 "z": torch.zeros_like(init), "g": g.clone()}
        table["g"][0, 0] = first
        optim_plain(table, FTRL())
        states.append({"tables": {"v": table}})
    if second_g >= 1e-6:
        with pytest.raises(AssertionError, match="v.param"):
            cs.compare_states(*states)
        return
    got = cs.compare_states(*states)
    assert got["rounding_touches"] == (1 if second_g else 0)
    assert got["max_err_over_bound"] < 1.0
    if second_g:
        assert states[0]["tables"]["v"]["param"][0, 0] == init[0, 0]
        assert states[1]["tables"]["v"]["param"][0, 0] == 0.0
        assert 0.0 < got["rounding_touch_g_over_bound"] < 1.0
