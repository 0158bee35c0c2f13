"""B11 in the port, on the CPU, against the reference (xflow_tpu):

* the plain ``field_sum_tower`` and the dense blocks (``flatten_tower``,
  ``mlp_head``, ``mlp_tower``, ``dot_interaction``, ``cross_network``)
  against ``xflow_tpu.models.blocks`` on the same numpy inputs, with
  padding, fields past ``max_fields`` and negative ones;
* K7's plain version (``field_pool`` on CPU tensors) against the
  reference's composition: ``hot_gather`` of the hot rows (bfloat16
  under ``mxu``), the cold rows, ``field_sum_tower`` and ``linear_term``
  of ``masked_x``, on the compact wire (u8 fields, 255 = out of range),
  the full wire (values, int32 fields with negative ids), with and
  without ``w``, the hot plane (u16 and int32 keys) and the window-start
  snapshot;
* K8's plain version against ``jax.grad`` of the tower and wide term
  scattered as the reference scatters (drop-mode ``.at[].add`` for the
  cold rows, ``hot_scatter`` for the hot ones, bfloat16 under the
  flag), and ``logloss_sum``; index mode against the dense scatter at
  K4's unique keys;
* the wrappers' refusals and the launch counters (CPU calls count no
  launch).

Tolerances: rtol 1e-5 / atol 1e-6 (ROADMAP's parity bar: sums in
another order than XLA's einsum)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xflow_tpu.models import blocks as ref_blocks
from xflow_tpu.ops.hot import hot_gather as ref_hot_gather
from xflow_tpu.ops.hot import hot_scatter as ref_hot_scatter
from xflow_tpu.utils.metrics import logloss_sum as ref_logloss_sum
from xflow_tpu.utils.metrics import sigmoid_ref as ref_sigmoid
from xflow_tpu.config import Config as RefConfig
from xflow_tpu.models import make_model as ref_make_model
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import state_from_numpy, state_to_numpy
from xflow_tpu_torch.models import blocks, make_model
from xflow_tpu_torch.ops.pool import field_pool, field_pool_grad
from xflow_tpu_torch.ops.sparse import consolidate_keys

RTOL, ATOL = 1e-5, 1e-6
T, E, F, B, K, KH, H = 1 << 10, 4, 6, 32, 10, 4, 64


def _np(t):
    return np.asarray(t)


# -- the blocks ------------------------------------------------------------------


def _tower_inputs(seed):
    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 0.3, (B, K, E)).astype(np.float32)
    x = (rng.uniform(0.5, 1.5, (B, K)) * (rng.random((B, K)) < 0.8)).astype(np.float32)
    slots = rng.integers(-2, F + 3, (B, K)).astype(np.int32)
    return emb, x, slots


@pytest.mark.parametrize("seed", [0, 1])
def test_field_sum_tower_matches_reference(seed):
    emb, x, slots = _tower_inputs(seed)
    want = ref_blocks.field_sum_tower(jnp.asarray(emb), jnp.asarray(x), jnp.asarray(slots), F)
    got = blocks.field_sum_tower(torch.tensor(emb), torch.tensor(x),
                                 torch.tensor(slots).long(), F)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    # out-of-range and negative fields drop out
    outside = (slots < 0) | (slots >= F)
    assert outside.any()
    kept = np.where(outside, 0.0, x)
    again = blocks.field_sum_tower(torch.tensor(emb), torch.tensor(kept),
                                   torch.tensor(slots).long(), F)
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    np.testing.assert_array_equal(blocks.flatten_tower(got).numpy(),
                                  _np(ref_blocks.flatten_tower(want)))


def _dense_pair(init_ref, init_port, seed):
    """The reference's init (JAX PRNG) carried to the port by name, and
    the port's own draw: same keys and shapes."""
    ref = {k: _np(v) for k, v in init_ref(jax.random.PRNGKey(seed)).items()}
    port = init_port(torch.Generator().manual_seed(seed))
    assert {k: v.shape for k, v in ref.items()} == {k: tuple(v.shape) for k, v in port.items()}
    return ref, {k: torch.tensor(v) for k, v in ref.items()}


def test_mlp_blocks_match_reference():
    rng = np.random.default_rng(3)
    h = rng.normal(0, 1, (B, 12)).astype(np.float32)
    ref, port = _dense_pair(lambda k: ref_blocks.mlp_head_init(k, 12, 8),
                            lambda g: blocks.mlp_head_init(g, 12, 8), 0)
    want = ref_blocks.mlp_head({k: jnp.asarray(v) for k, v in ref.items()}, jnp.asarray(h))
    np.testing.assert_allclose(blocks.mlp_head(port, torch.tensor(h)).numpy(), _np(want),
                               rtol=RTOL, atol=ATOL)
    ref, port = _dense_pair(lambda k: ref_blocks.mlp_tower_init(k, 12, 8, 5, prefix="u_"),
                            lambda g: blocks.mlp_tower_init(g, 12, 8, 5, prefix="u_"), 1)
    want = ref_blocks.mlp_tower({k: jnp.asarray(v) for k, v in ref.items()}, jnp.asarray(h),
                                "u_")
    np.testing.assert_allclose(blocks.mlp_tower(port, torch.tensor(h), "u_").numpy(),
                               _np(want), rtol=RTOL, atol=ATOL)
    u, v = (rng.normal(0, 1, (B, 7)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        blocks.dot_interaction(torch.tensor(u), torch.tensor(v)).numpy(),
        _np(ref_blocks.dot_interaction(jnp.asarray(u), jnp.asarray(v))), rtol=RTOL, atol=ATOL)


def test_mlp_init_scales_are_he():
    """The port's own draw keeps the reference's He scales and zero
    biases (distribution, not values: the PRNGs differ)."""
    d = blocks.mlp_head_init(torch.Generator().manual_seed(0), 400, 300)
    assert abs(float(d["w1"].std()) - (2.0 / 400) ** 0.5) < 0.003
    assert abs(float(d["w2"].std()) - (1.0 / 300) ** 0.5) < 0.01
    assert float(d["b1"].abs().max()) == 0.0 and float(d["b2"].abs().max()) == 0.0


@pytest.mark.parametrize("layers", [1, 3])
def test_cross_network_matches_reference(layers):
    rng = np.random.default_rng(layers)
    p = 15
    x0 = rng.normal(0, 1, (B, p)).astype(np.float32)
    cw = rng.normal(0, 0.3, (layers, p)).astype(np.float32)
    cb = rng.normal(0, 0.1, (layers, p)).astype(np.float32)
    want = ref_blocks.cross_network(jnp.asarray(x0), jnp.asarray(cw), jnp.asarray(cb))
    got = blocks.cross_network(torch.tensor(x0), torch.tensor(cw), torch.tensor(cb))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


# -- K7 and K8's plain versions ------------------------------------------------


def _planes(seed, wire, hot, u16=True, b=B, e=E):
    """Seed-made planes of ``b`` rows: sentinel-coded keys (20 %
    padding), fields (u8 with 255 on the compact wire; int32 with
    negatives on the full one), values on the full wire, a hot plane
    (keys past H count as padding), and the tables (emb ``e`` wide)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, T, (b, K)).astype(np.int32)
    keys[rng.random((b, K)) < 0.2] = -1
    keys[-2:] = -1  # all-padding rows
    if wire == "full":
        fields = rng.integers(-2, F + 2, (b, K)).astype(np.int32)
        x = rng.uniform(0.5, 1.5, (b, K)).astype(np.float32)
    else:
        fields = rng.integers(0, F + 2, (b, K)).astype(np.uint8)
        fields[rng.random((b, K)) < 0.1] = 255
        x = None
    out = {"keys": keys, "fields": fields, "x": x,
           "emb": rng.normal(0, 0.3, (T, e)).astype(np.float32),
           "w": rng.normal(0, 0.3, (T, 1)).astype(np.float32)}
    if hot:
        hk = rng.integers(0, H + 8, (b, KH))
        hk[rng.random((b, KH)) < 0.25] = -1
        if u16:
            out["hot"] = np.where(hk >= 0, hk, 0xFFFF).astype(np.uint16).view(np.int16)
        else:
            out["hot"] = hk.astype(np.int32)
        out["hot_fields"] = rng.integers(0, F, (b, KH)).astype(fields.dtype)
        out["hot_x"] = (rng.uniform(0.5, 1.5, (b, KH)).astype(np.float32)
                        if wire == "full" else None)
    return out


def _tensors(p):
    return {k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in p.items()}


def _ref_view(p, bf16, snap=None):
    """The reference's model view: hot rows through its hot_gather, cold
    rows gathered at the clipped keys (from the head snapshot below H
    when given); x = masked_x; slots."""
    keys = p["keys"]
    mask = (keys >= 0).astype(np.float32)
    ck = np.maximum(keys, 0)
    x = mask if p["x"] is None else p["x"] * mask
    emb, w = jnp.asarray(p["emb"]), jnp.asarray(p["w"])
    rows_e, rows_w = emb[ck], w[ck]
    if snap is not None:
        inh = (ck < H)[..., None]
        rows_e = jnp.where(inh, jnp.asarray(snap["emb"])[np.minimum(ck, H - 1)], rows_e)
        rows_w = jnp.where(inh, jnp.asarray(snap["w"])[np.minimum(ck, H - 1)], rows_w)
    slots = p["fields"].astype(np.int32)
    if "hot" not in p:
        return rows_e, rows_w, jnp.asarray(x), jnp.asarray(slots), None
    hk = p["hot"].astype(np.int64) & 0xFFFF if p["hot"].dtype == np.int16 else p["hot"]
    hk = np.where((hk >= 0) & (hk < H), hk, -1)
    hmask = (hk >= 0).astype(np.float32)
    dtype, impl = (jnp.bfloat16, "mxu") if bf16 else (jnp.float32, "seg")
    he = ref_hot_gather(emb[:H], jnp.asarray(hk.reshape(-1)), dtype=dtype, impl=impl)
    hw = ref_hot_gather(w[:H], jnp.asarray(hk.reshape(-1)), dtype=dtype, impl=impl)
    hx = hmask if p["hot_x"] is None else p["hot_x"] * hmask
    return (jnp.concatenate([he.reshape(*hk.shape, -1), rows_e], 1),
            jnp.concatenate([hw.reshape(*hk.shape, 1), rows_w], 1),
            jnp.asarray(np.concatenate([hx, x], 1)),
            jnp.asarray(np.concatenate([p["hot_fields"].astype(np.int32), slots], 1)), hk)


CASES = [("compact", False, True, False), ("full", False, True, False),
         ("compact", True, True, False), ("compact", True, True, True),
         ("full", True, True, True), ("full", True, False, False)]
IDS = ["compact", "full", "compact-hot-u16", "compact-hot-bf16", "full-hot-i32-bf16",
       "full-hot-no-w"]


@pytest.mark.parametrize("wire, hot, with_w, bf16", CASES, ids=IDS)
def test_field_pool_plain_matches_reference(wire, hot, with_w, bf16):
    p = _planes(7, wire, hot, u16=wire == "compact")
    t = _tensors(p)
    launched = field_pool.launches
    pooled, wide = field_pool(t["keys"], t["x"], t["fields"], t["emb"], F,
                              w=t["w"] if with_w else None, hot=t.get("hot"),
                              hot_x=t.get("hot_x"), hot_fields=t.get("hot_fields"),
                              hot_size=H if hot else 0, hot_bf16=bf16)
    assert field_pool.launches == launched  # the plain version launches nothing
    rows_e, rows_w, x, slots, _ = _ref_view(p, bf16)
    want = ref_blocks.field_sum_tower(rows_e, x, slots, F)
    np.testing.assert_allclose(pooled.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    if with_w:
        np.testing.assert_allclose(wide.numpy(), _np(ref_blocks.linear_term(rows_w, x)),
                                   rtol=RTOL, atol=ATOL)
    else:
        assert wide is None
    assert float(pooled[-2:].abs().max()) == 0.0 or hot  # all-padding rows pool to 0


def test_field_pool_window_start_snapshot():
    """Cold keys < H read the head snapshot; hot keys the live head."""
    p = _planes(8, "compact", True)
    rng = np.random.default_rng(9)
    snap = {"emb": rng.normal(0, 1, (H, E)).astype(np.float32),
            "w": rng.normal(0, 1, (H, 1)).astype(np.float32)}
    p["keys"][:, :3] = rng.integers(0, H, (B, 3))
    t = _tensors(p)
    pooled, wide = field_pool(t["keys"], None, t["fields"], t["emb"], F, w=t["w"],
                              hot=t["hot"], hot_fields=t["hot_fields"], hot_size=H,
                              snap_w=torch.tensor(snap["w"]),
                              snap_emb=torch.tensor(snap["emb"]))
    rows_e, rows_w, x, slots, _ = _ref_view(p, False, snap)
    np.testing.assert_allclose(pooled.numpy(), _np(ref_blocks.field_sum_tower(rows_e, x, slots,
                                                                              F)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wide.numpy(), _np(ref_blocks.linear_term(rows_w, x)),
                               rtol=RTOL, atol=ATOL)


def _ref_grads(p, dP, r, bf16):
    """jax.grad of sum(pooled * dP) + sum(wide * r) with respect to the
    gathered rows, scattered as the reference's _scatter_grads does."""
    rows_e, rows_w, x, slots, hk = _ref_view(p, bf16)

    def f(re, rw):
        return (jnp.sum(ref_blocks.field_sum_tower(re, x, slots, F) * dP)
                + jnp.sum(ref_blocks.linear_term(rw, x) * r))

    ge, gw = jax.grad(f, argnums=(0, 1))(rows_e, rows_w)
    kh = 0 if hk is None else hk.shape[1]
    cold = np.where(p["keys"] >= 0, p["keys"], T)  # the sentinel, dropped
    out = {}
    for name, g in (("emb", ge), ("w", gw)):
        d = g.shape[-1]
        out[name] = jnp.zeros((T, d)).at[cold.reshape(-1)].add(
            g[:, kh:].reshape(-1, d), mode="drop")
        if kh:
            dtype, impl = (jnp.bfloat16, "mxu") if bf16 else (jnp.float32, "seg")
            eff = np.where(hk >= 0, hk, H).reshape(-1)
            out["h" + name] = ref_hot_scatter(jnp.asarray(eff), g[:, :kh].reshape(-1, d), H,
                                              dtype=dtype, impl=impl)
    return {k: _np(v) for k, v in out.items()}


@pytest.mark.parametrize("wire, hot, with_w, bf16", CASES, ids=IDS)
def test_field_pool_grad_plain_matches_jax_grad(wire, hot, with_w, bf16):
    p = _planes(11, wire, hot, u16=wire == "compact")
    t = _tensors(p)
    rng = np.random.default_rng(12)
    dP = rng.normal(0, 0.1, (B, F, E)).astype(np.float32)
    r = rng.normal(0, 0.1, B).astype(np.float32)
    logit = rng.normal(0, 20, B).astype(np.float32)
    labels = (rng.random(B) < 0.4).astype(np.float32)
    weights = np.ones(B, np.float32)
    weights[-3:] = 0.0
    g_emb, g_w = torch.zeros(T, E), torch.zeros(T, 1) if with_w else None
    hg_emb = torch.zeros(H, E) if hot else None
    hg_w = torch.zeros(H, 1) if hot and with_w else None
    acc = torch.zeros(2, dtype=torch.float64)
    launched = field_pool_grad.launches
    field_pool_grad(t["keys"], t["x"], t["fields"], torch.tensor(dP), torch.tensor(r),
                    torch.tensor(logit), torch.tensor(labels), torch.tensor(weights), F,
                    g_emb, acc, g_w=g_w, hot=t.get("hot"), hot_x=t.get("hot_x"),
                    hot_fields=t.get("hot_fields"), hot_size=H if hot else 0,
                    hot_bf16=bf16, hg_w=hg_w, hg_emb=hg_emb)
    assert field_pool_grad.launches == launched
    want = _ref_grads(p, jnp.asarray(dP), jnp.asarray(r), bf16)
    np.testing.assert_allclose(g_emb.numpy(), want["emb"], rtol=RTOL, atol=ATOL)
    if with_w:
        np.testing.assert_allclose(g_w.numpy(), want["w"], rtol=RTOL, atol=ATOL)
    if hot:
        np.testing.assert_allclose(hg_emb.numpy(), want["hemb"], rtol=RTOL, atol=ATOL)
        if with_w:
            np.testing.assert_allclose(hg_w.numpy(), want["hw"], rtol=RTOL, atol=ATOL)
    ll = ref_logloss_sum(jnp.asarray(labels), ref_sigmoid(jnp.asarray(logit)),
                         jnp.asarray(weights))
    np.testing.assert_allclose(float(acc[0]), float(ll), rtol=RTOL)
    assert float(acc[1]) == float(weights.sum())
    # an invalid field's emb gradient is exactly 0, its w gradient x * r
    bad = (p["fields"].astype(np.int32) < 0) | (p["fields"].astype(np.int32) >= F)
    only_bad = set(p["keys"][bad & (p["keys"] >= 0)]) - set(p["keys"][~bad])
    for key in list(only_bad)[:5]:
        assert float(g_emb[key].abs().max()) == 0.0
        if with_w and not hot:
            assert float(g_w[key].abs().max()) > 0.0


def _edge_planes(edge):
    """_planes (compact wire, hot plane) at the edges K7's and K8's card
    checks hold the kernels to: every slot of every row in one field,
    one key in every example, a key twice in one example (in one field,
    and in two), B = 1 (a live row, no hot plane)."""
    p = _planes(17, "compact", edge != "b1")
    if edge == "one-field":
        p["fields"][:] = 2
        p["hot_fields"][:] = 2
    elif edge == "one-key":
        p["keys"][:, 0] = 5
        p["fields"][:, 0] = 1
    elif edge == "key-twice":
        p["keys"][:2, :2] = 9
        p["fields"][:2, :2] = 3
        p["fields"][1, 1] = 4
    elif edge == "b1":
        p["keys"], p["fields"] = p["keys"][:1].copy(), p["fields"][:1].copy()
    return p


@pytest.mark.parametrize("edge", ["one-field", "one-key", "key-twice", "b1"])
def test_field_pool_plain_edges_match_reference(edge):
    """K7's and K8's plain versions against the reference's tower, wide
    term and their jax.grad scattered as the reference scatters, on
    _edge_planes' edges."""
    p = _edge_planes(edge)
    t = _tensors(p)
    b, hot = p["keys"].shape[0], "hot" in p
    kw = dict(hot=t.get("hot"), hot_fields=t.get("hot_fields"), hot_size=H if hot else 0)
    pooled, wide = field_pool(t["keys"], None, t["fields"], t["emb"], F, w=t["w"], **kw)
    rows_e, rows_w, x, slots, _ = _ref_view(p, False)
    np.testing.assert_allclose(pooled.numpy(),
                               _np(ref_blocks.field_sum_tower(rows_e, x, slots, F)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wide.numpy(), _np(ref_blocks.linear_term(rows_w, x)),
                               rtol=RTOL, atol=ATOL)
    rng = np.random.default_rng(18)
    dP = rng.normal(0, 0.1, (b, F, E)).astype(np.float32)
    r = rng.normal(0, 0.1, b).astype(np.float32)
    got = {"emb": torch.zeros(T, E), "w": torch.zeros(T, 1)}
    if hot:
        got.update(hemb=torch.zeros(H, E), hw=torch.zeros(H, 1))
    acc = torch.zeros(2, dtype=torch.float64)
    field_pool_grad(t["keys"], None, t["fields"], torch.tensor(dP), torch.tensor(r),
                    torch.zeros(b), torch.zeros(b), torch.ones(b), F, got["emb"], acc,
                    g_w=got["w"], hg_w=got.get("hw"), hg_emb=got.get("hemb"), **kw)
    want = _ref_grads(p, jnp.asarray(dP), jnp.asarray(r), False)
    assert set(want) == set(got)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert float(acc[1]) == float(b)


def test_field_pool_grad_index_mode_sums_at_unique_keys():
    """Index mode: the per-unique-key sums at K4's slots equal the dense
    scatter at those keys; the hot plane lands in the head buffers."""
    p = _planes(13, "full", True, u16=False)
    t = _tensors(p)
    rng = np.random.default_rng(14)
    args = (torch.tensor(rng.normal(0, 0.1, (B, F, E)).astype(np.float32)),
            torch.tensor(rng.normal(0, 0.1, B).astype(np.float32)),
            torch.zeros(B), torch.zeros(B), torch.ones(B), F)
    dense = {"emb": torch.zeros(T, E), "w": torch.zeros(T, 1), "hemb": torch.zeros(H, E),
             "hw": torch.zeros(H, 1)}
    acc = torch.zeros(2, dtype=torch.float64)
    common = dict(hot=t["hot"], hot_x=t["hot_x"], hot_fields=t["hot_fields"], hot_size=H)
    field_pool_grad(t["keys"], t["x"], t["fields"], *args, dense["emb"], acc,
                    g_w=dense["w"], hg_w=dense["hw"], hg_emb=dense["hemb"], **common)
    m = B * K
    ukeys, count = torch.empty(m, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    slots = torch.empty((B, K), dtype=torch.int32)
    consolidate_keys(t["keys"], T, ukeys, count, slots)
    idx = {"emb": torch.zeros(m, E), "w": torch.zeros(m, 1), "hemb": torch.zeros(H, E),
           "hw": torch.zeros(H, 1)}
    field_pool_grad(t["keys"], t["x"], t["fields"], *args, idx["emb"], acc, g_w=idx["w"],
                    slots=slots, hg_w=idx["hw"], hg_emb=idx["hemb"], **common)
    u = int(count[0])
    uk = ukeys[:u].long()
    for name in ("emb", "w"):
        np.testing.assert_allclose(idx[name][:u].numpy(), dense[name][uk].numpy(),
                                   rtol=RTOL, atol=ATOL)
        assert float(idx[name][u:].abs().max()) == 0.0
    for name in ("hemb", "hw"):
        np.testing.assert_allclose(idx[name].numpy(), dense[name].numpy(), rtol=RTOL,
                                   atol=ATOL)


K8_CASES = {
    # (emb width E, edit): 37 rows each, not a multiple of the examples a
    # block of K8 takes; E = 1, 3 (scalar atomics), 8 and 12 (16-byte
    # vector reductions); one hot row in every example; index mode with
    # K4 slots of -1
    "e1": (1, None), "e3": (3, None), "e8": (8, None), "e12": (12, None),
    "one-hot-row-every-example": (8, "one-hot-row"), "index-minus-one": (8, "index"),
}


@pytest.mark.parametrize("case", list(K8_CASES))
def test_field_pool_grad_plain_k8_shapes_match_jax_grad(case):
    """K8's plain version against jax.grad of the reference's tower and
    wide term, scattered as the reference scatters, at the shapes K8's
    vector reductions and shared-memory table make hard (the same cases
    run on the card in tests/test_torch_cuda.py)."""
    e, edit = K8_CASES[case]
    b = 37
    p = _planes(31, "compact", True, b=b, e=e)
    if edit == "one-hot-row":
        hot = p["hot"].view(np.uint16)
        hot[:, 0] = 3
        p["hot_fields"][:, 0] = 1
    t = _tensors(p)
    rng = np.random.default_rng(32)
    dP = rng.normal(0, 0.1, (b, F, e)).astype(np.float32)
    r = rng.normal(0, 0.1, b).astype(np.float32)
    common = dict(hot=t["hot"], hot_fields=t["hot_fields"], hot_size=H)
    args = (torch.tensor(dP), torch.tensor(r), torch.zeros(b), torch.zeros(b),
            torch.ones(b), F)
    acc = torch.zeros(2, dtype=torch.float64)
    if edit == "index":
        m = b * K
        ukeys, count = torch.empty(m, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
        slots = torch.empty((b, K), dtype=torch.int32)
        consolidate_keys(t["keys"], T, ukeys, count, slots)
        assert bool((slots == -1).any())  # K4's slots of the padding occurrences
        got = {"emb": torch.zeros(m, e), "w": torch.zeros(m, 1), "hemb": torch.zeros(H, e),
               "hw": torch.zeros(H, 1)}
        field_pool_grad(t["keys"], None, t["fields"], *args, got["emb"], acc, g_w=got["w"],
                        slots=slots, hg_w=got["hw"], hg_emb=got["hemb"], **common)
        u = int(count[0])
        uk = ukeys[:u].long().numpy()
        want = _ref_grads(p, jnp.asarray(dP), jnp.asarray(r), False)
        for name in ("emb", "w"):
            np.testing.assert_allclose(got[name][:u].numpy(), want[name][uk], rtol=RTOL,
                                       atol=ATOL, err_msg=name)
            assert float(got[name][u:].abs().max()) == 0.0
        got = {"hemb": got["hemb"], "hw": got["hw"]}
    else:
        got = {"emb": torch.zeros(T, e), "w": torch.zeros(T, 1), "hemb": torch.zeros(H, e),
               "hw": torch.zeros(H, 1)}
        field_pool_grad(t["keys"], None, t["fields"], *args, got["emb"], acc, g_w=got["w"],
                        hg_w=got["hw"], hg_emb=got["hemb"], **common)
        want = _ref_grads(p, jnp.asarray(dP), jnp.asarray(r), False)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=RTOL, atol=ATOL, err_msg=name)
    if edit == "one-hot-row":  # every example's gradient lands on head row 3
        assert float(got["hw"][3, 0]) != 0.0
    assert float(acc[1]) == float(b)


def test_pool_wrappers_refuse_bad_planes():
    t = _tensors(_planes(15, "compact", True))
    with pytest.raises(ValueError, match="fields must be uint8 or int32"):
        field_pool(t["keys"], None, t["fields"].long(), t["emb"], F)
    with pytest.raises(ValueError, match="hot_fields come with a hot plane"):
        field_pool(t["keys"], None, t["fields"], t["emb"], F, hot=t["hot"], hot_size=H)
    with pytest.raises(ValueError, match="window-start mode needs"):
        field_pool(t["keys"], None, t["fields"], t["emb"], F, w=t["w"], hot=t["hot"],
                   hot_fields=t["hot_fields"], hot_size=H, snap_emb=torch.zeros(H, E))
    acc = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="dP must be float32"):
        field_pool_grad(t["keys"], None, t["fields"], torch.zeros(B, F + 1, E),
                        torch.zeros(B), torch.zeros(B), torch.zeros(B), torch.ones(B), F,
                        torch.zeros(T, E), acc)
    with pytest.raises(ValueError, match="a hot plane needs hg_emb"):
        field_pool_grad(t["keys"], None, t["fields"], torch.zeros(B, F, E), torch.zeros(B),
                        torch.zeros(B), torch.zeros(B), torch.ones(B), F, torch.zeros(T, E),
                        acc, hot=t["hot"], hot_fields=t["hot_fields"], hot_size=H)
    with pytest.raises(ValueError, match="index mode needs"):
        field_pool_grad(t["keys"], None, t["fields"], torch.zeros(B, F, E), torch.zeros(B),
                        torch.zeros(B), torch.zeros(B), torch.ones(B), F, torch.zeros(8, E),
                        acc, slots=torch.zeros((B, K), dtype=torch.int32))


def test_pool_slot_limit_is_refused_by_name():
    """C5: a pooled row past POOL_MAX_SLOTS (the most K7's shared-memory
    stage holds; K7 stages a wider row in device memory, K8 a chunk of
    its slots at a time) is
    servable and trains: dcn at POOL_MAX_SLOTS + 1 slots, predict and
    one dense and one sparse step against the JAX package, and K7's and
    K8's plain versions take such a row."""
    from xflow_tpu_torch.ops.pool import POOL_MAX_SLOTS
    from xflow_tpu_torch.parallel.step import check_servable

    check_servable(Config(model="dcn", max_nnz=POOL_MAX_SLOTS))
    check_servable(Config(model="dcn", max_nnz=POOL_MAX_SLOTS + 1))
    check_servable(Config(model="wide_deep", max_nnz=POOL_MAX_SLOTS, hot_size_log2=6,
                          hot_nnz=1))
    wide = POOL_MAX_SLOTS + 1
    kw = dict(model="dcn", table_size_log2=12, max_nnz=wide, batch_size=8, emb_dim=3,
              hidden_dim=5, cross_layers=2, max_fields=6, num_devices=1)
    _past_cap_parity(kw, _past_cap_raw(23, 8, wide, 12, 6))
    keys = torch.zeros((2, wide), dtype=torch.int32)
    pooled, _ = field_pool(keys, None, torch.zeros_like(keys, dtype=torch.uint8),
                           torch.ones(8, E), F)
    assert torch.equal(pooled[:, 0], torch.full((2, E), float(wide)))
    acc = torch.zeros(2, dtype=torch.float64)
    g = torch.zeros(8, E)
    field_pool_grad(keys, None, torch.zeros_like(keys, dtype=torch.uint8),
                    torch.ones(2, F, E), torch.zeros(2), torch.zeros(2), torch.zeros(2),
                    torch.ones(2), F, g, acc)
    assert torch.equal(g[0], torch.full((E,), 2.0 * wide))


def _past_cap_parity(kw, raw):
    """C5: a geometry past the kernels' shared-memory stage, on the CPU
    against the JAX package: predict from the reference's initial tables
    (params plus seed-made noise of 0.01), then one step from its
    initial state in the dense and in the sparse update mode, tables
    (and dense parameters) and log-loss at rtol 1e-5 / atol 1e-6, pctr
    at atol 1e-6."""
    import jax.numpy as jnp

    from xflow_tpu.io import batch as ref_batch
    from xflow_tpu.optim import make_optimizer as ref_make_optimizer
    from xflow_tpu.parallel.mesh import make_mesh
    from xflow_tpu.parallel.step import TrainStep as RefTrainStep
    from xflow_tpu.parallel.step import init_state as ref_init_state
    from xflow_tpu_torch.convert import dense_to_numpy
    from xflow_tpu_torch.io import batch as port_batch
    from xflow_tpu_torch.optim import make_optimizer
    from xflow_tpu_torch.parallel.step import TrainStep

    cpu = torch.device("cpu")
    for mode in ({}, {"update_mode": "sparse"}):
        rcfg = RefConfig(**kw, **mode)
        mdl, opt = ref_make_model(rcfg), ref_make_optimizer(rcfg)
        rstep = RefTrainStep(mdl, opt, rcfg, make_mesh(1))
        state = ref_init_state(mdl, opt, rcfg, make_mesh(1))
        start = {n: {k: np.asarray(a).copy() for k, a in t.items()}
                 for n, t in state["tables"].items()}
        dense = {k: np.asarray(a).copy() for k, a in state["dense"].items()}
        cfg = Config(**kw, **mode)
        step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, cpu)
        if not mode:
            rng = np.random.default_rng(11)
            noisy = {n: dict(t, param=(t["param"] + rng.normal(0, 0.01, t["param"].shape))
                             .astype(np.float32)) for n, t in start.items()}
            ref_state = {"tables": {n: {k: jnp.asarray(a) for k, a in t.items()}
                                    for n, t in noisy.items()}, "dense": state["dense"]}
            batch = ref_batch.make_batch(*raw, 0, 0)
            want = np.asarray(rstep.predict(ref_state, rstep.put_batch(batch, predict=True)))
            ours = state_from_numpy(cfg, noisy, "cpu", dense=dense or None)
            got = step.predict(ours, step.put_batch(port_batch.make_batch(*raw, 0, 0),
                                                     predict=True)).numpy()
            np.testing.assert_allclose(got, want, atol=1e-6)
        ours = state_from_numpy(cfg, start, "cpu", dense=dense or None)
        state, m = rstep.train(state, rstep.put_batch(ref_batch.make_batch(*raw, 0, 0)))
        got = step.train(ours, step.put_batch(port_batch.make_batch(*raw, 0, 0)))
        assert float(got["count"]) == float(m["count"])
        np.testing.assert_allclose(float(got["logloss"]), float(m["logloss"]), rtol=1e-5,
                                   atol=1e-6)
        back = state_to_numpy(ours, aux=True)
        for n, t in state["tables"].items():
            for k, a in t.items():
                np.testing.assert_allclose(back[n][k], np.asarray(a), rtol=1e-5, atol=1e-6,
                                           err_msg=f"{mode} {n}.{k}")
        for k, a in state["dense"].items():
            np.testing.assert_allclose(dense_to_numpy(ours)[k], np.asarray(a), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{mode} dense {k}")


def _past_cap_raw(seed, b, k, t_log2, fields):
    """Seed-made [B, K] planes (keys, field ids in [0, fields) with some
    past it, values, mask, labels, weights; the last row padding)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << t_log2, (b, k)).astype(np.int32)
    slots = rng.integers(0, fields, (b, k)).astype(np.int32)
    slots[rng.random((b, k)) < 0.03] = fields + 1
    mask = (rng.random((b, k)) < 0.85).astype(np.float32)
    mask[-1] = 0.0
    vals = np.ones((b, k), np.float32)
    labels = (rng.random(b) < 0.4).astype(np.float32)
    weights = np.ones(b, np.float32)
    weights[-1] = 0.0
    return keys, slots, vals, mask, labels, weights
