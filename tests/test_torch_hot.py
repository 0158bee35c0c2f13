"""The hot table's input, scoring and serving in the port, on the CPU,
against the reference (xflow_tpu):

* io/freq.py: the same key counts, a byte-equal remap (and remap.npy
  file) and the same hot mass; the binary cache refused by name (A5b);
* io/batch.py: ``split_hot``, ``make_batch`` with steering,
  ``remap_batch`` and ``pack_batch`` give equal planes, hot overflow
  spill and cold truncation included; the native pack with the remap
  folded in is byte-equal to the reference's remap-then-pack
  (tests/test_native.py:216);
* ops/hot.py: the contract against the reference's one-hot matmuls,
  for impl "seg" and "mxu" and float32 and bfloat16, at
  tests/test_hot.py's shapes;
* K1's plain version with the hot plane against the reference's
  ``_predict_impl``: u16 and int32 planes, the full wire, and a forced
  ``hot_impl="mxu"`` with bfloat16;
* K6's plain version decoding the hot tiers exactly as the reference's
  ``_expand_dict_wire``: u8+u12 (H = 2^12), u8+u16 (H = 2^14), an empty
  hot plane, and rows whose hot entries overflow;
* serving: a hot artifact exported by JAX scores equal in the port's
  engine, the port's export carries remap.npy and scores equal in the
  JAX engine, and a hot artifact without its remap is refused.

Tolerances: integer planes exact; pctr atol 1e-6 (tests/test_serve.py's
bar); the scatter's sums rtol 1e-5 / atol 1e-6 (summation order)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.io import batch as ref_batch
from xflow_tpu.io import compact as ref_compact
from xflow_tpu.io import freq as ref_freq
from xflow_tpu.io.libffm import parse_block as ref_parse_block
from xflow_tpu.models import make_model as ref_make_model
from xflow_tpu.ops import hot as ref_hot
from xflow_tpu.optim import make_optimizer as ref_make_optimizer
from xflow_tpu.parallel.mesh import make_mesh
from xflow_tpu.parallel.step import TrainStep as RefTrainStep
from xflow_tpu.parallel.step import init_state as ref_init_state
from xflow_tpu.serve.artifact import export_artifact as ref_export_artifact
from xflow_tpu.serve.engine import PredictEngine as RefEngine
from xflow_tpu.trainer import Trainer as RefTrainer
from xflow_tpu_torch import native
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import state_from_numpy
from xflow_tpu_torch.io import batch as port_batch
from xflow_tpu_torch.io import freq
from xflow_tpu_torch.io.libffm import parse_block
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.ops import hot as port_hot
from xflow_tpu_torch.ops.score import score
from xflow_tpu_torch.ops.wire import dict_decode, to_device
from xflow_tpu_torch.optim import make_optimizer
from xflow_tpu_torch.parallel.step import TrainStep
from xflow_tpu_torch.serve.artifact import REMAP_FILE, write_artifact
from xflow_tpu_torch.serve.engine import PredictEngine

CPU = torch.device("cpu")
PCTR_ATOL = 1e-6
RTOL, ATOL = 1e-5, 1e-6
BATCH_FIELDS = ("keys", "slots", "vals", "mask", "labels", "weights",
                "hot_keys", "hot_slots", "hot_vals", "hot_mask")


def _zipf_planes(seed, b, ktot, t, hot_heavy=0.6):
    """Seed-made padded [B, Ktot] planes: keys drawn mostly from a small
    head (so rows carry more hot keys than Kh and overflow), masked
    holes, non-unit values, the last 3 examples padding."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, t, (b, ktot))
    head = rng.integers(0, 64, (b, ktot))
    keys = np.where(rng.random((b, ktot)) < hot_heavy, head, keys).astype(np.int32)
    cnt = rng.integers(0, ktot + 1, b)
    mask = (np.arange(ktot)[None, :] < cnt[:, None]).astype(np.float32)
    keys = np.where(mask > 0, keys, 0).astype(np.int32)
    slots = rng.integers(0, 12, (b, ktot)).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (b, ktot)).astype(np.float32)
    weights = (np.arange(b) < b - 3).astype(np.float32)
    labels = (rng.random(b) < 0.4).astype(np.float32) * weights
    mask[b - 3:] = 0.0
    return keys, slots, vals, mask, labels, weights


def _assert_batches_equal(got, want):
    for f in BATCH_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# -- io/freq.py -----------------------------------------------------------


@pytest.fixture(scope="module")
def text_shards(tmp_path_factory):
    from tests.gen_data import generate_dataset

    return generate_dataset(str(tmp_path_factory.mktemp("hot_text")),
                            num_train_shards=2, lines_per_shard=300,
                            num_fields=10, vocab_per_field=64, seed=11, scale=3.0)


@pytest.mark.parametrize("sample_mib", [0.01, 1])
def test_freq_matches_reference(text_shards, tmp_path, sample_mib):
    t, h = 1 << 12, 1 << 6
    shards = [f"{text_shards.train_prefix}-{i:05d}" for i in range(2)]
    nbytes = int(sample_mib * (1 << 20))
    got = freq.count_keys(shards, lambda d: parse_block(d, t, True, 0), t, nbytes, 4096)
    want = ref_freq.count_keys(shards, lambda d: ref_parse_block(d, t, True, 0), t,
                               nbytes, 4096)
    np.testing.assert_array_equal(got, want)
    remap = freq.build_remap(got, h)
    np.testing.assert_array_equal(remap, ref_freq.build_remap(want, h))
    assert remap.dtype == np.int32 and np.array_equal(np.sort(remap), np.arange(t))
    assert freq.hot_mass(got, remap, h) == ref_freq.hot_mass(want, remap, h)
    ours, theirs = str(tmp_path / "ours.npy"), str(tmp_path / "theirs.npy")
    freq.save_remap(ours, remap)
    ref_freq.save_remap(theirs, remap)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    np.testing.assert_array_equal(freq.load_remap(ours), remap)
    assert freq.load_remap(str(tmp_path / "missing.npy")) is None


def test_freq_refuses_binary_cache_and_packed(tmp_path):
    from xflow_tpu_torch.io import packed

    binary = tmp_path / "bin"
    binary.write_bytes(freq.BINARY_MAGIC + b"\0" * 64)
    with pytest.raises(NotImplementedError, match="A5b"):
        freq.count_keys([str(binary)], None, 16, 1 << 20)
    pk = tmp_path / "pk"
    pk.write_bytes(packed.MAGIC + b"\0" * 64)
    with pytest.raises(ValueError, match="packed-batch cache"):
        freq.count_keys([str(pk)], None, 16, 1 << 20)
    with pytest.raises(ValueError, match="hot_size"):
        freq.build_remap(np.zeros(16, np.int64), 16)


# -- io/batch.py -----------------------------------------------------------


@pytest.mark.parametrize("kh", [2, 4, 8])
def test_split_hot_and_make_batch_match_reference(kh):
    """Overflow spill (rows with more than kh hot keys) and cold
    truncation (rows with more than Ktot - kh entries left) both
    happen at these shapes."""
    raw = _zipf_planes(1, 96, 12, 1 << 12)
    h = 1 << 6
    got = port_batch.split_hot(*raw[:4], h, kh)
    want = ref_batch.split_hot(*raw[:4], h, kh)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    keys, mask = raw[0], raw[3]
    n_hot = ((keys < h) & (mask > 0)).sum(axis=1)
    assert (n_hot > kh).any(), "no row overflows its hot capacity"
    assert ((got["mask"][:, :] > 0) & (got["keys"] < h)).any(), "no spill"
    _assert_batches_equal(port_batch.make_batch(*raw, h, kh),
                          ref_batch.make_batch(*raw, h, kh))
    # without a hot table make_batch is the plain constructor
    _assert_batches_equal(port_batch.make_batch(*raw), ref_batch.make_batch(*raw))


def test_remap_batch_and_pad_match_reference():
    t, h, kh = 1 << 12, 1 << 6, 4
    rng = np.random.default_rng(2)
    remap = rng.permutation(t).astype(np.int32)
    raw = _zipf_planes(3, 40, 10, t)
    for hot in (0, h):  # a raw batch, and one already steered
        ours = port_batch.make_batch(*raw, hot, kh)
        theirs = ref_batch.make_batch(*raw, hot, kh)
        got = port_batch.remap_batch(ours, remap, h, kh)
        want = ref_batch.remap_batch(theirs, remap, h, kh)
        _assert_batches_equal(got, want)
        _assert_batches_equal(port_batch.pad_batch_rows(got, 64),
                              ref_batch.pad_batch_rows(want, 64))
    assert port_batch.remap_batch(ours, None, h, kh) is ours


@pytest.mark.parametrize("hot", [False, True])
def test_pack_batch_and_native_pack_match_reference(hot):
    """pack_batch equals the reference's; the native pack with the
    remap folded in is byte-equal to the reference's remap-then-pack."""
    rng = np.random.default_rng(42)
    t = 512
    hot_size, hot_nnz = (64, 3) if hot else (0, 0)
    remap = rng.permutation(t).astype(np.int32)
    n = 57
    counts = rng.integers(0, 13, n)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    nnz = int(row_ptr[-1])
    block = port_batch.ParsedBlock(
        labels=rng.integers(0, 2, n).astype(np.float32), row_ptr=row_ptr,
        keys=rng.integers(0, t, nnz).astype(np.int64),
        slots=rng.integers(0, 32, nnz).astype(np.int32),
        vals=rng.random(nnz).astype(np.float32))
    remapped = ref_batch.ParsedBlock(
        labels=block.labels, row_ptr=block.row_ptr, keys=remap[block.keys],
        slots=block.slots, vals=block.vals)
    port_remapped = port_batch.ParsedBlock(
        labels=block.labels, row_ptr=block.row_ptr, keys=remap[block.keys],
        slots=block.slots, vals=block.vals)
    for start, end in [(0, 57), (0, 16), (40, 57), (5, 6)]:
        bs = 16 if end - start <= 16 else 64
        want = ref_batch.pack_batch(remapped, start, end, bs, 6, hot_size, hot_nnz)
        _assert_batches_equal(
            port_batch.pack_batch(port_remapped, start, end, bs, 6, hot_size, hot_nnz),
            want)
        if native.available():
            _assert_batches_equal(
                native.native_pack_batch(block, start, end, bs, 6, hot_size,
                                         hot_nnz, remap), want)


# -- ops/hot.py ------------------------------------------------------------

SHAPES = [(256, 1, 1000), (1024, 10, 4097), (4096, 1, 300)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["seg", "mxu"])
@pytest.mark.parametrize("h,d,m", SHAPES)
def test_hot_ops_match_reference(h, d, m, impl, dtype):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(h, d)).astype(np.float32)
    # out-of-range keys on both sides of [0, H) (the padding convention)
    keys = rng.integers(-4, h + h // 4, size=m).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = port_hot.hot_gather(torch.from_numpy(w), torch.from_numpy(keys),
                              dtype=tdt, impl=impl)
    want = ref_hot.hot_gather(jnp.asarray(w), jnp.asarray(keys), dtype=jdt, impl=impl)
    # the gather is a selection: exact, bf16 rounding included
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    zkeys = (rng.zipf(1.3, size=m) - 1).clip(0, h + 10).astype(np.int32)
    grads = rng.normal(size=(m, d)).astype(np.float32)
    got = port_hot.hot_scatter(torch.from_numpy(zkeys), torch.from_numpy(grads), h,
                               dtype=tdt, impl=impl)
    want = ref_hot.hot_scatter(jnp.asarray(zkeys), jnp.asarray(grads), h,
                               dtype=jdt, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert port_hot.hot_factors(h) == ref_hot.hot_factors(h)


def test_hot_ops_refuse_bad_arguments():
    with pytest.raises(ValueError, match="power of two"):
        port_hot.hot_factors(1000)
    with pytest.raises(ValueError, match="impl"):
        port_hot.hot_gather(torch.zeros(4, 1), torch.zeros(2, dtype=torch.int32),
                            impl="dma")


# -- K1 with the hot plane -------------------------------------------------

K1_CASES = {
    # (table_size_log2, hot_size_log2, wire_mode, hot_impl, hot_dtype)
    "u16": (12, 8, "auto", "auto", "float32"),
    "u16-mxu-f32": (12, 6, "auto", "mxu", "float32"),
    "u16-mxu-bf16": (12, 8, "auto", "mxu", "bfloat16"),
    "int32": (17, 16, "auto", "auto", "float32"),
    "full-wire": (12, 8, "full", "auto", "float32"),
}


@pytest.mark.parametrize("model", ["lr", "fm"])
@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_hot_plane_matches_reference_predict(case, model):
    t_log2, h_log2, wire_mode, impl, dtype = K1_CASES[case]
    kw = dict(model=model, table_size_log2=t_log2, hot_size_log2=h_log2, hot_nnz=4,
              max_nnz=8, batch_size=48, v_dim=4, num_devices=1, wire_mode=wire_mode,
              wire_dedup="off", hot_impl=impl, hot_dtype=dtype,
              hash_mode=wire_mode != "full")
    rcfg = RefConfig(**kw)
    mdl, opt = ref_make_model(rcfg), ref_make_optimizer(rcfg)
    ref_step = RefTrainStep(mdl, opt, rcfg, make_mesh(1))
    rng = np.random.default_rng(5)
    tables = {n: {k: (np.asarray(a) + rng.normal(0, 0.3, np.asarray(a).shape)).astype(np.float32)
                  for k, a in t.items()}
              for n, t in ref_init_state(mdl, opt, rcfg, make_mesh(1))["tables"].items()}
    ref_state = {"tables": {n: {k: jnp.asarray(a) for k, a in t.items()}
                            for n, t in tables.items()}, "dense": {}}
    raw = list(_zipf_planes(6, 48, 12, 1 << t_log2))
    if wire_mode != "full":
        raw[2] = np.ones_like(raw[2])
    batch = ref_batch.make_batch(*raw, 1 << h_log2, 4)
    want = np.asarray(ref_step.predict(ref_state, ref_step.put_batch(batch, predict=True)))
    cfg = Config(**kw)
    step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    state = state_from_numpy(cfg, tables, "cpu")
    ours = port_batch.make_batch(*raw, 1 << h_log2, 4)
    arrays = step.put_batch(ours, predict=True)
    # u16 on the compact wire below 2^15 rows; int32 otherwise
    u16 = h_log2 <= 15 and wire_mode != "full"
    assert arrays["hot"].dtype == (torch.int16 if u16 else torch.int32)
    assert ("hot_x" in arrays) == (wire_mode == "full")
    assert step.predict_step.hot_bf16 == (case == "u16-mxu-bf16")
    got = step.predict(state, arrays).numpy()
    np.testing.assert_allclose(got, want, atol=PCTR_ATOL)
    # the u16 and int32 forms of one plane score alike
    if u16:
        w = state["tables"]["w"]["param"]
        v = state["tables"]["v"]["param"] if model == "fm" else None
        wide = (arrays["hot"].to(torch.int32) & 0xFFFF)
        wide = torch.where(wide == 0xFFFF, torch.full_like(wide, -1), wide)
        again = score(arrays["ckeys"], arrays.get("x"), w, v, hot=wide,
                      hot_x=arrays.get("hot_x"), hot_size=1 << h_log2,
                      hot_bf16=step.predict_step.hot_bf16)
        assert torch.equal(again, torch.from_numpy(got))


def test_k1_hot_plane_refusals():
    keys = torch.zeros((2, 3), dtype=torch.int32)
    w = torch.zeros((16, 1))
    with pytest.raises(ValueError, match="hot must be int16"):
        score(keys, None, w, None, hot=torch.zeros((2, 2)), hot_size=4)
    with pytest.raises(ValueError, match="hot_size"):
        score(keys, None, w, None, hot=torch.zeros((2, 2), dtype=torch.int32), hot_size=32)
    with pytest.raises(ValueError, match="rows"):
        score(keys, None, w, None, hot=torch.zeros((3, 2), dtype=torch.int32), hot_size=4)


# -- K6's hot tiers --------------------------------------------------------

K6_CASES = {
    # (table_size_log2, hot_size_log2, hot_nnz, hot share)
    "u8+u12": (14, 12, 6, 0.7),
    "u8+u16": (16, 14, 6, 0.7),
    "empty-hot-plane": (14, 12, 6, 0.0),
    "all-overflow": (14, 12, 2, 1.0),
}


@pytest.mark.parametrize("case", list(K6_CASES))
def test_k6_hot_tiers_equal_reference_expand(case):
    t_log2, h_log2, kh, share = K6_CASES[case]
    t, h = 1 << t_log2, 1 << h_log2
    rng = np.random.default_rng(8)
    b, ktot = 61, 16
    keys = rng.integers(h, t, (b, ktot))
    small = rng.integers(0, 256, (b, ktot))  # the u8 tier
    large = rng.integers(256, h, (b, ktot))  # the u12 / u16 tier
    hot_keys = np.where(rng.random((b, ktot)) < 0.5, small, large)
    keys = np.where(rng.random((b, ktot)) < share, hot_keys, keys).astype(np.int32)
    cnt = rng.integers(0, ktot + 1, b)
    mask = (np.arange(ktot)[None, :] < cnt[:, None]).astype(np.float32)
    keys = np.where(mask > 0, keys, 0).astype(np.int32)
    weights = (np.arange(b) < b - 3).astype(np.float32)
    labels = (rng.random(b) < 0.4).astype(np.float32) * weights
    raw = (keys, np.zeros_like(keys), mask.copy(), mask, labels, weights)
    batch = ref_batch.make_batch(*raw, h, kh)
    cb = ref_compact.compact_batch(batch, t, h)
    if case == "empty-hot-plane":
        assert cb.n_hot == 0
    if case == "all-overflow":
        assert (batch.hot_mask.sum(axis=1)[: b - 3][cnt[: b - 3] > kh] == kh).all()
    if case.startswith("u8+"):
        assert cb.n_h8 > 0 and cb.n_hot > cb.n_h8
    assert cb.hx16 == (h > 1 << 12)
    wire = cb.wire(ship_slots=False)
    step = RefTrainStep(*(lambda c: (ref_make_model(c), ref_make_optimizer(c), c))(
        RefConfig(model="lr", batch_size=b, max_nnz=ktot - kh, hot_size_log2=h_log2,
                  hot_nnz=kh, table_size_log2=t_log2, num_devices=1, wire_dedup="on")),
        make_mesh(1))
    want = step._expand_dict_wire({n: jnp.asarray(a) for n, a in wire.items()})
    ckeys, labels_u8, weights_u8, hot = dict_decode(to_device(wire, CPU), ktot - kh, kh)
    assert hot.dtype == torch.int32 and hot.shape == (b, kh)
    hmask = np.asarray(want["hot_mask"]) > 0
    np.testing.assert_array_equal(hot.numpy(), np.where(hmask, np.asarray(want["hot_keys"]), -1))
    np.testing.assert_array_equal(hot.numpy(), np.where(batch.hot_mask > 0, batch.hot_keys, -1))
    np.testing.assert_array_equal(ckeys.numpy(), np.where(batch.mask > 0, batch.keys, -1))
    np.testing.assert_array_equal(labels_u8.numpy(), labels)
    np.testing.assert_array_equal(weights_u8.numpy(), weights)
    # without hot_nnz the same wire decodes its cold half alone
    assert len(dict_decode(to_device(wire, CPU), ktot - kh)) == 3


# -- serving ---------------------------------------------------------------


def _hot_ref_cfg(ds, model, **kw):
    return RefConfig(train_path=ds.train_prefix, test_path=ds.test_prefix, model=model,
                     epochs=1, batch_size=64, table_size_log2=12, max_nnz=16,
                     hot_size_log2=6, hot_nnz=8, freq_sample_mib=1, v_dim=4,
                     num_devices=1, **kw)


def _lines(ds):
    with open(ds.test_prefix + "-00000") as f:
        return f.read().splitlines()


@pytest.mark.parametrize("model", ["lr", "fm"])
def test_hot_artifacts_score_equal_both_ways(text_shards, tmp_path, model):
    """A hot artifact the JAX trainer exports scores equal in the
    port's engine (tests/test_serve.py:117), and the port's export of
    the same tables and remap carries remap.npy and scores equal in the
    JAX engine."""
    trainer = RefTrainer(_hot_ref_cfg(text_shards, model))
    trainer.train()
    art = str(tmp_path / "jax_art")
    ref_export_artifact(trainer, art)
    remap = trainer.remap
    trainer.close()
    lines = _lines(text_shards)
    ref = RefEngine.load(art, buckets=(8, 64), warm=False)
    ours = PredictEngine.load(art, device="cpu", buckets=(8, 64))
    np.testing.assert_array_equal(ours.remap, remap)
    want = ref.score_text(lines)
    np.testing.assert_allclose(ours.score_text(lines), want, atol=PCTR_ATOL)
    rows = [np.asarray([int(k) for k in rng_row]) for rng_row in
            np.random.default_rng(3).integers(0, 1 << 12, (20, 11))]
    np.testing.assert_allclose(ours.predict(ours.featurize_raw(rows)),
                               ref.predict(ref.featurize_raw(rows)), atol=PCTR_ATOL)
    # the port writes the same model: remap.npy beside the tables
    cfg = Config.from_json(ref.cfg.to_json())
    tables = {n: np.asarray(t["param"]) for n, t in ref.state["tables"].items()}
    port_art = write_artifact(str(tmp_path / "port_art"), cfg, tables, step=3, remap=remap)
    assert os.path.exists(os.path.join(port_art, REMAP_FILE))
    assert open(os.path.join(port_art, REMAP_FILE), "rb").read() == \
        open(os.path.join(art, REMAP_FILE), "rb").read()
    back = RefEngine.load(port_art, buckets=(8, 64), warm=False)
    np.testing.assert_allclose(back.score_text(lines), want, atol=PCTR_ATOL)
    with pytest.raises(ValueError, match="carries its remap"):
        write_artifact(str(tmp_path / "no_remap"), cfg, tables, step=3)


def test_hot_engine_refuses_without_remap():
    cfg = Config(model="lr", table_size_log2=10, max_nnz=8, hot_size_log2=6, hot_nnz=4)
    state = state_from_numpy(cfg, {"w": np.zeros((1 << 10, 1), np.float32)}, "cpu")
    with pytest.raises(ValueError, match="no remap was provided"):
        PredictEngine(cfg, state, device="cpu")
    engine = PredictEngine(cfg, state, device="cpu", remap=np.arange(1 << 10, dtype=np.int32))
    hot_batch = port_batch.make_batch(*_zipf_planes(4, 8, 8, 1 << 10), 64, 4)
    cold_cfg = cfg.replace(hot_size_log2=0)
    cold = PredictEngine(cold_cfg, state_from_numpy(cold_cfg, {"w": np.zeros((1 << 10, 1), np.float32)}, "cpu"),
                         device="cpu")
    with pytest.raises(ValueError, match="no hot table"):
        cold.predict(hot_batch)
    assert engine.clone().remap is engine.remap
