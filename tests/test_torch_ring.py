"""The staging ring and the input fan-out in the port's Trainer
(xflow_tpu_torch/trainer.py ``_transfer_ahead``, ``_iter_fanout``;
parallel/step.py ``put_batch_host`` / ``put_batch_device`` and
``precompact``) on the toy corpus, on the CPU.

Batch order, and so training, must not depend on the ring's depth or
the stream count: the final tables at (input_streams,
transfer_ahead_depth) = (1, 2) and (4, 4) are bit-equal to (1, 1)'s in
the dense, sparse, sequential (sparse inner) and hot hybrid modes, and
each run stays within tests/test_torch_trainer.py's TRACK (1e-4 on the
epoch log-loss) of the reference Trainer at the same settings, from
the reference's initial state.  The failure paths hold the port to
its own contract, with no reference test as the oracle: a ring worker
that raises, and a SIGTERM preemption under four streams, leave no
ring or stream thread behind a bounded ``close()``."""

import json
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from xflow_tpu.config import Config as RefConfig
from xflow_tpu.obs.schema import validate_rows
from xflow_tpu.trainer import Trainer as RefTrainer
from xflow_tpu.trainer import _ring_workers as ref_ring_workers
from xflow_tpu_torch.config import Config
from xflow_tpu_torch.convert import state_from_numpy, state_to_numpy
from xflow_tpu_torch.io.compact import CompactBatch
from xflow_tpu_torch.io.loader import ShardLoader
from xflow_tpu_torch.models import make_model
from xflow_tpu_torch.optim import make_optimizer
from xflow_tpu_torch.parallel.step import SliceOrdered, TrainStep
from xflow_tpu_torch.trainer import Trainer, _ring_workers, find_shards

CPU = torch.device("cpu")
TRACK = 1e-4  # tests/test_torch_trainer.py's bound
SETTINGS = [(1, 1), (1, 2), (4, 4)]  # (input_streams, transfer_ahead_depth)
SEQ = dict(update_mode="sequential", microbatch=4, sequential_inner="sparse")
HOT = dict(hot_size_log2=8, hot_nnz=8)
MODES = {
    "dense": dict(model="fm"),
    "sparse": dict(model="fm", update_mode="sparse"),
    "sequential-sparse": dict(model="fm", **SEQ),
    "hot-hybrid": dict(model="fm", **SEQ, **HOT),
}


def _kw(ds, **kw):
    base = dict(train_path=ds.train_prefix, test_path=ds.test_prefix, epochs=1,
                batch_size=64, table_size_log2=12, max_nnz=24, max_fields=12,
                num_devices=1)
    base.update(kw)
    return base


def _arrays(trainer) -> dict:
    return {f"{n}.{k}": a for n, t in state_to_numpy(trainer.state, aux=True).items()
            for k, a in t.items()}


def _ring_threads() -> set:
    return {t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("xf-ring")}


def _wait_for_threads(before: set, timeout: float = 15.0) -> None:
    """Every thread started since ``before`` (ring workers, stream
    producers, loader prefetch) has ended within ``timeout``."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        left = {t for t in threading.enumerate() if t.is_alive()} - before
        if not left:
            return
        time.sleep(0.05)
    raise AssertionError(f"threads left behind: {[t.name for t in left]}")


_BASE: dict = {}


def _port_run(ds, mode, streams, depth, init, metrics_out=""):
    cfg = Config(**_kw(ds, input_streams=streams, transfer_ahead_depth=depth,
                       metrics_out=metrics_out, **MODES[mode]))
    with Trainer(cfg, device="cpu", log=lambda _: None) as trainer:
        trainer.state = state_from_numpy(cfg, init, "cpu")
        history = trainer.train()
        return history, _arrays(trainer)


@pytest.mark.parametrize("settings", SETTINGS, ids=lambda s: f"streams{s[0]}-depth{s[1]}")
@pytest.mark.parametrize("mode", list(MODES))
def test_ring_and_fanout_train_bit_equal(toy_dataset, tmp_path, mode, settings):
    streams, depth = settings
    ref = RefTrainer(RefConfig(**_kw(toy_dataset, input_streams=streams,
                                     transfer_ahead_depth=depth, **MODES[mode])))
    init = {n: {k: np.asarray(jax.device_get(a)).copy() for k, a in t.items()}
            for n, t in ref.state["tables"].items()}
    ref_history = ref.train()
    ref.close()
    metrics_out = str(tmp_path / "run.jsonl")
    history, arrays = _port_run(toy_dataset, mode, streams, depth, init, metrics_out)
    if mode not in _BASE:
        _BASE[mode] = _port_run(toy_dataset, mode, 1, 1, init)[1]
    base = _BASE[mode]
    assert arrays.keys() == base.keys()
    for key, a in base.items():
        np.testing.assert_array_equal(arrays[key], a, err_msg=key)
    for ours, theirs in zip(history, ref_history, strict=True):
        assert set(theirs) <= set(ours)
        assert ours["steps"] == theirs["steps"] and ours["examples"] == theirs["examples"]
        assert abs(ours["train_logloss"] - theirs["train_logloss"]) < TRACK
        # the ring's occupancy, and put_batch's host half under overlapped
        assert 1 <= ours["transfer_ahead_depth_mean"] <= depth + 1
        assert "h2d" in ours["overlapped"] and "h2d" not in ours["phases"]
        assert set(ours["h2d_split"]) == {"compact", "enqueue"}
    with open(metrics_out) as f:
        rows = [json.loads(line) for line in f]
    assert validate_rows(rows) == []
    stream_rows = [r for r in rows if r["kind"] == "stream"]
    shards = len(find_shards(toy_dataset.train_prefix))
    if streams > 1:
        assert len(stream_rows) == min(streams, shards)
        assert sum(r["shards"] for r in stream_rows) == shards
    else:
        assert stream_rows == []
    assert sum(r["kind"] == "shard" for r in rows) == shards


def _batches(ds, hot: bool, packed_dir=None):
    """The toy corpus's first shard as loader batches: text Batches, or
    CompactBatch records from a packed-v2 shard of it."""
    from xflow_tpu_torch.io import packed

    path = find_shards(ds.train_prefix)[0]
    geometry = dict(batch_size=64, max_nnz=24, table_size=1 << 12)
    hot_kw = dict(hot_size=1 << 8, hot_nnz=8, remap=np.arange(1 << 12, dtype=np.int32)) \
        if hot else {}
    if packed_dir is not None:
        dst = os.path.join(packed_dir, "toy.pk")
        packed.convert_shard(path, dst, fmt="v2", **geometry, **hot_kw)
        path = dst
    loader = ShardLoader(path, emit_compact=packed_dir is not None, **geometry, **hot_kw)
    return [b for b, _ in loader.iter_batches()]


@pytest.mark.parametrize("source", ["text", "packed-v2"])
@pytest.mark.parametrize("mode", ["sequential-sparse", "hot-hybrid", "hot-inner"])
def test_precompact_under_slices(toy_dataset, tmp_path, monkeypatch, mode, source):
    """Under sequential slices ``precompact`` puts the rows in slice
    order and compacts once; ``put_batch`` ships its result without a
    second compaction, and the planes, the host floats and the wire
    counters equal the inline path's."""
    kw = dict(MODES["hot-hybrid"], sequential_inner="hot") if mode == "hot-inner" \
        else MODES[mode]
    cfg = Config(**_kw(toy_dataset, **kw))
    batches = _batches(toy_dataset, "hot" in mode,
                       str(tmp_path) if source == "packed-v2" else None)
    assert all(isinstance(b, CompactBatch) == (source == "packed-v2") for b in batches)
    calls = []
    orig = CompactBatch.from_batch.__func__

    def counting(cls, *a, **k):
        calls.append(1)
        return orig(cls, *a, **k)

    monkeypatch.setattr(CompactBatch, "from_batch", classmethod(counting))
    shipped, counters = [], []
    for pre in (False, True):
        step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
        out = []
        for batch in batches:
            if pre:
                batch = step.precompact(batch)
                assert isinstance(batch, SliceOrdered)
                assert step.precompact(batch) is batch
                n = len(calls)
                out.append(step.put_batch(batch))
                assert len(calls) == n  # no second compaction
            else:
                out.append(step.put_batch(batch))
        shipped.append(out)
        counters.append(step.obs.registry.snapshot().counters)
    assert len(calls) == 2 * len(batches)  # one compaction a batch, each path
    for inline, pre in zip(*shipped, strict=True):
        assert inline.keys() == pre.keys()
        for name, a in inline.items():
            if hasattr(a, "dtype"):
                assert a.dtype == pre[name].dtype and bool((a == pre[name]).all()), name
            else:
                assert a == pre[name], name
    for key in ("wire.bytes", "wire.examples", "wire.cold_occ", "wire.cold_touched"):
        assert counters[0][key] == counters[1][key]


@pytest.mark.parametrize("depth", [2, 4])
def test_ring_worker_raising_reaches_caller(toy_dataset, depth):
    """A ring worker raising mid-ring under four streams: the exception
    reaches train_epoch's caller, close() returns within 30 s, no ring
    or stream thread is left after 15 s, and the trainer trains again."""
    before = {t for t in threading.enumerate() if t.is_alive()}
    cfg = Config(**_kw(toy_dataset, model="lr", epochs=1, input_streams=4,
                       transfer_ahead_depth=depth))
    trainer = Trainer(cfg, device="cpu", log=lambda _: None)
    orig = trainer.step.put_batch_host
    calls = []

    def boom(batch, predict=False):
        calls.append(1)
        if len(calls) == depth + 1:
            raise RuntimeError("worker raised mid-ring")
        return orig(batch, predict)

    trainer.step.put_batch_host = boom
    with pytest.raises(RuntimeError, match="mid-ring"):
        trainer.train_epoch()
    t0 = time.time()
    trainer.close()
    assert time.time() - t0 < 30, "close() stalled after a ring failure"
    _wait_for_threads(before)
    trainer.step.put_batch_host = orig
    assert trainer.train_epoch()["examples"] > 0
    trainer.close()
    _wait_for_threads(before)


def test_sigterm_under_fanout_resumes_bit_equal(toy_dataset, tmp_path):
    """SIGTERM as the step takes its 4th batch (the end of shard 0)
    under four streams and a ring of depth 4: the step finishes, the
    checkpoint holds that batch's cursor (the batches staged past it
    are dropped), close() is bounded and leaves no thread, and the
    resumed run's tables are bit-equal to a straight run's."""
    before = {t for t in threading.enumerate() if t.is_alive()}
    kw = _kw(toy_dataset, model="fm", epochs=2, input_streams=4, transfer_ahead_depth=4,
             checkpoint_dir=str(tmp_path / "ck"))
    trainer = Trainer(Config(**kw), device="cpu", log=lambda _: None)
    inner = trainer.step.put_batch_device
    taken = []

    def preempt(staged):
        if len(taken) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        taken.append(1)
        return inner(staged)

    trainer.step.put_batch_device = preempt
    history = trainer.train()
    assert len(history) == 1 and history[0]["preempted"] and history[0]["steps"] == 4
    t0 = time.time()
    trainer.close()
    assert time.time() - t0 < 30
    _wait_for_threads(before)
    size = os.path.getsize(toy_dataset.train_prefix + "-00000")
    resumed = Trainer(Config(**kw), device="cpu", log=lambda _: None)
    assert resumed.restore()["epoch"] == 0 and resumed._resume_cursor == (0, size)
    rest = resumed.train()
    resumed.close()
    straight = Trainer(Config(**dict(kw, checkpoint_dir=str(tmp_path / "straight"))),
                       device="cpu", log=lambda _: None)
    full = straight.train()
    straight.close()
    assert rest[0]["steps"] + 4 == full[0]["steps"]
    got, want = _arrays(resumed), _arrays(straight)
    assert got.keys() == want.keys()
    for key, a in want.items():
        np.testing.assert_array_equal(got[key], a, err_msg=key)
    _wait_for_threads(before)


def test_abandoned_ring_reaped_by_close(toy_dataset):
    """A ring suspended mid-epoch (the shape a preemption's break or a
    consumer's exception leaves) is stopped by Trainer.close()."""
    before = {t for t in threading.enumerate() if t.is_alive()}
    cfg = Config(**_kw(toy_dataset, model="lr", input_streams=2, transfer_ahead_depth=3))
    trainer = Trainer(cfg, device="cpu", log=lambda _: None)
    stream = trainer._transfer_ahead(trainer.iter_train_batches())
    trainer._live_transfer.add(stream)
    staged, shard_idx, _ = next(stream)
    assert shard_idx == 0 and _ring_threads()
    trainer.close()
    _wait_for_threads(before)
    assert list(stream) == []


def test_ring_worker_count():
    """The reference's worker count at every depth: 1 at depth 1, at
    least 2 once the ring double-buffers, never more than its slots."""
    for depth in range(1, 9):
        assert _ring_workers(depth) == ref_ring_workers(depth)
        assert 1 <= _ring_workers(depth) <= depth


def test_put_batch_host_under_many_workers(toy_dataset):
    """Stress: ``put_batch_host`` on 16 ring workers at once (more than
    this host's cores) with a shortened switch interval.  The wire
    counters the workers share lose no update, and every staged batch
    lands with the inline path's planes."""
    import sys

    from xflow_tpu_torch.trainer import _StagingRing

    cfg = Config(**_kw(toy_dataset, **MODES["hot-hybrid"]))
    batches = _batches(toy_dataset, hot=True) * 8
    inline = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    want = [inline.put_batch(b) for b in batches]
    step = TrainStep(make_model(cfg), make_optimizer(cfg), cfg, CPU)
    ring = _StagingRing(16)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        futures = [ring.submit(step.put_batch_host, b) for b in batches]
        staged = [f.result(timeout=60) for f in futures]
    finally:
        sys.setswitchinterval(old)
        assert ring.close([], join_timeout=30) == 0
    got = [step.put_batch_device(s) for s in staged]
    ours, theirs = (s.obs.registry.snapshot().counters for s in (step, inline))
    for key in ("wire.batches", "wire.examples", "wire.bytes", "wire.cold_occ"):
        assert ours[key] == theirs[key], key
    assert ours["wire.batches"] == len(batches)
    for a, b in zip(got, want, strict=True):
        assert a["slice_num_real"] == b["slice_num_real"]
        for name in ("ckeys", "labels_u8", "weights_u8", "hot"):
            assert torch.equal(a[name], b[name]), name
