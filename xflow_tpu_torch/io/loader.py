"""Shard-aware streaming minibatch loader (the reference's io/loader.py
over libffm text, binary block-cache shards and packed shards).

Each data-parallel worker reads its own file shard named
``<prefix>-%05d`` by rank (lr_worker.cc:210); training streams the
shard in fixed-size byte blocks per epoch.  As in the reference:

* batches are FULL across text-block boundaries — parsed blocks
  accumulate in a carry buffer and only a shard's final batch is
  zero-weight padded;
* each batch carries a resume cursor, the byte offset of the earliest
  block holding samples not yet emitted;
* a block that fails to read or parse is retried with backoff, then
  quarantined (skipped, counted, reported as a ``health`` row) until
  the quarantine budget trips.

The parse function comes from ``make_parse_fn``: the native C++
parser (xflow_tpu_torch/native) when it builds, else the pure-Python
``parse_block`` (byte-equal results); batches are packed by the
native ``xf_pack_batch`` when the library is there.  With a hot table
(``remap``, ``hot_size``, ``hot_nnz``) every key goes through the
frequency remap (io/freq.py) and each row's first ``hot_nnz`` hot keys
are steered into the hot section (io/batch.py::split_hot): the native
pack folds both into its one pass; the Python path remaps at parse
time and steers in ``pack_batch``.  Binary block-cache shards
(io/binary.py, sniffed by their magic) skip parsing: their records are
parsed CSR blocks, assembled into batches as text blocks are.  Packed
shards (io/packed.py) skip parsing and assembly: their records are
finished batches, and with ``emit_compact`` a v2 shard yields its
CompactBatch records as they are, for a dictionary-wire train step.  A
hot model's packed shards were steered with its remap at pack time,
and the loader refuses a shard whose remap digest is not its own.  The
(batch, resume_offset) contract is the same for all three formats.
The chaos failpoints come with ROADMAP A14.
"""

from __future__ import annotations

import math
import queue
import threading
import time
import warnings
from typing import Callable, Iterator

import numpy as np

from xflow_tpu_torch import native
from xflow_tpu_torch.io import binary, packed
from xflow_tpu_torch.io.batch import Batch, ParsedBlock, pack_batch
from xflow_tpu_torch.io.libffm import BlockReader, parse_block
from xflow_tpu_torch.obs import Obs, emit_health

ParseFn = Callable[[bytes], ParsedBlock]

BACKOFF_CAP_S = 2.0  # the reference's chaos/heal.py cap


class QuarantineExceeded(RuntimeError):
    """Quarantined blocks exceeded the budget
    (Config.max_quarantined_frac): the stream is corrupt beyond what
    skip-and-continue can responsibly absorb."""


def shard_path(prefix: str, rank: int) -> str:
    return f"{prefix}-{rank:05d}"  # reference: lr_worker.cc:210


def _concat_blocks(a: ParsedBlock, b: ParsedBlock) -> ParsedBlock:
    """CSR concatenation (carry ∥ next block)."""
    return ParsedBlock(
        labels=np.concatenate([a.labels, b.labels]),
        row_ptr=np.concatenate([a.row_ptr, b.row_ptr[1:] + a.row_ptr[-1]]),
        keys=np.concatenate([a.keys, b.keys]),
        slots=np.concatenate([a.slots, b.slots]),
        vals=np.concatenate([a.vals, b.vals]),
    )


def _slice_block(block: ParsedBlock, start: int) -> ParsedBlock:
    """CSR tail slice: samples [start, n)."""
    lo = block.row_ptr[start]
    return ParsedBlock(
        labels=block.labels[start:],
        row_ptr=block.row_ptr[start:] - lo,
        keys=block.keys[lo:],
        slots=block.slots[lo:],
        vals=block.vals[lo:],
    )


def make_parse_fn(
    table_size: int,
    hash_mode: bool = True,
    hash_seed: int = 0,
    prefer_native: bool = True,
) -> ParseFn:
    """``bytes -> ParsedBlock`` closure over the parse settings: the
    native parser when ``prefer_native`` and it builds here, else the
    Python one (byte-equal, tests/test_torch_native.py).  As in the
    reference the fallback is silent; ``parser_name`` says which runs."""
    if prefer_native and native.available():
        return lambda data: native.native_parse_block(
            data, table_size, hash_mode, hash_seed
        )
    return lambda data: parse_block(data, table_size, hash_mode, hash_seed)


def parser_name(prefer_native: bool = True) -> str:
    """"native" or "python": the parser ``make_parse_fn`` gives."""
    return "native" if prefer_native and native.available() else "python"


class ShardLoader:
    """Streams one text shard as padded fixed-shape Batches."""

    def __init__(
        self,
        path: str,
        batch_size: int,
        max_nnz: int,
        table_size: int,
        block_mib: int = 2,
        hash_mode: bool = True,
        hash_seed: int = 0,
        parse_fn: ParseFn | None = None,
        remap: np.ndarray | None = None,  # int32 [T] permutation (io/freq.py)
        hot_size: int = 0,
        hot_nnz: int = 0,
        obs: Obs | None = None,  # parse/pack phase seconds + counters
        emit_compact: bool = False,  # v2 packed shards: yield CompactBatch
        io_retries: int = 2,  # read/parse retries per block
        io_retry_backoff_s: float = 0.05,
        max_quarantined_frac: float = 0.05,  # quarantine budget
    ):
        self.path = path
        self.batch_size = batch_size
        self.max_nnz = max_nnz
        self.table_size = table_size
        self.block_bytes = block_mib << 20
        self.hash_mode = hash_mode
        self.hash_seed = hash_seed
        if parse_fn is None:
            parse_fn = make_parse_fn(table_size, hash_mode, hash_seed)
        self.parse_fn = parse_fn
        self.remap = remap
        self.hot_size = hot_size
        self.hot_nnz = hot_nnz
        # With emit_compact, v2 packed shards yield their records AS
        # CompactBatch: a dictionary-wire train step ships them with no
        # per-batch host work; other formats still yield padded Batches.
        self.emit_compact = emit_compact
        self._native_pack = native.available()
        # parse/pack run on worker threads under prefetch/parse_workers,
        # so their phase seconds OVERLAP the consumer's wall-clock
        self.obs = obs if obs is not None else Obs()
        self.io_retries = io_retries
        self.io_retry_backoff_s = io_retry_backoff_s
        self.max_quarantined_frac = max_quarantined_frac
        # shared across parse workers — guarded
        self._q_lock = threading.Lock()
        self._blocks_seen = 0
        self._quarantined = 0

    # -- self-healing -------------------------------------------------------

    def _parse_block_healed(self, raw: bytes, offset: int) -> ParsedBlock | None:
        """One block through retry + quarantine.  Returns None when the
        block was quarantined (the stream skips it); raises
        :class:`QuarantineExceeded` past the budget."""
        with self._q_lock:
            self._blocks_seen += 1
        failures = 0
        while True:
            try:
                block = self._parse(raw)
            except (OSError, ValueError) as e:
                failures += 1
                if failures > self.io_retries:
                    self._quarantine(offset, e)
                    return None
                self.obs.counter("loader.retries")
                time.sleep(min(
                    self.io_retry_backoff_s * 2.0 ** (failures - 1), BACKOFF_CAP_S
                ))
                continue
            if failures:
                emit_health(
                    self.obs, cause="recovered:io_retry", channel="loader",
                    detail=f"{self.path}@{offset}: healed after {failures} "
                    "retried failure(s)",
                )
            return block

    def _quarantine(self, offset: int, err: BaseException) -> None:
        """Skip one unhealable block: counter + ``health`` row, then the
        budget check."""
        self.obs.counter("loader.quarantined")
        with self._q_lock:
            self._quarantined += 1
            quarantined, seen = self._quarantined, self._blocks_seen
        emit_health(
            self.obs, cause="record_quarantined", channel="loader",
            detail=f"{self.path}@{offset}: skipped after "
            f"{self.io_retries} retries ({type(err).__name__}: {err})",
        )
        budget = max(1, math.ceil(self.max_quarantined_frac * seen))
        if quarantined > budget:
            emit_health(
                self.obs, cause="quarantine_budget_exceeded", channel="loader",
                detail=f"{self.path}: {quarantined} of {seen} blocks "
                f"quarantined (budget {budget})",
            )
            raise QuarantineExceeded(
                f"{self.path}: {quarantined} quarantined blocks exceed "
                f"the budget ({budget} of {seen} seen, "
                f"max_quarantined_frac={self.max_quarantined_frac}) — "
                f"last error: {type(err).__name__}: {err}"
            ) from err

    def _apply_remap(self, block: ParsedBlock) -> ParsedBlock:
        """The frequency remap at parse time, for the Python pack (the
        native pack folds it into its pass and takes raw keys)."""
        if self.remap is not None and not self._native_pack and len(block.keys):
            block.keys = self.remap[block.keys]
        return block

    def _parse(self, raw: bytes) -> ParsedBlock:
        with self.obs.phase("parse"):
            block = self._apply_remap(self.parse_fn(raw))
        self.obs.counter("loader.parse_bytes", len(raw))
        self.obs.counter("loader.blocks")
        return block

    def _pack(self, block: ParsedBlock, start: int, end: int) -> Batch:
        with self.obs.phase("pack"):
            if self._native_pack:
                return native.native_pack_batch(
                    block, start, end, self.batch_size, self.max_nnz,
                    self.hot_size, self.hot_nnz, self.remap,
                )
            return pack_batch(block, start, end, self.batch_size, self.max_nnz,
                              self.hot_size, self.hot_nnz)

    def iter_batches(
        self, start_offset: int = 0, parse_workers: int = 0
    ) -> Iterator[tuple[Batch, int]]:
        """Yield (batch, resume_offset) pairs for one pass over the shard.

        ``resume_offset`` is the byte offset of the earliest block with
        samples not yet yielded; up to one block plus one carry may
        replay from it.  With parse_workers > 1, whole blocks parse
        concurrently on a thread pool, order-preserving (the native
        parser releases the GIL).  A binary block-cache shard skips the
        parse (its resume offsets are record offsets); a packed shard
        yields its records: no parse, no assembly, and
        ``resume_offset`` is the next record's offset."""
        with open(self.path, "rb") as f:
            magic = f.read(len(binary.MAGIC))
            if magic == binary.MAGIC:
                yield from self._iter_binary(f, start_offset)
                return
            if magic == packed.MAGIC:
                yield from self._iter_packed(f, start_offset)
                return
            f.seek(start_offset)

            def parsed_blocks() -> Iterator[tuple[ParsedBlock, int, int]]:
                # a None result is a quarantined block: skipped, its
                # bytes consumed, so resume offsets stay consistent
                offset = start_offset
                if parse_workers <= 1:
                    for raw in BlockReader(f, self.block_bytes):
                        next_offset = offset + len(raw)
                        block = self._parse_block_healed(raw, offset)
                        if block is not None:
                            yield block, offset, next_offset
                        offset = next_offset
                    return
                from collections import deque
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=parse_workers) as ex:
                    pending: deque = deque()
                    for raw in BlockReader(f, self.block_bytes):
                        next_offset = offset + len(raw)
                        pending.append((
                            ex.submit(self._parse_block_healed, raw, offset),
                            offset,
                            next_offset,
                        ))
                        offset = next_offset
                        while len(pending) > parse_workers + 1:
                            fut, off, noff = pending.popleft()
                            block = fut.result()
                            if block is not None:
                                yield block, off, noff
                    while pending:
                        fut, off, noff = pending.popleft()
                        block = fut.result()
                        if block is not None:
                            yield block, off, noff

            yield from self._batches_from_blocks(parsed_blocks(), start_offset)

    def _iter_binary(self, f, start_offset: int) -> Iterator[tuple[Batch, int]]:
        """Batch stream over a binary block-cache shard (io/binary.py):
        records already hold parsed CSR; reduction to [0, table_size)
        and the remap happen at load."""
        blocks = (
            (self._apply_remap(b), off, noff)
            for b, off, noff in binary.iter_blocks(
                f,
                self.table_size,
                start_offset,
                expect_hash_mode=self.hash_mode,
                expect_hash_seed=self.hash_seed,
            )
        )
        yield from self._batches_from_blocks(blocks, start_offset)

    def _iter_packed(self, f, start_offset: int) -> Iterator[tuple[Batch, int]]:
        """Batch stream over a packed shard (io/packed.py), whose baked-in
        geometry and remap must match this loader's exactly."""
        f.seek(0)
        meta, _ = packed.read_header(f)
        packed.check_compat(
            meta, batch_size=self.batch_size, cold_nnz=self.max_nnz,
            hot_nnz=self.hot_nnz if self.hot_size else 0, hot_size=self.hot_size,
            table_size=self.table_size, hash_mode=self.hash_mode,
            hash_seed=self.hash_seed, remap=self.remap,
        )
        if self.emit_compact and meta.get("version", 1) == 2:
            records = packed.iter_compact_batches(f, start_offset)
        else:
            records = packed.iter_batches(f, start_offset)
        for batch, offset, next_offset in records:
            yield batch, next_offset

    def _batches_from_blocks(
        self,
        blocks: Iterator[tuple[ParsedBlock, int, int]],
        start_offset: int,
    ) -> Iterator[tuple[Batch, int]]:
        """Carry/batch assembly over (block, offset, next_offset)."""
        carry: ParsedBlock | None = None
        end_offset = start_offset
        for block, raw_offset, next_offset in blocks:
            end_offset = next_offset
            if carry is not None and carry.num_samples:
                block = _concat_blocks(carry, block)
            carry = None
            n = block.num_samples
            start = 0
            while n - start >= self.batch_size:
                end = start + self.batch_size
                # the carry is always < batch_size samples, so the first
                # batch of this loop consumes it whole
                resume = next_offset if end == n else raw_offset
                yield self._pack(block, start, end), resume
                start = end
            if start < n:
                carry = _slice_block(block, start)
        if carry is not None and carry.num_samples:
            # the stream's final (partial) batch consumes everything
            yield self._pack(carry, 0, carry.num_samples), end_offset

    def prefetch(
        self, depth: int, start_offset: int = 0, parse_workers: int = 0
    ) -> "_PrefetchIter":
        """iter_batches with parse/pack running on a background thread,
        ``depth`` batches ahead of the consumer."""
        return _PrefetchIter(
            self.iter_batches(start_offset, parse_workers), depth, obs=self.obs
        )

    def count_examples(self) -> int:
        """Examples in this shard: a cache's header total, else its
        non-blank text lines."""
        if binary.is_binary_shard(self.path):
            return binary.shard_example_count(self.path)
        if packed.is_packed_shard(self.path):
            return packed.shard_example_count(self.path)
        n = 0
        with open(self.path, "rb") as f:
            for line in f:
                if line.strip():
                    n += 1
        return n


_SENTINEL = object()


class _PrefetchIter:
    """``it`` running on a daemon producer thread, buffering up to
    ``depth`` items.  Exceptions propagate to the consumer.

    Shutdown is explicit: ``close()`` signals the producer, drains the
    queue so a blocked put wakes immediately, and joins the thread
    (Trainer.close() closes every live prefetch it spawned).
    ``depth <= 0`` degrades to a synchronous passthrough with the same
    close() surface."""

    def __init__(self, it: Iterator, depth: int, obs: Obs | None = None):
        self._source = it
        self._closed = False
        self._close_done = False
        self._close_lock = threading.Lock()
        self._obs = obs if obs is not None else Obs()
        self._thread: threading.Thread | None = None
        # producer backpressure: wall seconds the producer spent blocked
        # on a full queue (the consumer was not ready); the fan-out
        # (io/fanout.py) reads it per stream to tell a slow reader from
        # a saturated consumer
        self._stats_lock = threading.Lock()
        self._stall_seconds = 0.0
        if depth <= 0:
            return
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _put_or_abort(self, item) -> bool:
        t0 = time.perf_counter()
        try:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    # the reference beats the flight recorder's
                    # 'backpressure' heartbeat here; that recorder comes
                    # with ROADMAP A14
                    continue
            return False
        finally:
            # past the free-slot fast path (microseconds) the producer
            # waited on the consumer; the 1 ms floor keeps per-batch
            # noise out of the stall ledger
            dt = time.perf_counter() - t0
            if dt > 1e-3:
                self._note_stall(dt)

    def _note_stall(self, dt: float) -> None:
        with self._stats_lock:
            self._stall_seconds += dt

    def stall_seconds(self) -> float:
        """Cumulative producer backpressure (blocked on a full queue)
        wall seconds so far.  Safe from any thread."""
        with self._stats_lock:
            return self._stall_seconds

    def _produce(self) -> None:
        try:
            for item in self._source:
                if not self._put_or_abort(item):
                    return
            self._put_or_abort(_SENTINEL)
        except BaseException as e:  # propagate to consumer
            self._put_or_abort(e)

    def __iter__(self) -> "_PrefetchIter":
        return self

    def __next__(self):
        if self._thread is None:  # synchronous passthrough
            if self._closed:
                raise StopIteration
            return next(self._source)
        if self._closed:
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._closed = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._closed = True
            raise item
        return item

    def close(self, join_timeout: float = 5.0) -> None:
        """Stop the producer thread and release its resources.
        Idempotent; safe from any thread.  A producer that outlives the
        join is surfaced (warning, ``loader.leaked_threads`` counter,
        ``health`` row) instead of silently leaking."""
        self._closed = True
        if self._thread is None:
            return
        with self._close_lock:
            if self._close_done:
                return
            self._close_done = True
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=join_timeout)
        if self._thread.is_alive():
            warnings.warn(
                "prefetch producer thread outlived its close() join "
                f"({join_timeout:.1f}s) — it is wedged in parse/read "
                "and still holds the shard file open",
                RuntimeWarning,
                stacklevel=2,
            )
            self._obs.counter("loader.leaked_threads")
            emit_health(
                self._obs, cause="prefetch_thread_leak", channel="loader",
                detail="producer outlived close() join",
                silence_seconds=join_timeout, threshold_seconds=join_timeout,
            )

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def __enter__(self) -> "_PrefetchIter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
