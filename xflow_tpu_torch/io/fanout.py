"""The input fan-out (the reference's io/fanout.py): N concurrent
shard-reader streams merged back into serial shard order.

``ShardStreamPool`` partitions an epoch's shard list across N streams
by shard index (stream ``s`` owns shards ``i % N == s``, counted from
the start shard).  Each stream is a daemon producer thread (the
loader's ``_PrefetchIter``: bounded queue, explicit close(), exception
propagation, backpressure accounting) running its own read -> parse
-> [transform] loop over its shards, ``depth`` batches ahead.  The
consumer-side merge walks the global shard order and pulls each
shard's batches from its owning stream, so the merged sequence is
exactly the serial reader's: training under the fan-out is
bit-for-bit that of ``input_streams=1``.  The parallelism is in the
lookahead: while shard ``i`` drains to the device, the other streams
read, parse and compact shards ``i+1..i+N-1``.

``transform`` runs on the producer thread per batch: the trainer
passes ``TrainStep.precompact``, so the dictionary wire's host
compaction (io/compact.py) rides the streams.

Per-stream accounting (``stream_stats``) feeds the trainer's
``stream`` metrics rows: shards, batches, examples, producer wall
seconds, read seconds (read + parse + transform, queue waits
excluded) and backpressure stall seconds.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator

from xflow_tpu_torch.io.loader import _PrefetchIter
from xflow_tpu_torch.obs import Obs

# Stream -> merge messages ride the _PrefetchIter queue: (_ITEM,
# shard_idx, batch, resume) per batch, (_DONE, shard_idx, stats) after
# each finished shard.  The stats travel with the message, so the pool
# needs no lock of its own.
_ITEM = 0
_DONE = 1


class ShardStreamPool:
    """N concurrent shard streams merged back into serial shard order.

    ``shards`` is the epoch's full, ordered shard list;
    ``loader_factory(path)`` builds a shard's loader (the trainer's
    ``_loader``).  Yields ``(batch, shard_idx, resume_offset)`` with the
    serial reader's contract and order, from ``start_shard`` at
    ``start_offset``.  ``close()`` stops every stream with a bounded
    join; the pool is a context manager and sits in the trainer's
    reap set.
    """

    def __init__(
        self,
        shards: list[str],
        loader_factory: Callable[[str], object],
        num_streams: int,
        depth: int = 2,
        start_shard: int = 0,
        start_offset: int = 0,
        parse_workers: int = 0,
        transform: Callable | None = None,
        obs: Obs | None = None,
    ):
        if num_streams < 1:
            raise ValueError("num_streams must be >= 1")
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._shards = shards
        self._start_shard = start_shard
        self._obs = obs if obs is not None else Obs()
        remaining = len(shards) - start_shard
        # never an empty stream: a 2-shard epoch at N = 4 runs 2
        self.num_streams = max(1, min(num_streams, remaining))
        self._streams: list[_PrefetchIter] = []
        # per-stream accumulators, touched by the merging consumer alone
        self._stats: list[dict] = []
        self._stall_base: list[float] = []
        for s in range(self.num_streams):
            owned = [
                (i, shards[i])
                for i in range(start_shard, len(shards))
                if (i - start_shard) % self.num_streams == s
            ]
            self._streams.append(_PrefetchIter(
                self._stream_source(owned, loader_factory, start_shard,
                                    start_offset, parse_workers, transform),
                depth,
                obs=self._obs,
            ))
            self._stats.append({
                "stream": s,
                "shards": 0,
                "batches": 0,
                "examples": 0,
                "seconds": 0.0,
                "read_seconds": 0.0,
                "stall_seconds": 0.0,
            })
            self._stall_base.append(0.0)

    @staticmethod
    def _stream_source(
        owned: list[tuple[int, str]],
        loader_factory: Callable[[str], object],
        start_shard: int,
        start_offset: int,
        parse_workers: int,
        transform: Callable | None,
    ) -> Iterator[tuple]:
        """One stream's producer: its shards in global order, each read
        through a fresh loader, each batch transformed before it reaches
        the queue.  Runs on the stream's producer thread."""
        for shard_idx, path in owned:
            loader = loader_factory(path)
            offset = start_offset if shard_idx == start_shard else 0
            t0 = time.perf_counter()
            batches = 0
            examples = 0
            # read + parse + transform, measured directly: wall minus
            # stall cancels badly for a fast reader
            read_s = 0.0
            it = loader.iter_batches(offset, parse_workers)
            while True:
                t = time.perf_counter()
                try:
                    batch, resume = next(it)
                except StopIteration:
                    break
                if transform is not None:
                    batch = transform(batch)
                read_s += time.perf_counter() - t
                yield _ITEM, shard_idx, batch, resume
                batches += 1
                examples += batch.num_real()
            yield _DONE, shard_idx, {
                "batches": batches,
                "examples": examples,
                "seconds": time.perf_counter() - t0,
                "read_seconds": read_s,
            }

    def __iter__(self) -> Iterator[tuple]:
        """The merge: global shard order, each shard pulled from its
        owning stream.  A stream's exception reaches the consumer here."""
        for si in range(self._start_shard, len(self._shards)):
            s = (si - self._start_shard) % self.num_streams
            for msg in self._streams[s]:
                if msg[0] == _DONE:
                    self._book_done(s, msg[2])
                    break
                _, shard_idx, batch, resume = msg
                if shard_idx != si:  # a stream emits its shards in order
                    raise RuntimeError(
                        f"stream {s} yielded shard {shard_idx} while the "
                        f"merge expected shard {si}"
                    )
                yield batch, shard_idx, resume

    def _book_done(self, s: int, stats: dict) -> None:
        acc = self._stats[s]
        acc["shards"] += 1
        for key in ("batches", "examples", "seconds", "read_seconds"):
            acc[key] += stats[key]
        # the stream's stall since its last finished shard (_PrefetchIter
        # accounts over the stream's whole life)
        total = self._streams[s].stall_seconds()
        acc["stall_seconds"] += total - self._stall_base[s]
        self._stall_base[s] = total

    def stream_stats(self) -> list[dict]:
        """Per-stream accounting over the shards finished so far: the
        trainer's ``stream`` rows.  ``examples_per_sec`` divides by the
        read seconds (queue waits excluded), so a stream parked behind a
        saturated consumer does not read as a straggler."""
        out = []
        for acc in self._stats:
            row = dict(acc)
            for key in ("seconds", "read_seconds", "stall_seconds"):
                row[key] = round(acc[key], 6)
            row["examples_per_sec"] = round(
                acc["examples"] / max(acc["read_seconds"], 1e-9), 1
            )
            out.append(row)
        return out

    def close(self, join_timeout: float = 5.0) -> None:
        """Stop every stream's producer, each with a bounded join (a
        wedged producer is counted and reported by
        ``_PrefetchIter.close``).  Idempotent."""
        for stream in self._streams:
            stream.close(join_timeout)

    @property
    def alive(self) -> bool:
        return any(stream.alive for stream in self._streams)

    def __enter__(self) -> "ShardStreamPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
