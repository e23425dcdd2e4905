"""Host-side batch sampling: uint16 token memmaps -> (x, y) shifted pairs.

An own copy of the numpy samplers of ``pretraining_llm_tpu/data/loader.py``
(``MemmapTokens``, ``BatchIterator``, mixture specs with ``parse_mixture``
and ``MixtureIterator``, ``get_batch_iterator``, ``SyntheticTokens``,
``synthetic_iterator``) and of its ``DevicePrefetcher``. The numpy RNG calls
are the same, so one seed yields the same batches in both packages, and the
RNG ``state``/``set_state`` round-trip resumes the stream exactly. Host
sharding is not ported (one process).
"""

from __future__ import annotations

import atexit
import os
import queue
import threading
import weakref
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np


class MemmapTokens:
    """Read-only view of a uint16 token file, or of one node's shard of it:
    with ``shard_count`` > 1 node ``shard_index`` reads its contiguous block
    of the stream plus ``context_length`` tokens of overlap, so every
    window that crosses a block boundary belongs to exactly one node (the
    JAX package's host shard)."""

    def __init__(self, path: str, context_length: int, shard_index: int = 0, shard_count: int = 1) -> None:
        data = np.memmap(path, dtype=np.uint16, mode="r")
        if shard_count > 1:
            n = len(data)
            lo = (n * shard_index) // shard_count
            hi = min((n * (shard_index + 1)) // shard_count + context_length, n)
            data = data[lo:hi]
        if len(data) < context_length + 1:
            raise ValueError(
                f"{path}: {'shard has' if shard_count > 1 else 'has'} {len(data)} tokens < "
                f"context_length+1={context_length + 1}"
            )
        self.data = data
        self.context_length = context_length

    def sample_batch(self, rng: np.random.Generator, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        t = self.context_length
        # Crop starts 0 .. len-(t+1) inclusive (the window reads t+1 tokens).
        starts = rng.integers(0, len(self.data) - t, size=batch_size)
        idx = starts[:, None] + np.arange(t + 1)[None, :]
        tokens = self.data[idx].astype(np.int32)
        return tokens[:, :-1], tokens[:, 1:]


class BatchIterator:
    """Infinite seeded batch iterator with checkpointable RNG state."""

    def __init__(self, source: Any, batch_size: int, seed: int) -> None:
        self.source = source
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> "BatchIterator":
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.source.sample_batch(self._rng, self.batch_size)

    def state(self) -> Dict[str, Any]:
        return {"bit_generator": self._rng.bit_generator.state}

    def set_state(self, state: Dict[str, Any]) -> None:
        if "bit_generator" not in state:
            return  # written by another iterator backend
        self._rng.bit_generator.state = state["bit_generator"]


def is_mixture(data_path: str) -> bool:
    """A comma marks a mixture spec, unless the whole string names a file."""
    return "," in data_path and not os.path.exists(data_path)


def parse_mixture(spec: str) -> List[Tuple[str, float]]:
    """Comma-separated ``path[:weight]`` entries: "a.bin:3,b.bin:1" ->
    [("a.bin", 3.0), ("b.bin", 1.0)] (weights need not normalize; an omitted
    weight is 1). A non-numeric ':' suffix belongs to the path; an empty
    path or a dangling ':' raises, naming the entry."""
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        path, sep, w = entry.rpartition(":")
        if sep:
            if path and w and w.replace(".", "", 1).isdigit():
                out.append((path, float(w)))
                continue
            if not path or not w:
                raise ValueError(f"malformed mixture entry {entry!r} in {spec!r}: expected path[:weight]")
        out.append((entry, 1.0))
    if not out:
        raise ValueError(f"empty mixture spec {spec!r}")
    return out


class MixtureIterator:
    """Weighted mixture over several token streams: each batch row draws
    its source by weight, then a crop from that source, all from one seeded
    generator, so the mixture checkpoints through one RNG state."""

    def __init__(self, sources: List[MemmapTokens], weights: List[float], batch_size: int, seed: int) -> None:
        if len(sources) != len(weights) or not sources:
            raise ValueError("sources and weights must be equal-length, non-empty")
        total = float(sum(weights))
        if total <= 0 or any(w < 0 for w in weights):
            raise ValueError(f"mixture weights must be >= 0 with a positive sum: {weights}")
        self.sources = sources
        self.weights = np.asarray([w / total for w in weights], np.float64)
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> "MixtureIterator":
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        choice = self._rng.choice(len(self.sources), size=self.batch_size, p=self.weights)
        t = self.sources[0].context_length
        xs = np.empty((self.batch_size, t), np.int32)
        ys = np.empty((self.batch_size, t), np.int32)
        for si in range(len(self.sources)):
            rows = np.nonzero(choice == si)[0]
            if rows.size:
                xs[rows], ys[rows] = self.sources[si].sample_batch(self._rng, rows.size)
        return xs, ys

    state = BatchIterator.state
    set_state = BatchIterator.set_state


def get_batch_iterator(
    data_path: str, batch_size: int, context_length: int, *, seed: int = 1337,
    shard_index: int = 0, shard_count: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Seeded numpy batches from one token file or a mixture spec
    (``parse_mixture``): the JAX package's iterator. Node ``shard_index`` of
    ``shard_count`` samples its shard of each file (``MemmapTokens``) with
    the seed ``seed + 7919 * shard_index``, as a JAX process does."""
    host_seed = seed + 7919 * shard_index
    if is_mixture(data_path):
        entries = parse_mixture(data_path)
        sources = [MemmapTokens(p, context_length, shard_index, shard_count) for p, _ in entries]
        return MixtureIterator(sources, [w for _, w in entries], batch_size, host_seed)
    return BatchIterator(MemmapTokens(data_path, context_length, shard_index, shard_count), batch_size, host_seed)


class SyntheticTokens:
    """Deterministic degree-2 Markov token stream: learnable structure with
    no files needed."""

    def __init__(self, vocab_size: int, context_length: int, seed: int = 0) -> None:
        rng = np.random.default_rng(seed)
        n = max(context_length * 64, 65536)
        table = rng.integers(0, vocab_size, size=(vocab_size, 4))
        stream = np.empty(n, dtype=np.uint16)
        stream[0] = rng.integers(vocab_size)
        choices = rng.integers(0, 4, size=n)
        for i in range(1, n):
            stream[i] = table[stream[i - 1], choices[i]]
        self.data = stream
        self.context_length = context_length

    sample_batch = MemmapTokens.sample_batch


def synthetic_iterator(vocab_size: int, context_length: int, batch_size: int, seed: int = 0) -> BatchIterator:
    return BatchIterator(SyntheticTokens(vocab_size, context_length, seed), batch_size, seed)


class DevicePrefetcher:
    """Samples host batches and puts them on the device ``depth`` batches
    ahead of the training step, on a background thread, without giving up
    exact resume.

    ``put_fn(host_batch) -> device_batch``. On a card the trainer's put
    copies pinned host memory on a side CUDA stream and records an event
    there; the consumer's stream waits on that event (``__next__``) before
    the step reads the batch, and the batch's memory is marked as used by
    the consumer's stream. On the CPU the put is a plain conversion.

    Each produced batch carries the source iterator's RNG state taken right
    after drawing it; ``state()`` is that of the last batch the consumer
    took, the consumed-batch frontier the synchronous loop would
    checkpoint. Batches still queued at a checkpoint are drawn again,
    identically, on resume.
    """

    _DONE = object()

    def __init__(self, iterator: Iterator[Any], put_fn: Callable[[Any], Any], depth: int = 2) -> None:
        self._it = iterator
        self._put = put_fn
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._exhausted = False
        has_state = hasattr(iterator, "state")
        self._state = iterator.state() if has_state else None
        self._thread = threading.Thread(target=self._worker, args=(has_state,), daemon=True)
        self._thread.start()
        _LIVE_PREFETCHERS.add(self)

    def _offer(self, item: Any) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, has_state: bool) -> None:
        try:
            # Stop is checked before each draw: after close() the source must
            # not advance, since its owner may rewind it to the frontier.
            while not self._stop.is_set():
                try:
                    batch = next(self._it)
                except StopIteration:
                    break
                snap = self._it.state() if has_state else None
                if not self._offer((self._put(batch), snap)):
                    return
        except Exception as e:  # surface loader errors on the consumer side
            self._offer(e)
        finally:
            self._offer(self._DONE)

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Any:
        if self._exhausted:
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        (batch, ready), snap = item
        if ready is not None:
            ready()
        if snap is not None:
            self._state = snap
        return batch

    def state(self) -> Any:
        """RNG frontier of the batches consumed (not produced)."""
        return self._state

    def close(self) -> bool:
        """Stop the worker and join it; True when it is dead (only then may
        the caller rewind the source to ``state()``)."""
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)
        return not self._thread.is_alive()


# A daemon worker that outlives its owner would keep copying to the device
# while the interpreter tears down: stop every live worker at exit.
_LIVE_PREFETCHERS: "weakref.WeakSet[DevicePrefetcher]" = weakref.WeakSet()


def _stop_live_prefetchers() -> None:
    import time

    for p in list(_LIVE_PREFETCHERS):
        p._stop.set()
    deadline = time.monotonic() + 1.0
    for p in list(_LIVE_PREFETCHERS):
        p._thread.join(timeout=max(0.0, deadline - time.monotonic()))


atexit.register(_stop_live_prefetchers)
