"""Host-side batch sampling: uint16 token memmaps -> (x, y) shifted pairs.

An own copy of the numpy samplers of ``pretraining_llm_tpu/data/loader.py``
(``MemmapTokens``, ``BatchIterator``, ``get_batch_iterator``,
``SyntheticTokens``, ``synthetic_iterator``). The numpy RNG calls are the
same, so one seed yields the same batches in both packages, and the RNG
``state``/``set_state`` round-trip resumes the stream exactly. Mixture specs
and the background prefetcher are not ported: the trainer feeds batches
synchronously (pinned host memory, non-blocking copy).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Tuple

import numpy as np


class MemmapTokens:
    """Read-only view of a uint16 token file."""

    def __init__(self, path: str, context_length: int) -> None:
        data = np.memmap(path, dtype=np.uint16, mode="r")
        if len(data) < context_length + 1:
            raise ValueError(
                f"{path}: has {len(data)} tokens < context_length+1={context_length + 1}"
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


def get_batch_iterator(
    data_path: str, batch_size: int, context_length: int, *, seed: int = 1337,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Seeded numpy batches from one token file: the JAX package's
    iterator for process 0 of 1 (host sharding is not ported)."""
    if is_mixture(data_path):
        raise NotImplementedError(
            f"mixture data specs ({data_path!r}) are not ported to PyTorch yet"
        )
    return BatchIterator(MemmapTokens(data_path, context_length), batch_size, seed)


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
