"""ctypes bindings of the port's native batch gatherer (``csrc/batcher.cpp``).

Counterpart of ``pretraining_llm_tpu/data/native_batcher.py``. The library
is built at first use by ``data/_native.py`` into ``build/native/``. The
iterator is counter-based: batch k of seed s is a function of (s, k) alone,
so its whole sampling state is one integer and the same seed and counter
give the JAX package's native batches. The trainer samples single token
files through it (``data.use_native_batcher``) and takes the numpy sampler
for mixtures or when the library cannot be built.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import numpy as np

from pretraining_llm_tpu_torch.data._native import load_native_lib


def _configure(lib: ctypes.CDLL) -> None:
    lib.batcher_open.restype = ctypes.c_void_p
    lib.batcher_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.batcher_num_tokens.restype = ctypes.c_int64
    lib.batcher_num_tokens.argtypes = [ctypes.c_void_p]
    lib.batcher_sample.restype = None
    lib.batcher_sample.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.batcher_close.restype = None
    lib.batcher_close.argtypes = [ctypes.c_void_p]


def load_library() -> Tuple[Optional[ctypes.CDLL], str]:
    """(library or None, what was loaded or why not)."""
    return load_native_lib("batcher", _configure)


def native_available() -> bool:
    return load_library()[0] is not None


class NativeBatchIterator:
    """Drop-in for ``data.loader.BatchIterator``, backed by the C++ gatherer."""

    def __init__(
        self, data_path: str, batch_size: int, context_length: int, *, seed: int = 1337,
        shard_index: int = 0, shard_count: int = 1, n_threads: int = 4,
    ) -> None:
        lib, why = load_library()
        if lib is None:
            raise RuntimeError(f"native batcher library unavailable: {why}")
        self._lib = lib
        self._handle = lib.batcher_open(data_path.encode(), context_length, shard_index, shard_count, n_threads)
        if not self._handle:
            raise ValueError(
                f"{data_path}: could not open (missing, or shard smaller than "
                f"context_length+1={context_length + 1})"
            )
        self.batch_size = batch_size
        self.context_length = context_length
        self.seed = seed
        self.counter = 0
        self._x = np.empty((batch_size, context_length), np.int32)
        self._y = np.empty((batch_size, context_length), np.int32)

    @property
    def n_tokens(self) -> int:
        return int(self._lib.batcher_num_tokens(self._handle))

    def __iter__(self) -> "NativeBatchIterator":
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        self._lib.batcher_sample(
            self._handle, ctypes.c_uint64(self.seed), ctypes.c_uint64(self.counter), self.batch_size,
            self._x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._y.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        self.counter += 1
        return self._x.copy(), self._y.copy()  # the buffers are reused by the next call

    def state(self) -> Dict[str, Any]:
        """The whole sampling state: the counter (and the seed)."""
        return {"native_counter": self.counter, "seed": self.seed}

    def set_state(self, state: Dict[str, Any]) -> None:
        if "native_counter" not in state:
            return  # written by the numpy sampler: this stream starts afresh, as in JAX
        self.counter = int(state["native_counter"])
        self.seed = int(state.get("seed", self.seed))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.batcher_close(self._handle)
            self._handle = None

    def __del__(self) -> None:
        try:
            self.close()
        except (AttributeError, TypeError):  # interpreter shutdown: ctypes may be gone
            pass
