"""ctypes bindings of the port's native BPE encoder (``csrc/bpe.cpp``).

Counterpart of ``pretraining_llm_tpu/data/native_bpe.py``. The library is
built at first use by ``data/_native.py``; ``BPETokenizer`` takes the
Python sweep when it cannot be built. Both give the same ids.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

from pretraining_llm_tpu_torch.data._native import load_native_lib


def _configure(lib: ctypes.CDLL) -> None:
    lib.bpe_create.restype = ctypes.c_void_p
    lib.bpe_create.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.bpe_encode.restype = ctypes.c_int64
    lib.bpe_encode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.bpe_destroy.restype = None
    lib.bpe_destroy.argtypes = [ctypes.c_void_p]


def load_library() -> Tuple[Optional[ctypes.CDLL], str]:
    """(library or None, what was loaded or why not)."""
    return load_native_lib("bpe", _configure)


class NativeBpeEncoder:
    """A native merge table; encodes UTF-8 byte buffers to token ids."""

    def __init__(self, merges: Sequence[Tuple[int, int]]) -> None:
        lib, why = load_library()
        if lib is None:
            raise RuntimeError(f"native BPE library unavailable: {why}")
        self._lib = lib
        a = np.asarray([m[0] for m in merges], np.int32)
        b = np.asarray([m[1] for m in merges], np.int32)
        self._handle = lib.bpe_create(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(merges),
        )
        if not self._handle:
            raise RuntimeError("bpe_create failed")

    def encode_bytes(self, data: bytes) -> List[int]:
        n = len(data)
        if n == 0:
            return []
        buf = np.frombuffer(data, np.uint8)
        out = np.empty(n, np.int32)
        m = self._lib.bpe_encode(
            self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out[:m].tolist()

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.bpe_destroy(self._handle)
            self._handle = None

    def __del__(self) -> None:
        try:
            self.close()
        except (AttributeError, TypeError):  # interpreter shutdown: ctypes may be gone
            pass
