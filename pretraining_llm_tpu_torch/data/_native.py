"""Build and load the port's host C++ libraries (``csrc/*.cpp``) at first use.

The port's own counterpart of ``pretraining_llm_tpu/data/_native.py``: the
source is the port's copy inside its package, compiled by the host C++
compiler (``$CXX``, else ``g++`` or ``c++``) into ``build/native/`` beside
the package (git ignores it), never into the repo's ``native/``. The
library's file name carries a hash of its source and the flags, so an
edited source rebuilds. Builds are serialized across processes with an
``fcntl`` lock (preprocess fans out worker processes) and write to a
temporary name that is renamed into place, so no process loads a
half-written library. ``load_native_lib`` returns None, with the reason,
when no compiler or library is available; callers take their Python path.
Each finished build is reported to the build telemetry
(``observability.device.note_build``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

from pretraining_llm_tpu_torch.observability.device import note_build

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_cache: Dict[str, Tuple[Optional[ctypes.CDLL], str]] = {}
_cache_lock = threading.Lock()


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compiler() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


def _build(name: str, path: Path) -> None:
    cxx = _compiler()
    if cxx is None:
        raise FileNotFoundError("no host C++ compiler ($CXX, g++ or c++)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():  # a peer process built it meanwhile
                return
            tmp = path.with_suffix(f".tmp{os.getpid()}")
            t0 = time.perf_counter()
            subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, path)
            note_build("cxx", name, time.perf_counter() - t0)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load_native_lib(
    name: str, configure: Callable[[ctypes.CDLL], None],
) -> Tuple[Optional[ctypes.CDLL], str]:
    """(library, reason): ``build/native/lib<name>-<hash>.so`` built from
    ``csrc/<name>.cpp`` if absent, loaded, and ``configure(lib)`` run on it
    (argtypes and restypes); (None, why) when that fails. The result is
    cached per process."""
    with _cache_lock:
        if name not in _cache:
            path = library_path(name)
            try:
                if not path.exists():
                    _build(name, path)
                lib = ctypes.CDLL(str(path))
                configure(lib)
                _cache[name] = (lib, f"native ({path.name})")
            except (subprocess.SubprocessError, OSError, AttributeError) as e:
                _cache[name] = (None, f"{type(e).__name__}: {e}")
        return _cache[name]
