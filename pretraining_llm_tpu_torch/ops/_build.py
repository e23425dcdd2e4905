"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` on its own into a shared library with a
plain C interface (``-gencode arch=compute_90a,code=sm_90a``: Hopper, with
the ``a`` features) and loaded with ``ctypes``. Sources are built in
parallel, one ``nvcc`` process each. A library's file name carries a hash
of its source and flags, so an edited source rebuilds and an unchanged one
is reused. The build directory is ``build/kernels`` beside the package
(git ignores it).

Every pointer argument is declared ``c_void_p`` (a bare Python int would
be cut to 32 bits), the stream is PyTorch's current stream, and each C
entry returns ``cudaGetLastError()``; ``check`` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("flash_fwd", "paged_decode")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
            "CUDA kernels are built from csrc/ at first use"
        )
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile every missing library among ``names``, all ``nvcc``
    processes started together. Returns, per source, the seconds its build
    took and nvcc's output (ptxas registers, shared memory and spills);
    (0.0, "") for a library that was already built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    done: Dict[str, Tuple[float, str]] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            done[name] = (0.0, "")
            continue
        nvcc = nvcc or _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        done[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    build([name])
    return ctypes.CDLL(str(library_path(name)))


@functools.lru_cache(maxsize=None)
def load(name: str, symbol: str, argtypes: Tuple) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of library ``name`` (built first if needed),
    with its argument types declared and an ``int`` (cudaError_t) result."""
    fn = getattr(_library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
