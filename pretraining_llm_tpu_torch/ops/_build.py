"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` on its own into a shared library with a
plain C interface (``-gencode arch=compute_90a,code=sm_90a``: Hopper, with
the ``a`` features: ``wgmma``) and loaded with ``ctypes``. Sources are built
in parallel, one ``nvcc`` process each. A library's file name carries a hash
of its source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged one is reused. The
tensor-core kernels build TMA tensor maps with the driver's
``cuTensorMapEncodeTiled``, reached through the runtime's driver entry point
(``cudaGetDriverEntryPoint``), so no library links ``-lcuda``. The build directory is ``build/kernels`` beside the package
(git ignores it).

Every pointer argument is declared ``c_void_p`` (a bare Python int would
be cut to 32 bits), the stream is PyTorch's current stream, and each C
entry returns ``cudaGetLastError()``; ``check`` raises when it is not 0.
``counters`` hands the kernels that merge partials across blocks (the
paged decode split route, the fused CE kernels on the tensor cores) their
arrival counters. ``aligned`` gives the kernels that read 16 bytes at a
time (TMA, vector loads) an operand that starts on a 16-byte boundary.
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

import torch

from pretraining_llm_tpu_torch.observability.device import note_build

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = (
    "flash_fwd", "flash_fwd_tc", "flash_bwd", "flash_bwd_tc", "fused_ce", "fused_ce_tc", "fused_ce_bwd_tc",
    "paged_decode", "ragged_paged", "ragged_paged_tc",
)
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
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile every missing library among ``names``, all ``nvcc``
    processes started together. Returns, per source, the seconds its build
    took and nvcc's output (ptxas registers, shared memory and spills);
    (0.0, "") for a library that was already built. Each finished build is
    reported to the build telemetry (``observability.device.note_build``)."""
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
            note_build("nvcc", name, done[name][0])
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


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters on ``device`` for kernels
    launched on ``stream``, all 0. A kernel that takes tickets from them
    sets each back to 0 before it ends, so they are 0 at every launch and
    are kept (per device and stream; stream order keeps launches apart)
    rather than zeroed by a launch of their own each call."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where it starts on a 16-byte boundary, else a contiguous
    copy in a fresh allocation (the allocators' blocks are aligned), on
    which the wrapper launches the same kernel: an input copy, not a
    fallback. JAX arrays carry no alignment contract, so a view that starts
    mid-row computes as any other operand does."""
    return x if x.data_ptr() % 16 == 0 else x.clone(memory_format=torch.contiguous_format)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
