"""Fused cross-entropy: the CUDA kernels ``csrc/fused_ce_tc.cu`` (the bf16
forward), ``csrc/fused_ce_bwd_tc.cu`` (the bf16 dH and dW) and
``csrc/fused_ce.cu`` (the fp32 forward, dH and dW) and their dispatch.

Counterpart of the three kernels of ``pretraining_llm_tpu/ops/pallas_ce.py``.
Each wrapper launches its kernel for CUDA tensors and runs the plain version
(``ops/ce_reference.py``) for CPU tensors; nothing falls back from one to
the other. W is taken as (V, D) row-major, as the kernels read it: for the
tied head that is the embedding itself, with no copy. ``.launches`` on
each wrapper counts kernel launches.

The forward has two routes, chosen by dtype before launch (``ce_route``):
bf16 runs ``csrc/fused_ce_tc.cu`` (``"wgmma"``: TMA ring, wgmma, the
vocabulary cut into ``ce_partitions`` partitions merged by the last block
of each token tile), fp32 runs ``ce32_kernel<FWD>`` of
``csrc/fused_ce.cu`` (``"fp32"``), because wgmma's fp32 form is TF32 and
would miss the fp32 bars. ``fused_ce_fwd.launches_by_route`` counts both.
dH and dW take the same two routes by dtype (``ce_bwd_route``): bf16 runs
``csrc/fused_ce_bwd_tc.cu`` (``"wgmma"``: TMA ring, wgmma for the logits
and the second product, the output in D-chunks and the walked axis in
partitions, both from ``ce_bwd_plan``), fp32 runs ``ce32_kernel<DH / DW,
NT2>`` of ``csrc/fused_ce.cu``; ``fused_ce_dh.launches_by_route`` and
``fused_ce_dw.launches_by_route`` count them. Both routes take any D that
is a multiple of 64 (``hidden_dim_ok``): the fp32 kernels stream D too (in
64-column slices for the logits, in output chunks of up to 512 columns for
dH and dW).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pretraining_llm_tpu_torch.ops import _build
from pretraining_llm_tpu_torch.ops.ce_reference import (
    fused_ce_dh_reference,
    fused_ce_dw_reference,
    fused_ce_fwd_reference,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("wgmma", "fp32")
TC_BM, TC_BN, TC_BK, TC_STAGES = 128, 256, 64, 4  # csrc/fused_ce_tc.cu's tile, slice and ring
MAX_PARTITIONS = 16
# csrc/fused_ce_bwd_tc.cu: output rows, walked rows and ring depth of a
# block, the chunk widths DC it is built for, and the plan's partition cap.
BWD_BM, BWD_BN, BWD_STAGES = 128, 128, 5
BWD_CHUNKS = (128, 192, 256)
MAX_BWD_PARTITIONS = 8
# ce_bwd_plan's costs in its unit, one column of D in a walked tile's
# products (128 x 128 x 2 FLOPs, ~8 SM cycles): a tile's epilogue (exp2,
# label, g, packing), and per column of a chunk, a block's partial written
# to device memory and read back by the merge (2 x 128 fp32 at an SM's
# ~14 bytes per cycle share of the memory rate).
BWD_EPILOGUE_COLUMNS = 128
BWD_PARTIAL_COLUMNS = 9
# (h, w, labels, <lse, g,> <outputs>, S, V, D, dtype, stream)
_FWD_ARGTYPES = tuple([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_BWD_ARGTYPES = tuple([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# (h, w, labels, loss, lse, part, counters, S, V, D, parts, tiles_per_part, stream)
_TC_ARGTYPES = tuple([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# (mode, h, w, labels, lse, g, out, part, counters, S, V, D, dc, parts, tiles_per_part, stream)
_TC_BWD_ARGTYPES = tuple([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_BWD_MODES = {"dh": 0, "dw": 1}


def ce_route(dtype: torch.dtype) -> str:
    """The forward kernel a CUDA call takes: ``"wgmma"``
    (``csrc/fused_ce_tc.cu``) for bfloat16, ``"fp32"`` (``csrc/fused_ce.cu``)
    for float32. Raises for other dtypes."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the fused CE kernels take float32 or bfloat16, got {dtype}")
    return "wgmma" if dtype == torch.bfloat16 else "fp32"


def ce_bwd_route(dtype: torch.dtype) -> str:
    """The dH and dW kernel a CUDA call takes: ``"wgmma"``
    (``csrc/fused_ce_bwd_tc.cu``) for bfloat16, ``"fp32"``
    (``csrc/fused_ce.cu``) for float32. Raises for other dtypes."""
    return ce_route(dtype)


def hidden_dim_ok(dtype: torch.dtype, d: int) -> bool:
    """Whether the CUDA kernels take hidden width ``d`` in ``dtype``: any
    positive multiple of 64 in either dtype (every kernel streams D in
    64-column slices)."""
    return dtype in _DTYPE_CODES and d > 0 and d % 64 == 0


def ce_partitions(s: int, v: int, sm_count: int) -> Tuple[int, int]:
    """(partitions, vocabulary tiles per partition) of the tensor-core
    forward: of P = 1..MAX_PARTITIONS, the one whose grid of ceil(S / 128)
    x P one-block-per-SM blocks needs the fewest block waves times tiles
    per block (the smallest P on a tie), then no partition left empty."""
    n_st, n_vt = -(-s // TC_BM), -(-v // TC_BN)
    best = None
    for p in range(1, min(MAX_PARTITIONS, n_vt) + 1):
        per = -(-n_vt // p)
        cost = -(-(n_st * p) // sm_count) * per
        if best is None or cost < best[0]:
            best = (cost, per)
    per = best[1]
    return -(-n_vt // per), per


def ce_bwd_plan(kind: str, s: int, v: int, d: int, sm_count: int) -> Tuple[int, int, int, int]:
    """(DC, chunks, partitions, walked tiles per partition) of the
    tensor-core dH (``kind="dh"``: 128-token output tiles, the vocabulary
    walked) or dW (``"dw"``: 128-row vocabulary tiles, the tokens walked)
    kernel. Of the chunk widths BWD_CHUNKS and P = 1..MAX_BWD_PARTITIONS,
    the pair whose grid of output tiles x ceil(D / DC) chunks x P
    one-block-per-SM blocks needs the fewest block waves times the work of
    a block: its walked tiles times D + min(DC, D) (the logits over all of
    D, the second product over its chunk) + BWD_EPILOGUE_COLUMNS, and with P
    > 1 its partial's round trip, BWD_PARTIAL_COLUMNS x min(DC, D). Ties go
    to fewer partitions, then fewer chunks, then the narrower DC; then no
    partition is left empty."""
    if kind not in _BWD_MODES:
        raise ValueError(f"kind must be 'dh' or 'dw', got {kind!r}")
    rows, walked = (s, v) if kind == "dh" else (v, s)
    n_rt, n_wt = -(-rows // BWD_BM), -(-walked // BWD_BN)
    best = None
    for dc in BWD_CHUNKS:
        chunks = -(-d // dc)
        for p in range(1, min(MAX_BWD_PARTITIONS, n_wt) + 1):
            per = -(-n_wt // p)
            waves = -(-(n_rt * chunks * p) // sm_count)
            width = min(dc, d)
            work = per * (d + width + BWD_EPILOGUE_COLUMNS) + (BWD_PARTIAL_COLUMNS * width if p > 1 else 0)
            key = (waves * work, p, chunks, dc)
            if best is None or key < best[0]:
                best = (key, dc, chunks, per)
    _, dc, chunks, per = best
    return dc, chunks, -(-n_wt // per), per


def tc_bwd_smem_bytes(dc: int) -> int:
    """Shared memory one block of ``csrc/fused_ce_bwd_tc.cu`` with chunk
    width ``dc`` uses (must match its ``Smem<DC>``): a ring of BWD_STAGES
    slices of the resident (128 rows) and walked (128 rows) operands of 64
    columns, the chunk buffer (dc / 64 walked slices), a walked tile's lse,
    g and labels, the barriers, the last-block flag and room to align the
    base."""
    x_slice = BWD_BN * TC_BK * 2
    ring = BWD_STAGES * (BWD_BM * TC_BK * 2 + x_slice)
    return ring + dc // TC_BK * x_slice + 3 * BWD_BN * 4 + (2 * BWD_STAGES + 1) * 8 + 16 + 1024


def tc_smem_bytes() -> int:
    """Shared memory one block of ``csrc/fused_ce_tc.cu`` uses (must match
    its ``Smem``): a ring of TC_STAGES slices of h (128 rows) and W (256
    rows) of 64 columns, the barriers, the last-block flag and room to
    align the base."""
    stage = TC_BM * TC_BK * 2 + TC_BN * TC_BK * 2
    return TC_STAGES * stage + 2 * TC_STAGES * 8 + 16 + 1024


def _check(what: str, h: torch.Tensor, w_vd: torch.Tensor, labels: torch.Tensor, *rows: torch.Tensor) -> None:
    if h.ndim != 2 or w_vd.ndim != 2 or h.shape[1] != w_vd.shape[1] or labels.shape != (h.shape[0],):
        raise ValueError(f"{what}: expected h (S, D), w (V, D), labels (S,); got "
                         f"{tuple(h.shape)}, {tuple(w_vd.shape)}, {tuple(labels.shape)}")
    if any(r.shape != (h.shape[0],) for r in rows):
        raise ValueError(f"{what}: lse and g must be (S,), got {[tuple(r.shape) for r in rows]}")


def _check_cuda(what: str, h: torch.Tensor, w_vd: torch.Tensor, labels: torch.Tensor, *rows: torch.Tensor) -> None:
    """The kernels' contract: one CUDA device; h and w of one dtype (fp32 or
    bf16), a hidden width ``hidden_dim_ok`` takes; int32 labels and fp32
    lse/g; all contiguous. (h and w that do not start on a 16-byte boundary
    are copied by the wrappers: ``_build.aligned``.)"""
    tensors = (h, w_vd, labels) + rows
    if h.device.type != "cuda" or any(x.device != h.device for x in tensors):
        raise ValueError(f"{what}: tensors on {[str(x.device) for x in tensors]}")
    if h.dtype not in _DTYPE_CODES or w_vd.dtype != h.dtype:
        raise TypeError(f"{what} takes float32 or bfloat16 h and w of one dtype, got {h.dtype}, {w_vd.dtype}")
    if labels.dtype != torch.int32 or any(r.dtype != torch.float32 for r in rows):
        raise TypeError(f"{what}: labels must be int32 and lse/g float32")
    if not hidden_dim_ok(h.dtype, h.shape[1]):
        raise ValueError(f"{what}: hidden dim {h.shape[1]} is not a positive multiple of 64")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def fused_ce_fwd(
    h: torch.Tensor, w_vd: torch.Tensor, labels: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel (``pallas_ce._fwd_kernel``): h (S, D), w_vd (V, D),
    labels (S,) -> (loss (S,) fp32, lse (S,) fp32), through the kernel
    ``ce_route`` picks."""
    _check("fused_ce_fwd", h, w_vd, labels)
    if h.device.type == "cpu":
        return fused_ce_fwd_reference(h, w_vd.t(), labels)
    _check_cuda("fused_ce_fwd", h, w_vd, labels)
    h, w_vd = _build.aligned(h), _build.aligned(w_vd)
    s, d = h.shape
    v = w_vd.shape[0]
    loss = torch.empty((s,), dtype=torch.float32, device=h.device)
    lse = torch.empty((s,), dtype=torch.float32, device=h.device)
    stream = _stream(h)
    route = ce_route(h.dtype)
    if route == "wgmma":
        parts, per = ce_partitions(s, v, _build.sm_count(h.device.index))
        part = torch.empty(3 * parts * s if parts > 1 else 0, dtype=torch.float32, device=h.device)
        counters = _build.counters(h.device, stream, -(-s // TC_BM))
        fn = _build.load("fused_ce_tc", "pllm_ce_fwd_tc", _TC_ARGTYPES)
        rc = fn(h.data_ptr(), w_vd.data_ptr(), labels.data_ptr(), loss.data_ptr(), lse.data_ptr(),
                part.data_ptr(), counters.data_ptr(), s, v, d, parts, per, stream)
    else:
        fn = _build.load("fused_ce", "pllm_ce_fwd", _FWD_ARGTYPES)
        rc = fn(h.data_ptr(), w_vd.data_ptr(), labels.data_ptr(), loss.data_ptr(), lse.data_ptr(),
                s, v, d, _DTYPE_CODES[h.dtype], stream)
    _build.check(rc, f"fused_ce_fwd ({route})")
    fused_ce_fwd.launches += 1
    fused_ce_fwd.launches_by_route[route] += 1
    return loss, lse


def _bwd(kind: str, h, w_vd, labels, lse, g, out) -> str:
    """Launches the dH (``kind="dh"``) or dW kernel ``ce_bwd_route`` picks
    into ``out``; returns the route."""
    s, d = h.shape
    v = w_vd.shape[0]
    stream = _stream(h)
    route = ce_bwd_route(h.dtype)
    if route == "wgmma":
        dc, chunks, parts, per = ce_bwd_plan(kind, s, v, d, _build.sm_count(h.device.index))
        n_tiles = -(-(s if kind == "dh" else v) // BWD_BM) * chunks
        part = torch.empty(parts * n_tiles * BWD_BM * dc if parts > 1 else 0, dtype=torch.float32, device=h.device)
        counters = _build.counters(h.device, stream, n_tiles)
        fn = _build.load("fused_ce_bwd_tc", "pllm_ce_bwd_tc", _TC_BWD_ARGTYPES)
        rc = fn(_BWD_MODES[kind], h.data_ptr(), w_vd.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
                out.data_ptr(), part.data_ptr(), counters.data_ptr(), s, v, d, dc, parts, per, stream)
    else:
        fn = _build.load("fused_ce", f"pllm_ce_{kind}", _BWD_ARGTYPES)
        rc = fn(h.data_ptr(), w_vd.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(), out.data_ptr(),
                s, v, d, _DTYPE_CODES[h.dtype], stream)
    _build.check(rc, f"fused_ce_{kind} ({route})")
    return route


def fused_ce_dh(
    h: torch.Tensor, w_vd: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
) -> torch.Tensor:
    """dH kernel (``pallas_ce._bwd_dh_kernel``): (S, D) in h's dtype, for the
    per-token cotangent g (S,) and the forward's lse, through the kernel
    ``ce_bwd_route`` picks."""
    _check("fused_ce_dh", h, w_vd, labels, lse, g)
    if h.device.type == "cpu":
        return fused_ce_dh_reference(h, w_vd.t(), labels, lse, g)
    _check_cuda("fused_ce_dh", h, w_vd, labels, lse, g)
    h, w_vd = _build.aligned(h), _build.aligned(w_vd)
    dh = torch.empty_like(h)
    route = _bwd("dh", h, w_vd, labels, lse, g, dh)
    fused_ce_dh.launches += 1
    fused_ce_dh.launches_by_route[route] += 1
    return dh


def fused_ce_dw(
    h: torch.Tensor, w_vd: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
) -> torch.Tensor:
    """dW kernel (``pallas_ce._bwd_dw_kernel``): (V, D) in w's dtype,
    through the kernel ``ce_bwd_route`` picks."""
    _check("fused_ce_dw", h, w_vd, labels, lse, g)
    if h.device.type == "cpu":
        return fused_ce_dw_reference(h, w_vd.t(), labels, lse, g).t()
    _check_cuda("fused_ce_dw", h, w_vd, labels, lse, g)
    h, w_vd = _build.aligned(h), _build.aligned(w_vd)
    dw = torch.empty_like(w_vd)
    route = _bwd("dw", h, w_vd, labels, lse, g, dw)
    fused_ce_dw.launches += 1
    fused_ce_dw.launches_by_route[route] += 1
    return dw


fused_ce_fwd.launches = 0
fused_ce_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)
fused_ce_dh.launches = 0
fused_ce_dh.launches_by_route = dict.fromkeys(ROUTES, 0)
fused_ce_dw.launches = 0
fused_ce_dw.launches_by_route = dict.fromkeys(ROUTES, 0)
