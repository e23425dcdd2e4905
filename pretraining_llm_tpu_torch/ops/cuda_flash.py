"""Flash attention: the CUDA forward (K1), the CUDA backward (one-pass, dQ
and dK/dV kernels), their plain PyTorch versions, and the
``torch.autograd.Function`` that joins them.

Two routes, chosen by dtype (``kernel_route``): bf16 calls of K1 and of all
three backward kernels run on the tensor cores (``wgmma`` fed by TMA:
``csrc/flash_fwd_tc.cu``, ``csrc/flash_bwd_tc.cu``); fp32 calls run the
CUDA-core kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), because
TF32 products would miss the fp32 bars. On the tensor cores the one-pass
kernel sums dQ in a fixed order (a turn per key tile), and the fp32 one
pass sums per-key-tile partials in key-tile order, so every backward gives
the same bits on every launch. Each kernel's launch counter is kept per
route (``launches_tc``, ``launches_fp32``) beside the total (``launches``).

Counterpart of ``pretraining_llm_tpu/ops/pallas_flash.py``: causal
(optionally sliding-window) attention over the heads-first folds q (B*H,
T, Dh) and k/v (B*G, T, Dh); query head h reads KV head h // (H/G). With
``segments`` ((B, T) int32 document ids) a query sees only keys of its own
document: the mask ANDs ``seg[q] == seg[k]`` into the causal/window mask
(the Pallas ``_mask_ok``); block skipping stays causal/window only, as
``_run_ok`` is.
``flash_attention_fwd`` and ``flash_attention_bwd`` launch the kernels for
CUDA tensors and run the plain versions only for CPU tensors. The backward
picks its algorithm with the JAX package's rule (``_block_sizes``): one q
block and one kv block run the one-pass kernel, anything else the dQ +
dK/dV pair, so both packages take the same path for every shape.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pretraining_llm_tpu_torch.ops import _build, remat

NEG_INF = -1e30  # finite, as in the Pallas kernel: exp/max edge cases
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
# (q, k, v, segments, o, lse, B, H, G, T, D, window, scale, dtype, stream)
_ARGTYPES = tuple(
    [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
# (q, k, v, dout, lse, delta, segments, <n outputs>, B, H, G, T, D, window, scale, dtype, stream)
_BWD_ARGTYPES = {
    n_out: tuple(
        [ctypes.c_void_p] * (7 + n_out)
        + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    for n_out in (1, 2, 3, 4, 5)
}


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that a CUDA call of K1 or of a backward kernel (one pass,
    dQ, dK/dV) takes: ``"wgmma"`` (the tensor-core kernels) for bfloat16,
    ``"fp32"`` (the CUDA-core kernels) for float32. Raises for any other
    dtype or a head dim outside _HEAD_DIMS."""
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not in {_HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "fp32"
    raise TypeError(f"flash kernels take float32 or bfloat16, got {dtype}")


def _block_sizes(t: int, block_q: int, block_kv: int) -> Tuple[int, int]:
    """The JAX package's block rule (``pallas_flash._block_sizes``), copied
    unchanged: it decides the backward's algorithm here, as it does there."""
    bq = min(block_q or 1024, t)
    bk = min(block_kv or 1024, t)
    while t % bq:
        bq //= 2
    while t % bk:
        bk //= 2
    return max(bq, 1), max(bk, 1)


def backward_is_one_pass(t: int, block_q: int = 0, block_kv: int = 0) -> bool:
    """True when ``_bwd`` would take ``_bwd_fused_kernel`` (nq == nk == 1)."""
    bq, bk = _block_sizes(t, block_q, block_kv)
    return t // bq == 1 and t // bk == 1


def _valid_mask(t: int, window: int, device: torch.device,
                segments: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernels' mask (``_mask_ok``): (T, T) causal and window, or
    (B, 1, 1, T, T) with the same-document condition ANDed in."""
    qpos = torch.arange(t, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    ok = qpos >= kpos
    if window:
        ok = ok & (qpos - kpos < window)
    if segments is not None:
        ok = ok & (segments[:, :, None] == segments[:, None, :])[:, None, None]
    return ok


def _seg_ptr(segments: Optional[torch.Tensor], q: torch.Tensor, b: int, t: int) -> Optional[int]:
    """The kernels' segment pointer (None: no document mask), after checking
    the (B, T) int32 contiguous contract on q's device."""
    if segments is None:
        return None
    if segments.shape != (b, t) or segments.dtype != torch.int32 or not segments.is_contiguous():
        raise ValueError(f"segments must be a contiguous (B, T) = ({b}, {t}) int32 tensor, got "
                         f"{tuple(segments.shape)} {segments.dtype}")
    if segments.device != q.device:
        raise ValueError(f"segments on {segments.device}, q on {q.device}")
    return segments.data_ptr()


def _check_folds(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, h: int, g: int) -> None:
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3:
        raise ValueError(f"expected q (B*H,T,Dh), k/v (B*G,T,Dh); got {q.shape}, {k.shape}, {v.shape}")
    bh, t, d = q.shape
    if h % g or bh % h or k.shape != (bh // h * g, t, d):
        raise ValueError(f"q {tuple(q.shape)} / kv {tuple(k.shape)} do not fold H={h}, G={g}")


def _check_cuda(what: str, tensors: Tuple[torch.Tensor, ...], same_dtype: Tuple[torch.Tensor, ...]) -> None:
    """The kernels' contract: one CUDA device, fp32 or bf16 operands of one
    dtype, Dh in _HEAD_DIMS, contiguous."""
    q = tensors[0]
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError(f"{what}: tensors on {[str(x.device) for x in tensors]}")
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in same_dtype):
        raise TypeError(f"{what} takes float32 or bfloat16, got {[x.dtype for x in same_dtype]}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{what}: head dim {q.shape[-1]} not in {_HEAD_DIMS}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")


def flash_attention_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, h: int, g: int, *,
    window: int = 0, segments: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: same causal, window and segment masks, fp32 softmax with
    finite NEG_INF, masked p zeroed, P cast to V's dtype before PV, zeros
    for a row with no visible key. Returns (o like q, lse (B*H, T) fp32)."""
    bh, t, d = q.shape
    b = bh // h
    qf = q.reshape(b, g, h // g, t, d).float()
    kf = k.reshape(b, g, t, d).float()
    vf = v.reshape(b, g, t, d)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, kf) * (1.0 / d**0.5)
    ok = _valid_mask(t, window, q.device, segments)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p.to(v.dtype).float(), vf.float()) / safe_l
    lse = (m + torch.log(safe_l))[..., 0]
    return o.reshape(bh, t, d).to(q.dtype), lse.reshape(bh, t)


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, h: int, g: int, *,
    window: int = 0, segments: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 for CUDA tensors, the plain version for CPU tensors.

    q: (B*H, T, Dh); k, v: (B*G, T, Dh), contiguous, one dtype (fp32 or
    bf16), Dh in {32, 64, 128}; segments: None or (B, T) int32 document ids.
    Returns (o like q, lse (B*H, T) fp32).
    bf16 runs the tensor-core kernel, fp32 the CUDA-core one
    (``kernel_route``). ``flash_attention_fwd.launches`` counts kernel
    launches, ``.launches_tc`` and ``.launches_fp32`` those of each route."""
    _check_folds(q, k, v, h, g)
    bh, t, d = q.shape
    seg = _seg_ptr(segments, q, bh // h, t)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, h, g, window=window, segments=segments)
    _check_cuda("flash_attention_fwd", (q, k, v), (q, k, v))
    route = kernel_route(q.dtype, d)
    if route == "wgmma":  # TMA reads each operand from a 16-byte aligned address
        q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    lib = "flash_fwd_tc" if route == "wgmma" else "flash_fwd"
    fn = _build.load(lib, f"pllm_{lib}", _ARGTYPES)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg, o.data_ptr(), lse.data_ptr(),
        bh // h, h, g, t, d, int(window), 1.0 / d**0.5,
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, lib)
    flash_attention_fwd.launches += 1
    if route == "wgmma":
        flash_attention_fwd.launches_tc += 1
    else:
        flash_attention_fwd.launches_fp32 += 1
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_tc = 0
flash_attention_fwd.launches_fp32 = 0


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, h: int, g: int, *, window: int = 0,
    segments: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``pallas_flash._bwd`` (either algorithm: they differ
    only in summation order). D = rowsum(dO*O) in fp32; p = exp(s - lse)
    zeroed by the mask; every product in fp32 on compute-dtype operands,
    with dS rounded to K's (Q's) dtype before dS.K (dS^T.Q) and P to dO's
    before P^T.dO; the GQA group's heads sum into dK and dV. Returns (dq
    like q, dk like k, dv like v)."""
    bh, t, d = q.shape
    b = bh // h
    r = h // g
    scale = 1.0 / d**0.5
    qf = q.reshape(b, g, r, t, d).float()
    kf = k.reshape(b, g, t, d).float()
    vf = v.reshape(b, g, t, d).float()
    dof = do.reshape(b, g, r, t, d).float()
    delta = (do.float() * o.float()).sum(-1).reshape(b, g, r, t, 1)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, kf) * scale
    ok = _valid_mask(t, window, q.device, segments)
    p = torch.where(ok, torch.exp(s - lse.reshape(b, g, r, t, 1)), torch.zeros_like(s))
    dp = torch.einsum("bgrqd,bgkd->bgrqk", dof, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bgrqk,bgkd->bgrqd", ds.to(k.dtype).float(), kf)
    dk = torch.einsum("bgrqk,bgrqd->bgkd", ds.to(q.dtype).float(), qf)
    dv = torch.einsum("bgrqk,bgrqd->bgkd", p.to(do.dtype).float(), dof)
    return (
        dq.reshape(bh, t, d).to(q.dtype),
        dk.reshape(b * g, t, d).to(k.dtype),
        dv.reshape(b * g, t, d).to(v.dtype),
    )


def _bwd_call(symbol: str, n_out: int, what: str, q, k, v, do, lse, delta, outs, h, g, window,
              segments, lib: str = "flash_bwd") -> None:
    bh, t, d = q.shape
    seg = _seg_ptr(segments, q, bh // h, t)
    fn = _build.load(lib, symbol, _BWD_ARGTYPES[n_out])
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), seg,
        *(x.data_ptr() for x in outs), bh // h, h, g, t, d, int(window), 1.0 / d**0.5,
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, what)


def _route_call(fn, tc: bool, q, k, v, do, lse, delta, outs, h, g, window, segments) -> None:
    """Launches the kernel of wrapper ``fn`` on its route (``kernel_route``):
    ``pllm_<name>_tc`` of ``csrc/flash_bwd_tc.cu`` for bf16 (``tc``; the
    operands TMA reads copied where they do not start on a 16-byte
    boundary), ``pllm_<name>`` of ``csrc/flash_bwd.cu`` for fp32, and
    counts it."""
    name = fn.__name__
    if tc:
        q, k, v, do = (_build.aligned(x) for x in (q, k, v, do))
        _bwd_call(f"pllm_{name}_tc", len(outs), f"{name}_tc", q, k, v, do, lse, delta, outs, h, g, window,
                  segments, lib="flash_bwd_tc")
        fn.launches_tc += 1
    else:
        _bwd_call(f"pllm_{name}", len(outs), name, q, k, v, do, lse, delta, outs, h, g, window, segments)
        fn.launches_fp32 += 1
    fn.launches += 1


def flash_bwd_fused(q, k, v, do, lse, delta, h, g, *, window=0, segments=None):
    """The one-pass kernel (``_bwd_fused_kernel``): (dq, dk, dv), dQ summed
    in a fixed order on either route, so a repeat launch gives the same
    bits. bf16 on the tensor cores (an fp32 scratch buffer and zeroed int32
    turn counters: one per (head, 64-query tile), and a ticket); fp32 on
    the CUDA cores (an fp32 partial per 64-key tile, summed in key-tile
    order by a second kernel of the same call). CUDA tensors only, as
    validated by ``flash_attention_bwd``. ``.launches`` counts launches,
    ``.launches_tc`` and ``.launches_fp32`` those of each route."""
    tc = kernel_route(q.dtype, q.shape[-1]) == "wgmma"
    bh, t, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if tc:
        outs = (dq, dk, dv, torch.empty(q.shape, dtype=torch.float32, device=q.device),
                torch.zeros(bh * -(-t // 64) + 1, dtype=torch.int32, device=q.device))
    else:
        outs = (dq, dk, dv, torch.empty((-(-t // 64), bh, t, d), dtype=torch.float32, device=q.device))
    _route_call(flash_bwd_fused, tc, q, k, v, do, lse, delta, outs, h, g, window, segments)
    return dq, dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, h, g, *, window=0, segments=None):
    """The dQ kernel (``_bwd_dq_kernel``): bf16 on the tensor cores, fp32 on
    the CUDA cores (``kernel_route``). ``.launches`` counts launches,
    ``.launches_tc`` and ``.launches_fp32`` those of each route."""
    dq = torch.empty_like(q)
    _route_call(flash_bwd_dq, kernel_route(q.dtype, q.shape[-1]) == "wgmma", q, k, v, do, lse, delta, (dq,), h,
                g, window, segments)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, h, g, *, window=0, segments=None):
    """The dK/dV kernel (``_bwd_dkv_kernel``): bf16 on the tensor cores,
    fp32 on the CUDA cores (``kernel_route``). ``.launches`` counts
    launches, ``.launches_tc`` and ``.launches_fp32`` those of each route."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _route_call(flash_bwd_dkv, kernel_route(q.dtype, q.shape[-1]) == "wgmma", q, k, v, do, lse, delta, (dk, dv),
                h, g, window, segments)
    return dk, dv


for _fn in (flash_bwd_fused, flash_bwd_dq, flash_bwd_dkv):
    _fn.launches = _fn.launches_tc = _fn.launches_fp32 = 0
del _fn


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, h: int, g: int, *, window: int = 0,
    block_q: int = 0, block_kv: int = 0, segments: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels for CUDA tensors, the plain version for CPU
    tensors.

    q, o, do: (B*H, T, Dh); k, v: (B*G, T, Dh); lse: (B*H, T) fp32 from the
    forward. ``block_q``/``block_kv`` (0 = auto) choose the algorithm as
    ``_bwd`` does: one block each runs the one-pass kernel
    (``flash_bwd_fused``), otherwise the dQ kernel and the dK/dV kernel
    (``flash_bwd_dq``, ``flash_bwd_dkv``). The kernels tile T themselves
    (64 x 64 tiles), whatever the blocks. ``segments`` as in the forward.
    Returns (dq, dk, dv)."""
    _check_folds(q, k, v, h, g)
    bh, t, d = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (bh, t):
        raise ValueError(
            f"flash_attention_bwd: o {tuple(o.shape)}, do {tuple(do.shape)}, lse "
            f"{tuple(lse.shape)} do not match q {tuple(q.shape)}"
        )
    _seg_ptr(segments, q, bh // h, t)  # the segments contract, checked on either device
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, h, g, window=window, segments=segments)
    _check_cuda("flash_attention_bwd", (q, k, v, o, lse, do), (q, k, v, o, do))
    if lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: lse must be float32, got {lse.dtype}")
    delta = (do.float() * o.float()).sum(-1)  # D = rowsum(dO * O), fp32 (XLA in JAX)
    if backward_is_one_pass(t, block_q, block_kv):
        return flash_bwd_fused(q, k, v, do, lse, delta, h, g, window=window, segments=segments)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, h, g, window=window, segments=segments)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, h, g, window=window, segments=segments)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention over the heads-first folds, the
    counterpart of the ``_flash`` custom VJP: the forward runs K1 (or its
    plain version on the CPU) and saves (q, k, v, o, lse); the backward runs
    ``flash_attention_bwd``. ``apply(q, k, v, h, g, window, block_q,
    block_kv, segments)``; the integer arguments and the (B, T) int32
    document ids ``segments`` (or None) get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, h, g, window, block_q, block_kv, segments=None):
        # Inside a checkpointed layer's recompute, a named remat policy may
        # hand back the first run's (o, lse): K1 runs only for what it
        # did not keep (``ops/remat.py``).
        o, lse = remat.kept_attention()
        if lse is None:
            with remat.unrecorded():
                o_run, lse = flash_attention_fwd(q, k, v, h, g, window=window, segments=segments)
            o = o_run if o is None else o
        remat.keep_attention(o, lse)
        ctx.save_for_backward(q, k, v, o, lse, segments)
        ctx.meta = (h, g, window, block_q, block_kv)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segments = ctx.saved_tensors
        h, g, window, block_q, block_kv = ctx.meta
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), h, g, window=window,
            block_q=block_q, block_kv=block_kv, segments=segments,
        )
        return dq, dk, dv, None, None, None, None, None, None
