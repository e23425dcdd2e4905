"""Flash-attention dispatch, and blockwise attention in torch ops.

Counterpart of ``pretraining_llm_tpu/ops/flash_attention.py``:

  - ``flash_attention`` (``flash_attention`` there, without the TPU mesh
    branches): q (B, T, H, Dh) and k/v (B, T, G, Dh) are folded
    heads-first and handed to ``cuda_flash.FlashAttention``, whose forward
    launches the CUDA forward kernel and whose backward launches the CUDA
    backward kernels for CUDA tensors, and which runs the plain versions
    for CPU tensors. Nothing falls back from one to the other.
  - ``blockwise_attention`` (``_pick_block``, ``blockwise_attention``
    there): the online softmax over KV blocks that the chunked prefill
    runs against a dense cache. The JAX package computes it in plain XLA,
    outside any Pallas kernel, so the port computes it in torch ops.
"""

from __future__ import annotations

from typing import Optional

import torch

from pretraining_llm_tpu_torch.ops.cuda_flash import FlashAttention


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int = 0,
    block_q: int = 0, block_kv: int = 0, segments: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal attention, (B, T, H, Dh) x (B, T, G, Dh) -> (B, T, H, Dh), G | H.
    ``block_q``/``block_kv`` (0 = auto) choose the backward's algorithm as
    the JAX package's blocks do (``cuda_flash.backward_is_one_pass``).
    ``segments`` (B, T) int document ids: a query attends only keys of its
    own document."""
    b, t, h, d = q.shape
    g = k.shape[2]
    if h % g:
        raise ValueError(f"kv heads ({g}) must divide query heads ({h})")

    def heads_first(x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 1, 3).reshape(b * x.shape[2], t, d).contiguous()

    seg = None if segments is None else segments.to(torch.int32).contiguous()
    o = FlashAttention.apply(
        heads_first(q), heads_first(k), heads_first(v), h, g, int(window),
        int(block_q), int(block_kv), seg,
    )
    return o.reshape(b, h, t, d).permute(0, 2, 1, 3)


def _pick_block(t: int, requested: int, default: int) -> int:
    """The JAX package's block rule: the requested (else default) size, cut
    to T, halved until it divides T."""
    block = min(requested if requested > 0 else default, t)
    while t % block:
        block //= 2
        if block == 0:
            return t
    return max(block, 1)


def blockwise_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    block_q: int = 0, block_kv: int = 0, q_offset: int = 0, k_offset: int = 0, window: int = 0,
) -> torch.Tensor:
    """Online-softmax attention, q (B, Tq, H, Dh) x k/v (B, Tk, G, Dh), G | H
    -> (B, Tq, H, Dh); Tq and Tk may differ. GQA-native: each group of H/G
    query heads attends its KV head, K/V are never repeated. Queries sit at
    positions [q_offset, q_offset + Tq), keys at [k_offset, k_offset + Tk)
    for the causal and window masks. Scores, the running (max, sum) and the
    output accumulate in fp32; P is rounded to V's dtype before P·V, as in
    the JAX package."""
    b, tq, h, dh = q.shape
    tk, g = k.shape[1], k.shape[2]
    if h % g:
        raise ValueError(f"kv heads ({g}) must divide query heads ({h})")
    r = h // g
    bq = _pick_block(tq, block_q, 512)
    bk = _pick_block(tk, block_kv, 512)
    scale = 1.0 / (dh**0.5)
    q_ids = torch.arange(bq, device=q.device)
    k_ids = torch.arange(bk, device=q.device)
    outs = []
    for qi in range(tq // bq):
        q_blk = q[:, qi * bq:(qi + 1) * bq].reshape(b, bq, g, r, dh).float()
        o = torch.zeros((b, bq, g, r, dh), dtype=torch.float32, device=q.device)
        m = torch.full((b, g, r, bq), float("-inf"), dtype=torch.float32, device=q.device)
        l_sum = torch.zeros((b, g, r, bq), dtype=torch.float32, device=q.device)
        q_pos = q_offset + qi * bq + q_ids
        for kj in range(tk // bk):
            k_blk = k[:, kj * bk:(kj + 1) * bk]
            v_blk = v[:, kj * bk:(kj + 1) * bk]
            s = torch.einsum("bqgrd,bkgd->bgrqk", q_blk, k_blk.float()) * scale
            k_pos = k_offset + kj * bk + k_ids
            if causal:
                s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), float("-inf"))
            if window:
                s = s.masked_fill(~((q_pos[:, None] - k_pos[None, :]) < window), float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            # Rows of a fully masked block keep m = -inf: zero their p and alpha.
            p = torch.exp(s - m_new[..., None])
            p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
            alpha = torch.exp(m - m_new)
            alpha = torch.where(torch.isfinite(m) | torch.isfinite(m_new), alpha, torch.zeros_like(alpha))
            l_sum = l_sum * alpha + p.sum(dim=-1)
            pv = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v_blk.dtype).float(), v_blk.float())
            o = o * alpha.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        outs.append(o / l_sum.permute(0, 3, 1, 2)[..., None])
    return torch.cat(outs, dim=1).reshape(b, tq, h, dh).to(q.dtype)
