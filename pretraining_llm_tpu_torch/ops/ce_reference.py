"""Plain PyTorch versions of the three fused cross-entropy kernels.

Counterpart of the kernel bodies in ``pretraining_llm_tpu/ops/pallas_ce.py``
(``_fwd_kernel``, ``_bwd_dh_kernel``, ``_bwd_dw_kernel``), with the same
rounding points:
  - each logits tile is the product of compute-dtype operands with fp32
    accumulation (``_logits_tile``), the padded vocabulary tail masked with
    the finite ``NEG_INF``;
  - the forward folds the tiles into a running max, sum and label logit
    (online softmax over the vocabulary, tile by tile in the Pallas order);
  - ``p~ = g * (exp(logits - lse) - onehot)`` is formed in fp32 and cast to
    W's dtype (dH) or h's dtype (dW) before its product; W's padded tail
    columns are zeroed in the dH product;
  - dH is cast to h's dtype, dW is sliced to V and cast to W's dtype.

h is (S, D), w is (D, V) as in the JAX package, labels (S,) in [0, V), g
the (S,) fp32 cotangent of the per-token losses. The tokens are taken all at
once (a tile of S rows); the vocabulary is walked in the JAX default
tiles (``_tiles``). These run for CPU tensors (the tests, CPU training) and as
the reference the CUDA kernels (``ops/cuda_ce.py``) are held against on the
card.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

NEG_INF = -1e30


def _pick_block(t: int, requested: int, default: int) -> int:
    """``pretraining_llm_tpu/ops/flash_attention.py::_pick_block``, copied:
    the requested (or default) block, halved until it divides ``t``."""
    block = requested if requested > 0 else default
    block = min(block, t)
    while t % block != 0:
        block //= 2
        if block == 0:
            return t
    return max(block, 1)


def _tiles(s: int, v: int, block_s: int, block_v: int) -> Tuple[int, int, int, int, int]:
    """``pallas_ce._tiles``, copied: (bs, bv, v_pad, ns, nv) with V padded to
    a multiple of 128."""
    bs = _pick_block(s, block_s, 256)
    v_pad = -(-v // 128) * 128
    bv = _pick_block(v_pad, block_v, 1024)
    return bs, bv, v_pad, s // bs, v_pad // bv


def _vocab_tiles(h: torch.Tensor, w: torch.Tensor) -> Iterator[Tuple[int, int, torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Per vocabulary tile: (j0, n, logits (S, bv) fp32 with the tail
    masked, the tile's vocabulary ids (bv,), W's tile (D, bv) with the
    padded tail columns zeroed). ``n`` is the tile's count of real
    columns."""
    s, v = h.shape[0], w.shape[1]
    _, bv, _, _, nv = _tiles(s, v, 0, 0)
    h32 = h.float()
    for j in range(nv):
        j0 = j * bv
        n = min(bv, v - j0)
        cols = w[:, j0:j0 + n]
        if n < bv:
            cols = torch.cat([cols, cols.new_zeros((cols.shape[0], bv - n))], dim=1)
        v_pos = j0 + torch.arange(bv, device=h.device)
        logits = h32 @ cols.float()
        yield j0, n, torch.where(v_pos[None, :] < v, logits, torch.full_like(logits, NEG_INF)), v_pos, cols


def fused_ce_fwd_reference(
    h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (loss (S,) fp32, lse (S,) fp32),
    loss = lse - the label's logit."""
    s = h.shape[0]
    lab = labels.long()[:, None]
    m = torch.full((s,), NEG_INF, dtype=torch.float32, device=h.device)
    l = torch.zeros((s,), dtype=torch.float32, device=h.device)
    gold = torch.zeros((s,), dtype=torch.float32, device=h.device)
    for _, _, logits, v_pos, _ in _vocab_tiles(h, w):
        m_new = torch.maximum(m, logits.amax(dim=1))
        l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
        m = m_new
        gold = gold + (logits * (v_pos[None, :] == lab).float()).sum(dim=1)
    lse = m + torch.log(l)
    return lse - gold, lse


def _scaled_p(logits, v_pos, labels, lse, g) -> torch.Tensor:
    """p~ = g * (softmax - onehot) for one tile, fp32 (S, bv)."""
    p = torch.exp(logits - lse[:, None]) - (v_pos[None, :] == labels.long()[:, None]).float()
    return p * g.float()[:, None]


def fused_ce_dh_reference(
    h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the dH kernel: sum over the vocabulary tiles of
    p~ (in W's dtype) times W's tile transposed, fp32, cast to h's dtype."""
    acc = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for _, _, logits, v_pos, cols in _vocab_tiles(h, w):
        p = _scaled_p(logits, v_pos, labels, lse, g).to(w.dtype)
        acc = acc + p.float() @ cols.float().T
    return acc.to(h.dtype)


def fused_ce_dw_reference(
    h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the dW kernel: per vocabulary tile, h transposed
    times p~ (in h's dtype), fp32, sliced to V and cast to W's dtype.
    Returns (D, V) like ``w``."""
    dw = torch.empty(w.shape, dtype=torch.float32, device=h.device)
    h32 = h.float()
    for j0, n, logits, v_pos, _ in _vocab_tiles(h, w):
        p = _scaled_p(logits, v_pos, labels, lse, g).to(h.dtype)
        dw[:, j0:j0 + n] = (h32.T @ p.float())[:, :n]
    return dw.to(w.dtype)
