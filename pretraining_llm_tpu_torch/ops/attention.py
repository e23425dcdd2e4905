"""Plain masked attention — the ``attention_impl="naive"`` lane and the
paged gather lane.

Counterpart of ``pretraining_llm_tpu/ops/attention.py::naive_attention``:
scores and softmax in fp32, GQA native (each group of H/G query heads
attends its shared KV head; K/V are never repeated), causal masking by
position arithmetic, an optional sliding window, a ``kv_mask`` of
(B, Tk) or per query (B, Tq, Tk), and document ``segments``. Rows whose
every key is masked by ``kv_mask`` give zeros, not NaN.

``multihead_attention`` is the JAX module's dispatch for the
sequence-parallel ring and Ulysses paths of ``parallel/``.
"""

from __future__ import annotations

from typing import Optional

import torch


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: int = 0,
    segments: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q: (B, Tq, H, Dh); k, v: (B, Tk, G, Dh) with G | H -> (B, Tq, H, Dh).

    ``segments`` (B, T) int document ids (self-attention, Tq == Tk): a query
    attends only keys of its own document (packed-sequence training)."""
    b, tq, h, dh = q.shape
    tk, g = k.shape[1], k.shape[2]
    if h % g:
        raise ValueError(f"kv heads ({g}) must divide query heads ({h})")
    scale = 1.0 / (dh**0.5)
    qg = q.reshape(b, tq, g, h // g, dh)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * scale
    causal_mask = None
    if causal or window:
        if q_positions is None:
            q_positions = torch.arange(tq, device=q.device) + (tk - tq)
        if kv_positions is None:
            kv_positions = torch.arange(tk, device=q.device)
    if causal:
        causal_mask = q_positions[:, None] >= kv_positions[None, :]  # (Tq, Tk)
        scores = scores.masked_fill(~causal_mask, float("-inf"))
    if window:
        w_ok = (q_positions[:, None] - kv_positions[None, :]) < window
        scores = scores.masked_fill(~w_ok, float("-inf"))
    kv_mask_q = None
    if kv_mask is not None:
        kv_mask_q = kv_mask if kv_mask.ndim == 3 else kv_mask[:, None, :]
        scores = scores.masked_fill(~kv_mask_q[:, None, None], float("-inf"))
    if segments is not None:
        if tq != tk:
            raise ValueError("segments requires self-attention (Tq == Tk)")
        seg_ok = segments[:, :, None] == segments[:, None, :]  # (B, Tq, Tk)
        scores = scores.masked_fill(~seg_ok[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if kv_mask_q is not None:
        # A query whose every key is masked softmaxes to NaN (0/0): zero
        # exactly those rows, derived from the masks so genuine NaNs from
        # corrupt inputs still propagate.
        valid = kv_mask_q.expand(b, tq, tk)
        if causal_mask is not None:
            valid = valid & causal_mask[None]
        dead = ~valid.any(dim=-1)  # (B, Tq)
        probs = probs.masked_fill(dead[:, None, None, :, None], 0.0)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, tq, h, dh).to(q.dtype)


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    impl: str,
    causal: bool = True,
    block_q: int = 0,
    block_kv: int = 0,
    ring_layout: str = "contiguous",
    segments: Optional[torch.Tensor] = None,
    window: int = 0,
) -> torch.Tensor:
    """The sequence-parallel branch of the JAX package's
    ``multihead_attention``: ``impl`` 'ring' or 'ulysses'.

    They go to ``parallel.ring_attention`` and ``parallel.ulysses`` over
    the active mesh's 'seq' ranks (``parallel.sharding.current_mesh()``),
    q/k/v being the rank's sequence shards. Without a seq axis above 1
    they take the naive path, the correct single-shard form.
    ``ring_layout="zigzag"`` asserts the caller already permuted the
    sequence (``models.transformer.loss_fn`` does). The model's other
    implementations and its cached decode dispatch in
    ``models.transformer._attention_block``."""
    if impl not in ("ring", "ulysses"):
        raise ValueError(f"impl must be 'ring' or 'ulysses', got {impl!r}")
    if window:
        raise ValueError(
            "sliding-window attention is not supported by the "
            "ring/ulysses sequence-parallel attention paths"
        )
    if segments is not None:
        # Config validation forbids doc_mask with these impls; this is
        # the backstop.
        raise ValueError(
            "segments (document masking) is not supported by the "
            "ring/ulysses sequence-parallel attention paths"
        )
    from pretraining_llm_tpu_torch.parallel.mesh import axis_size
    from pretraining_llm_tpu_torch.parallel.sharding import current_mesh

    mesh = current_mesh()
    if mesh is None or axis_size(mesh, "seq") == 1:
        return naive_attention(q, k, v, causal=causal)
    if impl == "ring":
        from pretraining_llm_tpu_torch.parallel.ring_attention import ring_attention

        return ring_attention(q, k, v, mesh, causal=causal, layout=ring_layout, block_kv=block_kv or 512)
    from pretraining_llm_tpu_torch.parallel.ulysses import ulysses_attention

    return ulysses_attention(q, k, v, mesh, causal=causal, block_q=block_q, block_kv=block_kv)
