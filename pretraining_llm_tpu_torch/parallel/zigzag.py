"""Zigzag sequence layout for balanced causal context parallelism.

Counterpart of ``pretraining_llm_tpu/parallel/zigzag.py``. Contiguous
sequence sharding under causal masking is imbalanced: seq rank 0's tokens
attend only to themselves (one ring hop of work) while rank n-1 attends to
everything (n hops). The zigzag layout splits the global sequence into 2n
equal chunks and gives rank i the pair (i, 2n-1-i), one early chunk and one
late chunk, so every rank does the same causal work on every hop (see
``parallel.ring_attention``).

The permutation is applied to the token stream once, before the model:
``x_zz = x[:, perm]``. Targets permute with the same index map, position ids
become ``perm`` itself (RoPE and learned embeddings then see true global
positions), and the mean CE loss is permutation invariant: nothing needs
un-permuting during training (``models.transformer.loss_fn``).

Pure numpy on static shapes.
"""

from __future__ import annotations

import numpy as np


def zigzag_perm(seq_len: int, n_shards: int) -> np.ndarray:
    """perm[p] = original position of the token at zigzag-layout index p.

    Layout index space: rank i owns [i*L, (i+1)*L) with L = seq_len//n,
    holding original chunks i then 2n-1-i, each of size L//2.
    """
    if seq_len % (2 * n_shards) != 0:
        raise ValueError(
            f"seq_len={seq_len} must divide by 2*n_shards={2 * n_shards} for zigzag"
        )
    c = seq_len // (2 * n_shards)
    chunks = np.arange(seq_len).reshape(2 * n_shards, c)
    order = []
    for i in range(n_shards):
        order += [i, 2 * n_shards - 1 - i]
    return chunks[order].reshape(-1)


def inverse_perm(perm: np.ndarray) -> np.ndarray:
    """inv[orig] = zigzag index holding original position ``orig``."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv
