"""KV page digests, the weight fingerprint and the integrity error, the
serving engine's part of ``pretraining_llm_tpu/resilience/integrity.py``.

``kv_block_digest`` is blake2b over one pool block's bytes in every pool
leaf: K, V and, for int8 pools, their scale pages. The serving engine
records it when the prefix cache publishes a block and checks it when a
later admission acquires the block (``kv_checksum``), so a corrupted shared
page is dropped and re-prefilled privately instead of feeding every later
hit. The digest of the same pool contents is byte for byte the JAX
package's: leaves in the JAX tree order (layer by layer, each layer's
names sorted), each leaf's dtype name as numpy spells it, then the page's
bytes in row-major order.

``weight_fingerprint`` is one position-weighted fp32 sum over every float
and integer leaf of a parameter tree, read back once: the online engine
loop pins it at start and refreshes it between scheduler turns
(``weight_fingerprint_interval_s``). The golden probes wait for the fleet.
"""

from __future__ import annotations

import hashlib
from typing import Any, Iterator

import torch

# numpy's names for the pool dtypes (numpy has no bfloat16; ml_dtypes, which
# JAX uses, spells it "bfloat16").
_DTYPE_NAMES = {
    torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16",
    torch.int8: "int8",
}
# A bf16 page's bytes are read as the same-width integer (no numpy dtype).
_BYTE_VIEWS = {torch.bfloat16: torch.int16}


class IntegrityError(RuntimeError):
    """Served state failed an integrity check: an out-of-vocabulary token
    id reached the output (corrupted weights, pages or kernel)."""


def _leaves(pools: Any) -> Iterator[torch.Tensor]:
    """The pool tensors in ``jax.tree_util.tree_leaves`` order: dicts by
    sorted key, lists and tuples in order."""
    if isinstance(pools, dict):
        for key in sorted(pools):
            yield from _leaves(pools[key])
    elif isinstance(pools, (list, tuple)):
        for item in pools:
            yield from _leaves(item)
    else:
        yield pools


def kv_block_digest(pools: Any, block: int) -> str:
    """Content digest of one pool block across every pool leaf. It copies
    the page of each leaf to the host (and so waits for the device), so the
    engine takes it only at publish and acquire, never in a decode window."""
    h = hashlib.blake2b(digest_size=16)
    for leaf in _leaves(pools):
        # Stacked (L, n_blocks, ...) leaves index blocks on axis 1, the
        # per-layer (n_blocks, ...) ones on axis 0.
        page = leaf[:, block] if leaf.ndim >= 5 else leaf[block]
        page = page.detach().contiguous()
        view = _BYTE_VIEWS.get(page.dtype)
        raw = (page.view(view) if view is not None else page).cpu().numpy()
        h.update(_DTYPE_NAMES[page.dtype].encode())
        h.update(raw.tobytes())
    return h.hexdigest()


def weight_fingerprint(params: Any) -> float:
    """Position-weighted sum of every floating and integer leaf (the int8
    codes of a quantized tree included), leaves in the JAX flatten order:
    sum over i of (i + 1) * sum(leaf_i in fp32), accumulated in fp32 on the
    leaves' device with ONE host read. Both value corruption and swapped
    leaves move it; it equals the JAX package's fingerprint of the same tree
    within fp32 rounding (the two sum in different orders). Cheap enough for
    an interval loop, never on the per-token path."""
    leaves = [
        leaf for leaf in _leaves(params)
        if isinstance(leaf, torch.Tensor) and leaf.dtype != torch.bool and not leaf.dtype.is_complex
    ]
    acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device if leaves else "cpu")
    for i, leaf in enumerate(leaves):
        acc = acc + float(i + 1) * leaf.detach().float().sum()
    return float(acc.item())
