"""Golden probes, KV page digests, the weight fingerprint and the integrity
error, the serving part of ``pretraining_llm_tpu/resilience/integrity.py``.

``build_probe_set`` pins seeded probe prompts and their greedy
continuations from the reference ``generate`` path; the fleet router
re-runs them per replica through the normal admission lane, and any token
mismatch is proof of divergence, whatever its cause.

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
(``weight_fingerprint_interval_s``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Iterator, List, Tuple

import numpy as np
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


@dataclasses.dataclass(frozen=True)
class GoldenProbe:
    """One pinned probe: a prompt and its reference greedy continuation.
    ``alternates`` holds other continuations a healthy replica gives
    through another prefill lane (the router pins a prefix-cache miss and
    a hit, whose bf16 roundings differ on the port's kernels); a probe
    passes on any of them."""

    prompt: Tuple[int, ...]
    expected: Tuple[int, ...]
    alternates: Tuple[Tuple[int, ...], ...] = ()


def probe_prompts(
    n_probes: int, probe_len: int, vocab_size: int, seed: int = 20260805
) -> List[List[int]]:
    """Deterministic probe prompts, the JAX package's draws. Every probe
    shares the first ``probe_len - 1`` tokens and differs in its LAST
    token only: with the prefix cache on, probe #0 publishes the shared
    prefix blocks and every later probe re-acquires them, so the probes
    keep exercising the cached-KV read path and a corrupted shared page
    shows up as probe divergence, not just as a checksum event."""
    if n_probes < 1:
        raise ValueError(f"n_probes must be >= 1, got {n_probes}")
    if probe_len < 2:
        raise ValueError(f"probe_len must be >= 2, got {probe_len}")
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab_size, size=probe_len - 1).tolist()
    return [
        prefix + [int(rng.randint(0, vocab_size))] for _ in range(n_probes)
    ]


def build_probe_set(
    params: Any,
    cfg: Any,
    *,
    n_probes: int = 2,
    probe_len: int = 9,
    max_new: int = 4,
    seed: int = 20260805,
) -> List[GoldenProbe]:
    """Pin the probe set: greedy continuations from the reference
    ``generate`` path (batch-1 fixed-count decode, deliberately NOT the
    serving engine, so the pin is independent of the machinery it later
    judges), on the params' device. Call once at startup, before
    traffic."""
    from pretraining_llm_tpu_torch.generation.generate import generate

    device = params["tok_embed"]["embedding"].device
    probes = []
    for prompt in probe_prompts(n_probes, probe_len, cfg.vocab_size, seed):
        toks = generate(
            params, cfg, torch.tensor([prompt], dtype=torch.int32, device=device),
            max_new, 7, temperature=0.0,
        )
        probes.append(GoldenProbe(tuple(prompt), tuple(int(t) for t in toks[0].tolist())))
    return probes


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
