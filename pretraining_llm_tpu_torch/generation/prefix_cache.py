"""Cross-request prefix cache: content-addressed, copy-on-write paged-KV reuse.

Counterpart of ``pretraining_llm_tpu/generation/prefix_cache.py`` (host
bookkeeping only; numpy and hashlib):

  identity    every FULL block of a finished request's committed history
              gets a chained content hash (blake2b over the block's token
              ids + the parent block's digest), so block j's identity
              encodes its entire prefix;
  reuse       admission walks the new prompt's block chain through the
              index and maps the longest cached run READ-ONLY into the
              row's block table; only the uncached suffix is prefilled
              (``ServingEngine._admit`` / ``paged.prefill_suffix_into_pool_batched``);
  copy-on-write
              the hit is capped so at least the prompt's final token is
              prefilled privately: the block holding the first decode
              write is always a fresh private block;
  lifecycle   shared blocks carry a live-row refcount; at release the
              row's refs drop and its own full committed blocks are
              PUBLISHED into the index. Refcount-0 blocks stay resident in
              an LRU ("cold") list, still owned in the allocator's live
              set, and go back to the free list only under pool pressure,
              before any live request is preempted.

  integrity   with ``kv_checksum`` the engine records a digest of each
              published block's pool bytes (``set_checksum``) and verifies
              it at acquire; a block that fails is dropped
              (``drop_block``) and never hit again.

Greedy outputs with the cache on are identical to cache off. The JAX
module's typed metrics are not ported.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pretraining_llm_tpu_torch.generation.paged import BlockAllocator

# Engine-stats keys this cache maintains.
STAT_KEYS = (
    "prefix_cache_hits",
    "prefix_cache_misses",
    "prefix_cache_hit_tokens",
    "prefix_cache_evicted_blocks",
)


class PrefixCache:
    """Content-addressed index + refcount layer over a ``BlockAllocator``.

    The cache never allocates blocks itself; it only (a) answers which
    resident blocks already hold a prompt's prefix, (b) tracks who
    references them, and (c) hands cold blocks back to the allocator on
    demand (``evict``). Cached blocks stay live in the allocator, so no
    allocation path can reuse a page the LRU has not released.
    """

    def __init__(
        self,
        alloc: BlockAllocator,
        block_size: int,
        *,
        min_blocks: int = 1,
        stats: Optional[Dict[str, Any]] = None,
    ) -> None:
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if min_blocks < 1:
            raise ValueError(f"min_blocks must be >= 1, got {min_blocks}")
        self.alloc = alloc
        self.block_size = int(block_size)
        self.min_blocks = int(min_blocks)
        self._index: Dict[bytes, int] = {}     # chain digest -> block id
        self._hash_of: Dict[int, bytes] = {}   # block id -> chain digest
        self._ref: Dict[int, int] = {}         # block id -> live-row refcount
        # Refcount-0 cached blocks, LRU order (oldest first).
        self._cold: "OrderedDict[int, bytes]" = OrderedDict()
        # Pool-content digests recorded at publish (``kv_checksum``).
        self._checksums: Dict[int, str] = {}
        # Blocks dropped for corruption while still shared: freed, not
        # cold-listed, at their last deref.
        self._doomed: set = set()
        # Tallies live in the caller's dict (the engine's ``stats``).
        self.stats: Dict[str, Any] = stats if stats is not None else {}
        for k in STAT_KEYS:
            self.stats.setdefault(k, 0)

    def note_hit(self, cached_tokens: int) -> None:
        """Count one committed hit admission."""
        self.stats["prefix_cache_hits"] += 1
        self.stats["prefix_cache_hit_tokens"] += int(cached_tokens)

    def note_miss(self) -> None:
        self.stats["prefix_cache_misses"] += 1

    # -- queries -----------------------------------------------------------

    @property
    def evictable(self) -> int:
        """Cold (refcount-0) cached blocks the pool can reclaim on demand."""
        return len(self._cold)

    @property
    def cached_blocks(self) -> int:
        """All indexed blocks: cold + shared by live rows."""
        return len(self._index)

    def peek(self, prompt: Sequence[int]) -> int:
        """Longest cached block-aligned prefix of ``prompt``, in tokens; no
        side effects."""
        return len(self._hit_blocks(prompt)) * self.block_size

    # -- admission-side lifecycle ------------------------------------------

    def acquire(self, prompt: Sequence[int]) -> Tuple[int, List[int]]:
        """Retain the longest cached block-aligned prefix of ``prompt``.
        Returns ``(cached_tokens, block_ids)``; each block's refcount is
        bumped (cold blocks leave the LRU). The caller maps the ids
        read-only into the row's table, or hands them back via
        ``release_shared`` if admission stalls."""
        ids = self._hit_blocks(prompt)
        for b in ids:
            n = self._ref.get(b, 0)
            if n == 0:
                self._cold.pop(b, None)
            self._ref[b] = n + 1
        return len(ids) * self.block_size, ids

    def release_shared(self, block_ids: Sequence[int]) -> None:
        """Drop one reference per block (a stalled admission's un-acquire).
        Refcount-0 blocks rejoin the cold LRU as most recent."""
        for b in block_ids:
            self._deref(b)

    def release_row(
        self,
        history: Sequence[int],
        blocks: Sequence[int],
        n_shared: int,
        publish_len: int,
    ) -> List[int]:
        """Release a finished or preempted row's blocks.

        ``history`` is the row's prompt + generated tokens; ``blocks`` its
        table entries in order (the first ``n_shared`` shared prefix
        blocks); ``publish_len`` the count of leading slots whose pool
        content is committed. Shared blocks are deref'd. Private blocks
        wholly below ``publish_len`` are published (a duplicate of an
        indexed chain goes back to the allocator: first writer wins, the
        content is identical). The partial tail block and any surplus are
        freed. Returns the newly published block ids."""
        for b in blocks[:n_shared]:
            self._deref(b)
        bs = self.block_size
        n_pub = min(max(publish_len, 0) // bs, len(blocks))
        to_free: List[int] = list(blocks[max(n_shared, n_pub):])
        published: List[int] = []
        digest = b""
        for j in range(n_pub):
            digest = self._chain(digest, history[j * bs:(j + 1) * bs])
            if j < n_shared:
                continue  # already indexed (matched on acquire)
            b = blocks[j]
            if digest in self._index:
                to_free.append(b)
            else:
                self._index[digest] = b
                self._hash_of[b] = digest
                self._cold[b] = digest  # ref 0, most recently used
                published.append(b)
        if to_free:
            self.alloc.free(to_free)
        return published

    # -- integrity (``kv_checksum``) ---------------------------------------

    def set_checksum(self, block: int, digest: str) -> None:
        """Record a published block's pool-content digest. Ignored for a
        block that already left the index."""
        if block in self._hash_of:
            self._checksums[block] = digest

    def checksum_of(self, block: int) -> Optional[str]:
        """The digest recorded at publish, or None (checksums were off when
        it was published, or the block is gone)."""
        return self._checksums.get(block)

    def cached_block_ids(self) -> List[int]:
        """Every indexed block id, sorted."""
        return sorted(self._hash_of)

    def drop_block(self, block: int) -> None:
        """Remove a block whose content failed verification, in any state:
        a cold block goes back to the allocator now; a block live rows still
        share becomes unreachable and is freed at its last deref.
        Idempotent."""
        digest = self._hash_of.pop(block, None)
        if digest is None:
            return
        self._index.pop(digest, None)
        self._checksums.pop(block, None)
        if block in self._cold:
            del self._cold[block]
            self.alloc.free([block])
        else:
            self._doomed.add(block)

    # -- pressure ----------------------------------------------------------

    def evict(self, n: int) -> int:
        """Return up to ``n`` cold blocks to the allocator, least recently
        used first. Returns how many were evicted (0: nothing cold, the
        caller escalates to preemption)."""
        freed: List[int] = []
        while len(freed) < n and self._cold:
            b, digest = self._cold.popitem(last=False)
            del self._index[digest]
            del self._hash_of[b]
            self._checksums.pop(b, None)
            freed.append(b)
        if freed:
            self.alloc.free(freed)
            self.stats["prefix_cache_evicted_blocks"] += len(freed)
        return len(freed)

    def flush(self) -> int:
        """Evict everything cold; live-shared blocks are untouched."""
        return self.evict(len(self._cold))

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _chain(parent: bytes, block_tokens: Sequence[int]) -> bytes:
        """Chained block digest: parent digest + this block's token ids, so
        a flat dict lookup is longest-prefix matching."""
        h = hashlib.blake2b(parent, digest_size=16)
        h.update(np.asarray(block_tokens, dtype=np.int64).tobytes())
        return h.digest()

    def _hit_blocks(self, prompt: Sequence[int]) -> List[int]:
        """Resident block ids covering the longest cached prefix, capped at
        (len(prompt) - 1) // block_size full blocks so at least one prompt
        token always prefills privately; hits shorter than ``min_blocks``
        don't count."""
        bs = self.block_size
        cap = (len(prompt) - 1) // bs
        ids: List[int] = []
        digest = b""
        for j in range(cap):
            digest = self._chain(digest, prompt[j * bs:(j + 1) * bs])
            b = self._index.get(digest)
            if b is None:
                break
            ids.append(b)
        if len(ids) < self.min_blocks:
            return []
        return ids

    def _deref(self, b: int) -> None:
        n = self._ref.get(b)
        if n is None:
            raise ValueError(f"release of unreferenced block {b}")
        if n == 1:
            del self._ref[b]
            if b in self._doomed:  # dropped while shared: leave the pool now
                self._doomed.discard(b)
                self.alloc.free([b])
            else:
                self._cold[b] = self._hash_of[b]  # most-recently-used end
        else:
            self._ref[b] = n - 1
