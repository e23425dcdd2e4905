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

Greedy outputs with the cache on are identical to cache off. ``peek`` is
called from the serving gateway's threads (the admission discount hint)
while the engine thread mutates the cache: one lock guards every public
method. ``bind`` attaches the typed counters of ``observability/metrics.py``.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pretraining_llm_tpu_torch.generation.paged import BlockAllocator

# Engine-stats keys this cache maintains (mirrored as typed counters when
# bind() attaches a MetricsRegistry).
STAT_KEYS = (
    "prefix_cache_hits",
    "prefix_cache_misses",
    "prefix_cache_hit_tokens",
    "prefix_cache_evicted_blocks",
)


class PrefixCache:
    """Content-addressed index + refcount layer over a ``BlockAllocator``.

    The cache never allocates blocks itself; it only (a) answers "which
    resident blocks already hold this prompt's prefix", (b) tracks who
    references them, and (c) hands cold blocks back to the allocator on
    demand (``evict``). Cached-but-unreferenced blocks remain ``_live``
    in the allocator — the free list never contains a cached block, so
    every existing allocation path stays oblivious and structurally
    unable to reuse a page the LRU has not released.
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
        self._lock = threading.Lock()
        self._index: Dict[bytes, int] = {}     # chain digest -> block id
        self._hash_of: Dict[int, bytes] = {}   # block id -> chain digest
        self._ref: Dict[int, int] = {}         # block id -> live-row refcount
        # Refcount-0 cached blocks, LRU order (oldest first — evict from
        # the front, re-publish/release at the back).
        self._cold: "OrderedDict[int, bytes]" = OrderedDict()
        # Optional content checksums (``kv_checksum``): block id -> digest
        # of the block's POOL BYTES at publish time (the engine computes
        # them; the cache only stores/serves them). Verified on acquire;
        # a mismatch drops the block via ``drop_block``.
        self._checksums: Dict[int, str] = {}
        # Blocks dropped for corruption while still referenced by live
        # rows: unreachable from the index already; the final deref frees
        # them to the allocator instead of re-coldlisting a known-bad page.
        self._doomed: set = set()
        # Tallies live in the caller's dict (the engine's ``stats``) so
        # serve.py/bench.py records and EngineLoop.metrics() see them for
        # free; typed counters attach via bind().
        self.stats: Dict[str, Any] = stats if stats is not None else {}
        for k in STAT_KEYS:
            self.stats.setdefault(k, 0)
        self._c_hits = self._c_misses = None
        self._c_hit_tokens = self._c_evicted = None
        self._g_cached = None

    # -- observability -----------------------------------------------------

    def bind(self, registry: Any) -> None:
        """Attach typed metrics (observability.metrics.MetricsRegistry):
        hit/miss/hit-token/eviction counters + a cached-blocks gauge.
        Counters advance alongside the untyped ``stats`` tallies."""
        self._c_hits = registry.counter(
            "prefix_cache_hits_total", "admissions that reused cached prefix blocks")
        self._c_misses = registry.counter(
            "prefix_cache_misses_total", "admissions with no cached prefix")
        self._c_hit_tokens = registry.counter(
            "prefix_cache_hit_tokens_total",
            "prompt tokens served from cache instead of prefill")
        self._c_evicted = registry.counter(
            "prefix_cache_evicted_blocks_total",
            "cold cached blocks returned to the pool under pressure")
        self._g_cached = registry.gauge(
            "prefix_cache_cached_blocks", "pool blocks resident in the prefix cache")
        self._sync_gauge()

    def _sync_gauge(self) -> None:
        if self._g_cached is not None:
            self._g_cached.set(len(self._index))

    def note_hit(self, cached_tokens: int) -> None:
        """Count one COMMITTED hit admission (the engine calls this only
        after the watermark passed and the row is claimed, so a stalled
        head retried every boundary does not inflate the hit rate)."""
        self.stats["prefix_cache_hits"] += 1
        self.stats["prefix_cache_hit_tokens"] += int(cached_tokens)
        if self._c_hits is not None:
            self._c_hits.inc()
            self._c_hit_tokens.inc(int(cached_tokens))

    def note_miss(self) -> None:
        self.stats["prefix_cache_misses"] += 1
        if self._c_misses is not None:
            self._c_misses.inc()

    # -- queries -----------------------------------------------------------

    @property
    def evictable(self) -> int:
        """Cold (refcount-0) cached blocks the pool can reclaim on demand."""
        with self._lock:
            return len(self._cold)

    @property
    def cached_blocks(self) -> int:
        """All indexed blocks: cold + shared by live rows."""
        with self._lock:
            return len(self._index)

    def peek(self, prompt: Sequence[int]) -> int:
        """Longest cached block-aligned prefix of ``prompt``, in TOKENS —
        no side effects, no refcounts. The frontend's admission-discount
        hint; safe from any thread."""
        with self._lock:
            return len(self._hit_blocks(prompt)) * self.block_size

    def debug_snapshot(self) -> Dict[str, int]:
        """Block accounting for /debug/engine: all indexed blocks, the
        cold (evictable) subset, and the live-shared remainder — one lock
        acquisition so the three numbers are mutually consistent."""
        with self._lock:
            cached = len(self._index)
            cold = len(self._cold)
        return {"cached": cached, "cold": cold, "shared": cached - cold}

    # -- admission-side lifecycle ------------------------------------------

    def acquire(self, prompt: Sequence[int]) -> Tuple[int, List[int]]:
        """Retain the longest cached block-aligned prefix of ``prompt``.
        Returns ``(cached_tokens, block_ids)``; each returned block's
        refcount is bumped (cold blocks leave the LRU). The caller maps
        the ids read-only into the row's table — or hands them back via
        ``release_shared`` if admission stalls after all."""
        with self._lock:
            ids = self._hit_blocks(prompt)
            for b in ids:
                n = self._ref.get(b, 0)
                if n == 0:
                    self._cold.pop(b, None)
                self._ref[b] = n + 1
            return len(ids) * self.block_size, ids

    def release_shared(self, block_ids: Sequence[int]) -> None:
        """Drop one reference per block (the un-acquire path for a stalled
        admission). Refcount-0 blocks rejoin the cold LRU as most recent."""
        with self._lock:
            for b in block_ids:
                self._deref(b)

    def release_row(
        self,
        history: Sequence[int],
        blocks: Sequence[int],
        n_shared: int,
        publish_len: int,
    ) -> List[int]:
        """Release a finished/preempted/cancelled row's blocks.

        ``history`` is the row's prompt + generated tokens; ``blocks`` its
        table entries in order (the first ``n_shared`` are shared prefix
        blocks); ``publish_len`` the count of LEADING slots whose pool
        content is committed (the engine passes p + g - 1: the last
        sampled token's K/V may never have been written, and surplus
        in-flight windows only write at or above that frontier).

        Shared blocks are deref'd. Private blocks wholly below
        ``publish_len`` are published into the index (duplicates of an
        already-indexed chain go back to the allocator instead — first
        writer wins, content is identical by construction). Everything
        else — the partial tail block and speculative over-grants — is
        freed. Returns the NEWLY published block ids, so a checksumming
        engine knows exactly which pages to digest."""
        with self._lock:
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
                    continue  # already indexed (we matched it on acquire)
                b = blocks[j]
                if digest in self._index:
                    to_free.append(b)
                else:
                    self._index[digest] = b
                    self._hash_of[b] = digest
                    self._cold[b] = digest  # ref 0, most-recently-used
                    published.append(b)
            if to_free:
                self.alloc.free(to_free)
            self._sync_gauge()
            return published

    # -- integrity (resilience/integrity.py; ``kv_checksum``) --------------

    def set_checksum(self, block: int, digest: str) -> None:
        """Record a published block's pool-content digest (engine-computed
        at publish; see ServingEngine._release_row). Ignored for blocks
        that already left the index — publish and eviction can race only
        in the sense that eviction wins."""
        with self._lock:
            if block in self._hash_of:
                self._checksums[block] = digest

    def checksum_of(self, block: int) -> Optional[str]:
        """The digest recorded at publish, or None (checksumming off when
        it was published, or the block is gone)."""
        with self._lock:
            return self._checksums.get(block)

    def cached_block_ids(self) -> List[int]:
        """All indexed block ids, sorted (deterministic corruption-drill
        targeting + integrity sweeps)."""
        with self._lock:
            return sorted(self._hash_of)

    def drop_block(self, block: int) -> None:
        """Remove one block from the cache because its CONTENT failed
        verification. Unlike ``evict`` this takes a block in any state:
        a cold block is freed to the allocator immediately; a block still
        referenced by live rows just becomes unreachable (no future hit
        can map it) and is freed — not re-coldlisted — on its final
        deref. Idempotent for already-dropped blocks."""
        with self._lock:
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
            self._sync_gauge()

    # -- pressure ----------------------------------------------------------

    def evict(self, n: int) -> int:
        """Return up to ``n`` cold blocks to the allocator, least recently
        used first. Returns how many were evicted (0 = nothing cold:
        the caller escalates to preemption)."""
        freed: List[int] = []
        with self._lock:
            while len(freed) < n and self._cold:
                b, digest = self._cold.popitem(last=False)
                del self._index[digest]
                del self._hash_of[b]
                self._checksums.pop(b, None)
                freed.append(b)
            if freed:
                self.alloc.free(freed)
                self.stats["prefix_cache_evicted_blocks"] += len(freed)
                self._sync_gauge()
        if freed and self._c_evicted is not None:
            self._c_evicted.inc(len(freed))
        return len(freed)

    def flush(self) -> int:
        """Evict EVERYTHING cold (tests / drain checks). Live-shared
        blocks are untouched; returns the number evicted."""
        return self.evict(len(self._cold))

    # -- internals (call under self._lock) ---------------------------------

    @staticmethod
    def _chain(parent: bytes, block_tokens: Sequence[int]) -> bytes:
        """Chained block digest: parent digest + this block's token ids.
        Position falls out of the chain — block j's digest commits to the
        whole prefix, so a flat dict lookup IS longest-prefix matching."""
        h = hashlib.blake2b(parent, digest_size=16)
        h.update(np.asarray(block_tokens, dtype=np.int64).tobytes())
        return h.digest()

    def _hit_blocks(self, prompt: Sequence[int]) -> List[int]:
        """Resident block ids covering the longest cached prefix. Capped
        at (len(prompt) - 1) // block_size FULL blocks so at least one
        prompt token always prefills privately (the first-token logits
        must come from a real forward, and the block containing the first
        decode write stays copy-on-write private); hits shorter than
        ``min_blocks`` don't count."""
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
            if b in self._doomed:
                # Dropped for corruption while shared: the last holder is
                # gone, so the page finally leaves the pool.
                self._doomed.discard(b)
                self.alloc.free([b])
            else:
                self._cold[b] = self._hash_of[b]  # most-recently-used end
        else:
            self._ref[b] = n - 1
