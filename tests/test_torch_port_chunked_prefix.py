"""Chunked prefill and the prefix cache in the port's serving engine, against
the JAX package's.

Greedy token streams must be identical to the JAX engine's (synchronous
scheduler) on the same fp32 weights with ``prefill_chunk_tokens``, with the
prefix cache, and with both, through admission churn, a stop token and
preemption (of a row in the middle of its prefill too). The port's own
contracts are mirrored from ``test_chunked_prefill.py`` and
``test_prefix_cache.py``: chunked equals monolithic, cache on equals cache
off, blocks are conserved at drain, and the ``PrefixCache`` unit cases; a
random sequence of cache operations gives the same blocks in both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu.config import ModelConfig as JaxModelConfig
from pretraining_llm_tpu.generation.paged import BlockAllocator as JaxBlockAllocator
from pretraining_llm_tpu.generation.prefix_cache import PrefixCache as JaxPrefixCache
from pretraining_llm_tpu.generation.serving import ServingEngine as JaxServingEngine
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.generation.paged import BlockAllocator
from pretraining_llm_tpu_torch.generation.prefix_cache import STAT_KEYS, PrefixCache
from pretraining_llm_tpu_torch.generation.serving import ServingEngine
from pretraining_llm_tpu_torch.models import bridge

BS = 8
TINY = dict(
    vocab_size=64, context_length=64, d_model=32, n_heads=4, n_layers=2,
    activation="gelu", norm="layernorm", pos_embed="learned",
    tie_embeddings=True, qkv_bias=True, mlp_bias=True,
    compute_dtype="float32", attention_impl="flash",
)


@functools.lru_cache(maxsize=None)
def _weights():
    """Seeded numpy weights in the JAX ``init_params`` layout, scaled up so
    that greedy streams vary from token to token."""
    jc = JaxModelConfig(**TINY)
    layout = jax.eval_shape(functools.partial(jtf.init_params, jc), jax.random.key(0))
    rng = np.random.default_rng(0)

    def leaf(path, spec):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(0, 0.3, spec.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, layout)


def _shared_prefix_requests(n=7):
    """Prompts sharing a two-block prefix, with their own tails."""
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, 64, size=2 * BS).tolist()
    return [
        (prefix + rng.integers(0, 64, size=int(rng.integers(1, 13))).tolist(),
         int(rng.integers(4, 14)))
        for _ in range(n)
    ]


def _port(kw, impl="kernel"):
    cfg = ModelConfig(**dict(TINY, paged_attention_impl=impl))
    return ServingEngine(bridge.params_from_numpy(_weights(), cfg, device="cpu"), cfg,
                         device="cpu", **kw)


def _serve(eng, requests):
    rids = [eng.submit(p, n) for p, n in requests]
    out = eng.run(pipeline=False)  # the synchronous scheduler of either engine
    return [out[r] for r in rids]


def _jax_engine(kw):
    return JaxServingEngine(jax.tree.map(jnp.asarray, _weights()), JaxModelConfig(**TINY),
                            pipeline_depth=1, **kw)


@functools.lru_cache(maxsize=None)
def _stop_token():
    """A token the shared-prefix workload emits early in its first stream."""
    out = _serve(_port(dict(max_batch=3, n_blocks=24, block_size=BS)), _shared_prefix_requests())
    return out[0][2]


_STAT_KEYS = ("steps", "tokens", "admissions", "prefill_tokens", "preemptions",
              "prefill_chunks", "prefill_chunk_tokens", "chunk_windows_interleaved",
              "chunk_windows_dedicated") + STAT_KEYS


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("chunk,cache", [(5, False), (0, True), (6, True)])
def test_engine_greedy_streams_match_jax(chunk, cache, impl):
    """More requests than rows, a shared prefix published mid-run, a stop
    token and chunk budgets smaller than most prompts."""
    kw = dict(max_batch=3, n_blocks=24, block_size=BS, steps_per_sched=4,
              stop_token=_stop_token(), prefill_chunk_tokens=chunk, prefix_cache=cache)
    requests = _shared_prefix_requests()
    jeng, teng = _jax_engine(kw), _port(kw, impl)
    want, got = _serve(jeng, requests), _serve(teng, requests)
    assert got == want
    assert any(len(out) < n for out, (_, n) in zip(got, requests))  # the stop token fired
    for key in _STAT_KEYS:
        assert teng.stats.get(key, 0) == jeng.stats.get(key, 0), key
    if cache:
        assert teng.stats["prefix_cache_hit_tokens"] > 0
        assert [teng.timing_summary(r).get("cached_tokens") for r in range(len(requests))] == [
            jeng.timing_summary(r).get("cached_tokens") for r in range(len(requests))
        ]
    if chunk:
        assert teng.stats["prefill_chunks"] > len(requests)


@pytest.mark.parametrize("cache", [False, True])
def test_preemption_mid_prefill_matches_jax(cache, monkeypatch):
    """A row still streaming its prompt is the youngest when the pool runs
    dry: it is preempted mid-prefill, requeued, and re-streamed (hitting
    its own published chunk with the cache on). Streams match JAX and the
    pool is whole at drain."""
    kw = dict(max_batch=2, n_blocks=7, block_size=BS, steps_per_sched=4,
              prefill_chunk_tokens=4, prefix_cache=cache)
    rng = np.random.default_rng(5)
    requests = [(rng.integers(0, 64, size=5).tolist(), 40),
                (rng.integers(0, 64, size=30).tolist(), 6)]
    teng = _port(kw)
    victims = []
    preempt = teng._preempt
    monkeypatch.setattr(teng, "_preempt", lambda req: (victims.append(req.prefill_pos), preempt(req)))
    got = _serve(teng, requests)
    assert got == _serve(_jax_engine(kw), requests)
    assert any(pos is not None for pos in victims)
    cold = teng.prefix_cache.evictable if cache else 0
    assert teng.alloc.available + cold == kw["n_blocks"] - 1
    assert teng.stats["preempted_tokens_recomputed"] > 0


def test_chunked_equals_monolithic_and_counts_every_prompt_token():
    requests = _shared_prefix_requests(5)
    kw = dict(max_batch=2, n_blocks=32, block_size=BS, steps_per_sched=4)
    off = _serve(_port(kw), requests)
    eng = _port(dict(kw, prefill_chunk_tokens=6))
    assert _serve(eng, requests) == off
    total = sum(len(p) for p, _ in requests)
    assert eng.stats["prefill_chunk_tokens"] == eng.stats["prefill_tokens"] == total
    assert eng.stats["chunk_deferrals"] > 0  # the budget made rows wait
    assert eng.alloc.available == kw["n_blocks"] - 1


def test_cache_on_equals_off_and_blocks_conserved_at_drain():
    requests = _shared_prefix_requests(6)
    kw = dict(max_batch=2, n_blocks=32, block_size=BS, steps_per_sched=4)
    off = _serve(_port(kw), requests)
    eng = _port(dict(kw, prefix_cache=True))
    assert _serve(eng, requests) == off
    assert eng.stats["prefix_cache_hits"] > 0
    cache = eng.prefix_cache
    assert eng.alloc.available + cache.evictable == kw["n_blocks"] - 1
    assert cache.evictable == cache.cached_blocks  # nothing still shared
    cache.flush()
    assert eng.alloc.available == kw["n_blocks"] - 1 and cache.cached_blocks == 0


def test_eviction_before_preemption():
    """Sequential single-row traffic fills the pool with cold published
    pages; later growth must evict them, not preempt."""
    rng = np.random.default_rng(9)
    eng = _port(dict(max_batch=1, n_blocks=10, block_size=BS, steps_per_sched=4, prefix_cache=True))
    _serve(eng, [(rng.integers(0, 64, size=12).tolist(), 16) for _ in range(4)])
    assert eng.stats["prefix_cache_evicted_blocks"] >= 1
    assert eng.stats["preemptions"] == 0


def test_suffix_prefill_rejects_bad_input():
    from pretraining_llm_tpu_torch.generation import paged

    eng = _port(dict(max_batch=2, n_blocks=8, block_size=BS))
    tables = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="empty"):
        paged.prefill_suffix_into_pool_batched(eng.params, eng.cfg, eng.pools, [[]], tables, [0])
    with pytest.raises(ValueError, match="t_bucket"):
        paged.prefill_suffix_into_pool_batched(eng.params, eng.cfg, eng.pools, [[1, 2, 3]], tables,
                                               [0], t_bucket=2)
    with pytest.raises(ValueError, match="cached_lens"):
        paged.prefill_suffix_into_pool_batched(eng.params, eng.cfg, eng.pools, [[1]], tables, [0, 0])
    with pytest.raises(ValueError, match="prefill_chunk_tokens"):
        _port(dict(prefill_chunk_tokens=-1))


# -- PrefixCache unit cases -------------------------------------------------


def _publish(cache, alloc, history, *, n_shared=0, blocks=None):
    """Allocate blocks for ``history`` and publish its full blocks as a
    finished row's release does (publish_len = len(history))."""
    if blocks is None:
        blocks = alloc.alloc(-(-len(history) // cache.block_size))
    cache.release_row(history, blocks, n_shared, len(history))
    return blocks


def test_chain_digest_binds_whole_prefix_and_matches_jax():
    block = list(range(8))
    d_root = PrefixCache._chain(b"", block)
    assert d_root != PrefixCache._chain(d_root, block)
    assert d_root == PrefixCache._chain(b"", list(range(8))) == JaxPrefixCache._chain(b"", block)


def test_hit_capped_one_token_short_of_prompt():
    alloc = BlockAllocator(16)
    cache = PrefixCache(alloc, BS)
    hist = list(range(24))
    _publish(cache, alloc, hist)
    cached, ids = cache.acquire(hist)
    assert cached == 16 and len(ids) == 2
    cache.release_shared(ids)


def test_min_blocks_gates_short_hits():
    alloc = BlockAllocator(16)
    cache = PrefixCache(alloc, BS, min_blocks=2)
    _publish(cache, alloc, list(range(24)))
    assert cache.peek(list(range(12))) == 0
    assert cache.peek(list(range(24))) == 16


def test_acquire_refcounts_and_cold_lru_transitions():
    alloc = BlockAllocator(16)
    cache = PrefixCache(alloc, BS)
    _publish(cache, alloc, list(range(16)))
    assert cache.evictable == 2 and cache.cached_blocks == 2
    cached, ids = cache.acquire(list(range(17)))
    assert cached == 16 and cache.evictable == 0
    assert cache.evict(5) == 0  # live-shared blocks are never evictable
    cache.release_shared(ids)
    assert cache.evictable == 2
    assert cache.evict(5) == 2
    assert cache.cached_blocks == 0


def test_peek_has_no_side_effects():
    alloc = BlockAllocator(16)
    cache = PrefixCache(alloc, BS)
    _publish(cache, alloc, list(range(16)))
    before = (cache.evictable, cache.cached_blocks, alloc.available)
    assert cache.peek(list(range(17))) == 16
    assert (cache.evictable, cache.cached_blocks, alloc.available) == before


def test_evict_lru_order_touch_refreshes():
    alloc = BlockAllocator(16)
    cache = PrefixCache(alloc, BS)
    a = _publish(cache, alloc, [1] * 8)
    b = _publish(cache, alloc, [2] * 8)
    _, ids = cache.acquire([1] * 9)
    cache.release_shared(ids)
    assert cache.evict(1) == 1
    assert cache.peek([2] * 9) == 0 and cache.peek([1] * 9) == 8
    assert b[0] in alloc._free and a[0] not in alloc._free


def test_duplicate_publish_first_writer_wins():
    alloc = BlockAllocator(16)
    cache = PrefixCache(alloc, BS)
    _publish(cache, alloc, list(range(16)))
    avail = alloc.available
    _publish(cache, alloc, list(range(16)))
    assert cache.cached_blocks == 2 and alloc.available == avail


def test_release_row_frees_partial_tail_and_caps_at_publish_len():
    alloc = BlockAllocator(16)
    cache = PrefixCache(alloc, BS)
    cache.release_row(list(range(20)), alloc.alloc(4), 0, 20)  # 2 full + partial + spare
    assert cache.cached_blocks == 2 and alloc.available == 16 - 1 - 2
    cache.flush()
    cache.release_row(list(range(16)), alloc.alloc(2), 0, 15)  # last slot unwritten
    assert cache.cached_blocks == 1 and alloc.available == 16 - 1 - 1


def test_release_unreferenced_block_raises():
    with pytest.raises(ValueError, match="unreferenced"):
        PrefixCache(BlockAllocator(16), BS).release_shared([3])


def test_alloc_cannot_cannibalize_cold_cache():
    """Cold cached blocks stay live in the allocator: taking every free
    block returns none of them, and a flush gives them all back."""
    alloc = BlockAllocator(16)
    cache = PrefixCache(alloc, BS)
    published = set(_publish(cache, alloc, list(range(16))))
    got = alloc.alloc(alloc.available)
    assert not (set(got) & published) and alloc.alloc(1) is None
    alloc.free(got)
    cache.flush()
    assert alloc.available == 15


def test_stats_live_in_caller_dict():
    stats = {"other": 1}
    cache = PrefixCache(BlockAllocator(4), BS, stats=stats)
    assert all(stats[k] == 0 for k in STAT_KEYS)
    cache.note_hit(16)
    cache.note_miss()
    assert (stats["prefix_cache_hits"], stats["prefix_cache_hit_tokens"],
            stats["prefix_cache_misses"], stats["other"]) == (1, 16, 1, 1)
    with pytest.raises(ValueError):
        PrefixCache(BlockAllocator(4), BS, min_blocks=0)


def test_random_cache_operations_match_jax():
    """The same random publish / acquire / release / evict sequence on both
    packages' caches hands out the same block ids and leaves the same
    state after every operation."""
    rng = np.random.default_rng(0)
    port = PrefixCache(BlockAllocator(40), BS)
    ref = JaxPrefixCache(JaxBlockAllocator(40), BS)
    held = {id(port): [], id(ref): []}
    vocab = [rng.integers(0, 3, size=40).tolist() for _ in range(4)]
    for _ in range(300):
        op = int(rng.integers(0, 4))
        hist = vocab[int(rng.integers(0, 4))][: int(rng.integers(1, 40))]
        publish_len = int(rng.integers(0, len(hist) + 1))
        n_evict = int(rng.integers(1, 4))
        results = []
        for cache in (port, ref):
            if op == 0:
                blocks = cache.alloc.alloc(-(-len(hist) // BS))
                results.append(blocks and cache.release_row(hist, blocks, 0, publish_len))
            elif op == 1:
                results.append(cache.acquire(hist))
                held[id(cache)].append(results[-1][1])
            elif op == 2 and held[id(cache)]:
                cache.release_shared(held[id(cache)].pop(0))
            else:
                results.append(cache.evict(n_evict))
        assert results[:1] == results[1:]
        assert (port.evictable, port.cached_blocks, port.alloc.available, port.alloc._free) == (
            ref.evictable, ref.cached_blocks, ref.alloc.available, ref.alloc._free)
