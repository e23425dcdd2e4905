"""The port's KV-page migration (``frontend/kv_transfer.py``,
``ServingEngine.reserve_migration_blocks``, ``Replica.fetch_kv_pages`` /
``push_kv_pages`` and the router's disaggregated prefill) against the JAX
package's.

Mirrors ``tests/test_kv_transfer.py`` less its process legs (the three
``test_process_*`` drills, the worker's fence filter and the wire's frame
cap, which belong to the process replicas). The bar: a transfer the port
snapshots has the JAX package's form (keys, layout shapes, dtype names,
``bfloat16`` included) and page values within fp32 tolerance of the JAX
engine's on the same prompt; the framing codec is the JAX package's (the
same frames, the same torn-transfer errors); adoption writes the pages in
place, typed rejects and a chain cut at the first corrupt page included;
and a fleet split into prefill and decode replicas gives greedy streams
bit-identical to a colocated engine and to the JAX fleet at depths 1-3,
with migration counts equal to the JAX fleet's, and a corrupted migration
never serves a wrong token. The tiny preset at fp32 (2 layers, d 32,
V 256) with seeded numpy weights (std 0.3) through ``models/bridge.py``.
"""

import base64
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu.config import get_preset as jax_preset
from pretraining_llm_tpu.frontend import kv_transfer as jkv
from pretraining_llm_tpu.frontend.replica import Replica as JaxReplica
from pretraining_llm_tpu.frontend.router import Router as JaxRouter
from pretraining_llm_tpu.generation.serving import ServingEngine as JaxEngine
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu.resilience.faults import ServingFaultInjector as JaxInjector
from pretraining_llm_tpu_torch.config import ModelConfig
from pretraining_llm_tpu_torch.frontend import kv_transfer
from pretraining_llm_tpu_torch.frontend.kv_transfer import (
    adopt_chain, corrupt_first_page, join_frames, snapshot_chain, split_frames,
)
from pretraining_llm_tpu_torch.frontend.replica import Replica
from pretraining_llm_tpu_torch.frontend.router import Router
from pretraining_llm_tpu_torch.generation.serving import ServingEngine
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.observability.events import EventBus
from pretraining_llm_tpu_torch.resilience.faults import ServingFaultInjector
from pretraining_llm_tpu_torch.resilience.integrity import kv_block_digest

JCFG = dataclasses.replace(jax_preset("tiny").model, compute_dtype="float32")
CFG = ModelConfig(**dict(dataclasses.asdict(JCFG), paged_attention_impl="kernel"))
WAIT = 120
_KV_KW = {"prefix_cache": True, "kv_checksum": True}


@functools.lru_cache(maxsize=None)
def _weights():
    layout = jax.eval_shape(functools.partial(jtf.init_params, JCFG), jax.random.key(0))
    rng = np.random.default_rng(0)

    def leaf(path, spec):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(0, 0.3, spec.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, layout)


@pytest.fixture(scope="module")
def params():
    return bridge.params_from_numpy(_weights(), CFG, device="cpu")


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(jnp.asarray, _weights())


def _engine_factory(params, **kw):
    kw = {"max_batch": 2, "n_blocks": 24, "block_size": 8, "steps_per_sched": 4, "pipeline_depth": 2, **kw}

    def factory():
        return ServingEngine(params, CFG, temperature=0.0, device="cpu", **kw)

    return factory


def _jax_factory(jparams, **kw):
    kw = {"max_batch": 2, "n_blocks": 24, "block_size": 8, "steps_per_sched": 4, "pipeline_depth": 2, **kw}
    return lambda: JaxEngine(jparams, JCFG, temperature=0.0, **kw)


def _undisturbed(params, prompts, n_new, **kw):
    eng = _engine_factory(params, **kw)()
    rids = {eng.submit(p, n_new): i for i, p in enumerate(prompts)}
    return {rids[rid]: toks for rid, toks in eng.run().items()}


def _shared_prefix_prompts(n=3, shared=12, tail=3, seed=42):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, CFG.vocab_size, size=shared).tolist()
    return [head + rng.integers(0, CFG.vocab_size, size=tail).tolist() for _ in range(n)]


def _distinct_prompts(n=3, length=13, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=length).tolist() for _ in range(n)]


# -- framing codec -----------------------------------------------------------


def _toy_xfer(n_pages=4, leaf_shapes=((2, 8, 4), (8,)), seed=0):
    rng = np.random.default_rng(seed)
    layout = [{"dtype": "int8", "shape": list(s)} for s in leaf_shapes]
    pages = []
    for _ in range(n_pages):
        arrays = [rng.integers(-128, 128, size=s, dtype=np.int8) for s in leaf_shapes]
        digest = kv_transfer._page_digest(["int8"] * len(arrays), arrays)
        assert digest == jkv._page_digest(arrays)
        pages.append({"digest": digest, "leaves": [base64.b64encode(a.tobytes()).decode("ascii") for a in arrays]})
    return {"v": kv_transfer.XFER_VERSION, "block_size": 8,
            "tokens": rng.integers(0, 100, size=n_pages * 8).tolist(), "layout": layout, "pages": pages}


def test_split_join_roundtrip_respects_budget():
    xfer = _toy_xfer(n_pages=4)
    frames = split_frames(xfer, budget=150)
    assert frames == jkv.split_frames(xfer, budget=150)
    assert len(frames) == 2 and [f["seq"] for f in frames] == [0, 1]
    assert all(f["n_frames"] == 2 and len(f["pages"]) == 2 for f in frames)
    assert frames[0]["tokens"] == xfer["tokens"] and "tokens" not in frames[1]
    assert join_frames(frames[::-1]) == xfer == join_frames(frames)
    assert kv_transfer.transfer_bytes(xfer) == jkv.transfer_bytes(xfer)


def test_split_oversized_page_still_travels():
    xfer = _toy_xfer(n_pages=3)
    frames = split_frames(xfer, budget=10)
    assert len(frames) == 3 and all(len(f["pages"]) == 1 for f in frames)
    assert join_frames(frames) == xfer
    with pytest.raises(ValueError, match="budget"):
        split_frames(xfer, budget=0)


def test_split_empty_transfer_keeps_header_frame():
    xfer = _toy_xfer(n_pages=1)
    xfer["pages"], xfer["tokens"] = [], []
    frames = split_frames(xfer)
    assert len(frames) == 1 and frames[0]["pages"] == []
    assert join_frames(frames)["pages"] == []


def test_join_torn_transfers_rejected_as_a_unit():
    frames = split_frames(_toy_xfer(n_pages=3), budget=80)
    assert len(frames) == 3

    def torn(fs):
        with pytest.raises(ValueError) as want:
            jkv.join_frames(fs)
        with pytest.raises(ValueError) as got:
            join_frames(fs)
        assert str(got.value) == str(want.value)
        return str(got.value)

    assert "missing frames" in torn(frames[:-1])
    assert "duplicate seq" in torn(frames + [frames[1]])
    bad = [dict(f) for f in frames]
    bad[2]["n_frames"] = 4
    assert "inconsistent n_frames" in torn(bad)
    bad = [dict(f) for f in frames]
    bad[1]["seq"] = 9
    assert "bad seq" in torn(bad)
    headless = [dict(f) for f in frames]
    del headless[0]["tokens"]
    assert "header missing" in torn(headless)
    assert "no frames" in torn([])


def test_corrupt_first_page_breaks_digest_only():
    xfer = _toy_xfer(n_pages=2)
    before = [{"digest": p["digest"], "leaves": list(p["leaves"])} for p in xfer["pages"]]
    assert corrupt_first_page(xfer)
    raw0 = base64.b64decode(before[0]["leaves"][0])
    raw1 = base64.b64decode(xfer["pages"][0]["leaves"][0])
    assert raw1[0] == raw0[0] ^ 0xFF and raw1[1:] == raw0[1:]
    assert xfer["pages"][0]["digest"] == before[0]["digest"] and xfer["pages"][1] == before[1]
    assert not corrupt_first_page({"pages": []})


# -- the transfer's form against the JAX engine's ---------------------------


def _warm_engine(params, prompt, n_new=4, **kw):
    eng = _engine_factory(params, **{**_KV_KW, **kw})()
    eng.submit(prompt, n_new)
    eng.run()
    return eng


def _decode_pages(xfer):
    """{leaf index: stacked page values as fp32} of a transfer, bf16 read
    through its int16 view."""
    out = []
    for j, spec in enumerate(xfer["layout"]):
        raw = [base64.b64decode(p["leaves"][j]) for p in xfer["pages"]]
        if spec["dtype"] == "bfloat16":
            arr = np.stack([np.frombuffer(r, np.int16) for r in raw])
            vals = torch.from_numpy(arr.copy()).view(torch.bfloat16).float().numpy()
        else:
            vals = np.stack([np.frombuffer(r, np.dtype(spec["dtype"])) for r in raw]).astype(np.float32)
        out.append(vals.reshape((len(raw),) + tuple(spec["shape"])))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transfer_has_the_jax_form_and_values(params, jparams, dtype):
    """The same prompt through the port's engine and the JAX engine, on the
    same weights: the transfers carry the same keys, block size, tokens,
    layout (shapes and dtype names) and number of pages, and every page
    value within 1e-4 (fp32 pools: summation order only) or one bf16 ulp
    of the largest |value| (bf16 pools, rounded from fp32 sums)."""
    prompt = _distinct_prompts(1, length=20)[0]
    kw = {**_KV_KW}
    tp, jp = params, jparams
    tcfg_, jcfg_ = CFG, JCFG
    if dtype == "bfloat16":
        tcfg_ = dataclasses.replace(CFG, compute_dtype="bfloat16")
        jcfg_ = dataclasses.replace(JCFG, compute_dtype="bfloat16")
    teng = ServingEngine(tp, tcfg_, temperature=0.0, max_batch=2, n_blocks=24, block_size=8, device="cpu", **kw)
    jeng = JaxEngine(jp, jcfg_, temperature=0.0, max_batch=2, n_blocks=24, block_size=8, **kw)
    for eng in (teng, jeng):
        eng.submit(prompt, 4)
        eng.run()
    got, want = snapshot_chain(teng, prompt), jkv.snapshot_chain(jeng, prompt)
    assert set(got) == set(want) == {"v", "block_size", "tokens", "layout", "pages"}
    assert (got["v"], got["block_size"], got["tokens"]) == (want["v"], want["block_size"], want["tokens"])
    assert got["layout"] == want["layout"]
    assert {spec["dtype"] for spec in got["layout"]} == {dtype}
    assert len(got["pages"]) == len(want["pages"]) == 2
    assert all(set(p) == {"digest", "leaves"} for p in got["pages"])
    tol = 1e-4 if dtype == "float32" else None
    for a, b in zip(_decode_pages(got), _decode_pages(want)):
        err = float(np.max(np.abs(a - b)))
        assert err <= (tol if tol is not None else 2.0 ** -7 * float(np.max(np.abs(b)))), err
    # A transfer the JAX engine snapshotted is adopted by the port's engine:
    # its digests verify against its own bytes, its layout is the port's.
    dst = ServingEngine(tp, tcfg_, temperature=0.0, max_batch=2, n_blocks=24, block_size=8, device="cpu", **kw)
    assert adopt_chain(dst, want) == {"inserted": 2, "rejected": 0, "published": 2, "reason": ""}


def test_bf16_pages_round_trip_through_their_integer_view(params):
    """bf16 pools have no numpy dtype: a snapshot travels as int16 bytes
    named ``bfloat16``, its digest equals the engine's acquire-side digest,
    and adoption writes the same bf16 values back."""
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    prompt = _distinct_prompts(1, length=20)[0]

    def make():
        return ServingEngine(params, cfg, temperature=0.0, max_batch=2, n_blocks=24, block_size=8, device="cpu",
                             **_KV_KW)

    src = make()
    src.submit(prompt, 4)
    src.run()
    xfer = snapshot_chain(src, prompt)
    _, blocks = src.prefix_cache.acquire(prompt)
    try:
        for page, b in zip(xfer["pages"], blocks):
            assert page["digest"] == kv_block_digest(src.pools, b) == src.prefix_cache.checksum_of(b)
    finally:
        src.prefix_cache.release_shared(blocks)
    dst = make()
    assert adopt_chain(dst, xfer)["inserted"] == 2
    _, got_blocks = dst.prefix_cache.acquire(prompt)
    _, src_blocks = src.prefix_cache.acquire(prompt)
    for lt, ls in zip(dst.pools["layers"], src.pools["layers"]):
        for name in ("k_pool", "v_pool"):
            assert lt[name].dtype == torch.bfloat16
            assert torch.equal(lt[name][got_blocks], ls[name][src_blocks])
    dst.prefix_cache.release_shared(got_blocks)
    src.prefix_cache.release_shared(src_blocks)


# -- snapshot/adopt against real engines -------------------------------------


def test_snapshot_digest_parity_with_acquire_side_checksum(params):
    prompt = _distinct_prompts(1, length=20)[0]
    eng = _warm_engine(params, prompt)
    xfer = snapshot_chain(eng, prompt)
    assert xfer is not None and len(xfer["pages"]) == 2
    assert xfer["block_size"] == 8 and xfer["tokens"] == prompt[:16]
    _, blocks = eng.prefix_cache.acquire(prompt)
    try:
        assert len(blocks) == 2
        for page, b in zip(xfer["pages"], blocks):
            assert page["digest"] == kv_block_digest(eng.pools, b) == eng.prefix_cache.checksum_of(b)
    finally:
        eng.prefix_cache.release_shared(blocks)


def test_snapshot_without_cache_or_coverage_is_none(params):
    prompt = _distinct_prompts(1, length=20)[0]
    assert snapshot_chain(_engine_factory(params, prefix_cache=False)(), prompt) is None
    assert snapshot_chain(_engine_factory(params, **_KV_KW)(), prompt) is None


def test_reserve_migration_blocks_keeps_the_admission_watermark(params):
    """``reserve_migration_blocks`` takes blocks only down to one spare per
    active request, the JAX engine's rule, and refuses n < 1."""
    eng = _engine_factory(params, **_KV_KW)()
    assert eng.reserve_migration_blocks(0) is None
    assert eng.reserve_migration_blocks(24) is None  # 23 usable blocks
    got = eng.reserve_migration_blocks(23)
    assert got is not None and len(got) == 23 and 0 not in got
    assert eng.reserve_migration_blocks(1) is None
    eng.alloc.free(got)


def test_adopt_roundtrip_is_bit_identical(params):
    prompt = _distinct_prompts(1, length=20)[0]
    n_new = 6
    ref = _undisturbed(params, [prompt], n_new, **_KV_KW)
    src = _warm_engine(params, prompt, n_new=n_new)
    xfer = snapshot_chain(src, prompt)
    dst = _engine_factory(params, **_KV_KW)()
    assert adopt_chain(dst, xfer) == {"inserted": 2, "rejected": 0, "published": 2, "reason": ""}
    assert dst.stats["kv_pages_adopted"] == 2 and dst.stats.get("kv_pages_rejected", 0) == 0
    res2 = adopt_chain(dst, snapshot_chain(src, prompt))
    assert res2["inserted"] == 2 and res2["published"] == 0
    assert dst.alloc.available + dst.prefix_cache.cached_blocks == 24 - 1  # duplicates went back
    rid = dst.submit(prompt, n_new)
    assert dst.run()[rid] == ref[0]
    assert dst.stats.get("kv_mismatches", 0) == 0  # the adopted digests verify at acquire


def test_adopt_rejects_are_typed_and_counted(params):
    prompt = _distinct_prompts(1, length=20)[0]
    xfer = snapshot_chain(_warm_engine(params, prompt), prompt)
    nocache = _engine_factory(params, prefix_cache=False)()
    res = adopt_chain(nocache, dict(xfer))
    assert res["inserted"] == 0 and res["reason"] == "no_prefix_cache"
    assert nocache.stats["kv_pages_rejected"] == 2
    res = adopt_chain(_engine_factory(params, block_size=16, **_KV_KW)(), dict(xfer))
    assert res["reason"] == "block_size_mismatch" and res["rejected"] == 2
    res = adopt_chain(_engine_factory(params, **_KV_KW)(), {**xfer, "v": 99})
    assert res["reason"] == "version_mismatch" and res["inserted"] == 0
    bad_layout = {**xfer, "layout": [dict(s, dtype="bfloat16") for s in xfer["layout"]]}
    assert adopt_chain(_engine_factory(params, **_KV_KW)(), bad_layout)["reason"] == "layout_mismatch"
    full = _engine_factory(params, **_KV_KW)()
    held = full.alloc.alloc(22)
    assert adopt_chain(full, dict(xfer))["reason"] == "capacity"
    full.alloc.free(held)


def test_adopt_truncates_chain_at_first_corrupt_page(params):
    prompt = _distinct_prompts(1, length=20)[0]
    n_new = 6
    ref = _undisturbed(params, [prompt], n_new, **_KV_KW)
    src = _warm_engine(params, prompt, n_new=n_new)
    xfer = snapshot_chain(src, prompt)
    assert corrupt_first_page(xfer)
    dst = _engine_factory(params, **_KV_KW)()
    assert adopt_chain(dst, xfer) == {"inserted": 0, "rejected": 2, "published": 0, "reason": "checksum_mismatch"}
    assert dst.stats["kv_pages_rejected"] == 2

    xfer = snapshot_chain(src, prompt)
    raw = bytearray(base64.b64decode(xfer["pages"][1]["leaves"][0]))
    raw[0] ^= 0xFF
    xfer["pages"][1]["leaves"][0] = base64.b64encode(bytes(raw)).decode()
    dst = _engine_factory(params, **_KV_KW)()
    assert adopt_chain(dst, xfer) == {"inserted": 1, "rejected": 1, "published": 1, "reason": "checksum_mismatch"}
    assert dst.stats["kv_pages_adopted"] == 1 and dst.stats["kv_pages_rejected"] == 1
    rid = dst.submit(prompt, n_new)
    assert dst.run()[rid] == ref[0]


# -- the disaggregated fleet --------------------------------------------------


def _disagg_fleet(factory, faults=None, bus=None, jax_side=False, **router_kw):
    rep, router = (JaxReplica, JaxRouter) if jax_side else (Replica, Router)
    reps = [rep(0, factory, role="prefill", bus=bus, fault_injector=faults),
            rep(1, factory, role="decode", bus=bus, fault_injector=faults)]
    router_kw.setdefault("eject_backoff_s", 0.1)
    return router(reps, bus=bus, **router_kw)


def _serial(router, prompts, n_new):
    with router:
        # Serial: a deterministic migration and warmth order.
        return [router.submit(p, n_new).result(timeout=WAIT) for p in prompts]


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("cache", [False, True], ids=["nocache", "cache"])
def test_disagg_bit_identity_grid(params, jparams, depth, cache):
    kw = {"pipeline_depth": depth, "prefix_cache": cache, "kv_checksum": cache}
    prompts = _shared_prefix_prompts(3)
    n_new = 8
    ref = _undisturbed(params, prompts, n_new, **kw)
    router = _disagg_fleet(_engine_factory(params, **kw))
    results = _serial(router, prompts, n_new)
    jrouter = _disagg_fleet(_jax_factory(jparams, **kw), jax_side=True)
    jresults = _serial(jrouter, prompts, n_new)
    for i, ((status, tokens, info), (_, jtokens, jinfo)) in enumerate(zip(results, jresults)):
        assert status == "done", (i, status, info)
        assert tokens == ref[i] == jtokens, (i, tokens, ref[i])
        assert info["replica"] == jinfo["replica"] == 1
    keys = ("kv_migrations", "kv_pages_migrated", "kv_migration_rejects")
    assert {k: router.counters[k] for k in keys} == {k: jrouter.counters[k] for k in keys}
    if cache:
        assert router.counters["kv_migrations"] == 1 and router.counters["kv_pages_migrated"] >= 1
        assert router.counters["kv_migration_rejects"] == 0
        assert router.replicas[1].engine.stats["kv_pages_adopted"] >= 1
    else:
        assert router.counters["kv_pages_migrated"] == 0


def test_corrupt_kv_migration_never_serves_wrong_tokens(params, jparams):
    """One byte of the first migrated page flipped in flight: the decode
    replica drops it, the request re-prefills, streams stay bit-identical,
    and the drop counts and events equal the JAX fleet's."""
    prompts = _distinct_prompts(3)
    n_new = 8
    ref = _undisturbed(params, prompts, n_new, **_KV_KW)
    events = []
    bus = EventBus()
    bus.subscribe(events.append)
    router = _disagg_fleet(_engine_factory(params, **_KV_KW),
                           faults=ServingFaultInjector("corrupt_kv_migration@req1:r1", bus=bus), bus=bus)
    results = _serial(router, prompts, n_new)
    jrouter = _disagg_fleet(_jax_factory(jparams, **_KV_KW), faults=JaxInjector("corrupt_kv_migration@req1:r1"),
                            jax_side=True)
    jresults = _serial(jrouter, prompts, n_new)
    for i, ((status, tokens, info), (_, jtokens, _)) in enumerate(zip(results, jresults)):
        assert status == "done", (i, status, info)
        assert tokens == ref[i] == jtokens
    keys = ("kv_migrations", "kv_pages_migrated", "kv_migration_rejects")
    assert {k: router.counters[k] for k in keys} == {k: jrouter.counters[k] for k in keys}
    assert router.counters["kv_migrations"] == 3 and router.counters["kv_migration_rejects"] >= 1
    stats = router.replicas[1].engine.stats
    assert stats["kv_pages_rejected"] >= 1 and stats["kv_pages_adopted"] >= 1
    kinds = [ev.get("event") for ev in events]
    assert "kv_migrate" in kinds and "fault_fired" in kinds
    rejects = [ev for ev in events if ev.get("event") == "kv_migration_reject"]
    assert rejects and rejects[0]["reason"] == "checksum_mismatch" and rejects[0]["replica"] == 1
    counts = router.decisions.counts_snapshot()
    assert counts.get("kv_migrate") == 3 and counts.get("kv_migration_reject", 0) >= 1


def test_prefill_fetch_failure_falls_back_colocated(params):
    prompts = _distinct_prompts(2)
    n_new = 6
    ref = _undisturbed(params, prompts, n_new, **_KV_KW)
    router = _disagg_fleet(_engine_factory(params, **_KV_KW))

    def boom(prompt, **kw):
        raise RuntimeError("prefill tier vanished")

    router.replicas[0].fetch_kv_pages = boom
    results = _serial(router, prompts, n_new)
    assert [(s, t) for s, t, _ in results] == [("done", ref[i]) for i in range(2)]
    assert router.counters["kv_pages_migrated"] == 0


def test_single_tier_fleet_never_migrates(params):
    prompts = _distinct_prompts(2)
    n_new = 6
    ref = _undisturbed(params, prompts, n_new, **_KV_KW)
    factory = _engine_factory(params, **_KV_KW)
    router = Router([Replica(i, factory) for i in range(2)], eject_backoff_s=0.1)
    results = _serial(router, prompts, n_new)
    assert [(s, t) for s, t, _ in results] == [("done", ref[i]) for i in range(2)]
    assert router.counters["kv_migrations"] == 0
