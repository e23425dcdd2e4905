"""The port's sample and evaluate entry points against the JAX package.

The cached forward at any cache index (``forward`` with a dense cache,
``pad_offsets``), ``blockwise_attention``, ``generate``,
``cast_params_for_inference``, ``load_model_for_inference``,
``generate_text`` / ``generate_text_batch`` and the ``generate_text`` and
``evaluate`` CLIs of ``pretraining_llm_tpu_torch``, each held against its
counterpart in ``pretraining_llm_tpu`` on the same inputs: weights drawn
with numpy from a seed (std 0.3, so that greedy streams vary), passed to
both packages (``models/bridge.py``). Small shapes: 2 layers, d 64,
T <= 64, V 256 (260 where the byte tokenizer's 257 ids must fit).

Bars: fp32 logits within 1e-4 of JAX at every cached step (chunks and
decode steps, each continuing from JAX's cache; int8 caches after
checking that the port wrote JAX's scales, and its codes but for at most
two rounding ties a call); ``blockwise_attention`` within 1e-5; greedy
tokens identical to JAX's ``generate``; validation raises JAX's exception
types; JAX-checkpoint strings equal at temperature 0; the evaluate CLI's
``val_loss`` within 1e-5 relative of the JAX computation; sampled first
tokens within 0.06 total variation of the softmax they sample from.
"""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.models import transformer as jt
from pretraining_llm_tpu.ops import flash_attention as jflash
from pretraining_llm_tpu.training import checkpoint as jckpt
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch import evaluate as tevaluate
from pretraining_llm_tpu_torch import generate_text as tgen_cli
from pretraining_llm_tpu_torch.generation import generate as tgen
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.models import transformer as tt
from pretraining_llm_tpu_torch.ops.flash_attention import blockwise_attention

jgen = importlib.import_module("pretraining_llm_tpu.generation.generate")

BASE = dict(vocab_size=256, context_length=64, d_model=64, n_heads=4, n_layers=2,
            compute_dtype="float32", attention_impl="flash")
VARIANTS = {
    "learned-mha": dict(),
    "rope-gqa": dict(pos_embed="rope", n_kv_heads=2),
    "learned-mha-int8": dict(kv_cache_dtype="int8"),
    "rope-gqa-int8": dict(pos_embed="rope", n_kv_heads=2, kv_cache_dtype="int8"),
    "rope-window": dict(pos_embed="rope", sliding_window=12, flash_block_kv=8),
    "naive": dict(attention_impl="naive"),
}
LOGIT_TOL = 1e-4


def random_params(cfg, seed, std=0.3):
    """A JAX-layout parameter tree of numpy arrays: norm scales 1 + 0.1 n,
    biases 0.1 n, every other leaf std * n."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jt.init_params(cfg, jax.random.key(0)))

    def leaf(path, s):
        name = str(getattr(path[-1], "key", ""))
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * x
        if name.startswith("b"):
            return 0.1 * x
        return std * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def build(variant, **extra):
    kw = dict(BASE, **VARIANTS[variant], **extra)
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    npp = random_params(jc, 0)
    return jc, tc, jax.tree.map(jnp.asarray, npp), bridge.params_from_numpy(npp, tc, device="cpu")


@pytest.fixture(scope="module")
def models():
    return {name: build(name) for name in VARIANTS}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_int8_codes(jcache, tcache, step):
    """The int8 cache the port wrote holds JAX's scales (1e-5 relative) and
    JAX's codes, except at most two codes one step apart: rounding ties,
    where the fp32 inputs of the two packages differ in the last bit."""
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[name + "_scale"]), _np(jcache[name + "_scale"]), rtol=1e-5)
        diff = _np(jcache[name]).astype(np.int32) - _np(tcache[name]).astype(np.int32)
        assert np.abs(diff).max() <= 1 and np.count_nonzero(diff) <= 2, (name, step, np.count_nonzero(diff))


_jax_decode = jax.jit(jt.forward, static_argnames=("cfg",))


def _run_cached(variant, models, calls):
    """Drive both packages through ``calls`` ((lo, hi, pad_offsets)) of
    cached forwards over one token stream, continuing each from JAX's
    cache, and return the worst logit difference."""
    jc, tc, jp, tp = models[variant]
    jc = dataclasses.replace(jc, decode_cache_layout="stacked")
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 48))
    jcache = jt.make_kv_cache(jc, 2, 48)
    worst = 0.0
    for step, (lo, hi, pad) in enumerate(calls):
        tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
        jpad = None if pad is None else jnp.asarray(pad, jnp.int32)
        tpad = None if pad is None else torch.tensor(pad)
        if hi - lo == 1:  # a decode step: JAX's masked path, traced index or not
            jl, jcache = _jax_decode(jp, jnp.asarray(toks[:, lo:hi]), jc, kv_cache=jcache,
                                     cache_index=jnp.int32(lo), pad_offsets=jpad)
        else:  # a concrete index, as the chunk loops pass it
            jl, jcache = jt.forward(jp, jnp.asarray(toks[:, lo:hi]), jc, kv_cache=jcache, cache_index=lo,
                                    pad_offsets=jpad)
        tl, tcache = tt.forward(tp, torch.from_numpy(toks[:, lo:hi]), tc, kv_cache=tcache, cache_index=lo,
                                pad_offsets=tpad)
        if tc.kv_cache_dtype == "int8":
            _check_int8_codes(jcache, tcache, step)
        worst = max(worst, float(np.abs(np.asarray(jl) - tl.numpy()).max()))
    return worst


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cached_decode_logits_match_jax(models, variant):
    """Prefill at index 0, then one token per step at indices 16..21:
    each step's logits within 1e-4 of JAX's forward on the same cache."""
    calls = [(0, 16, None)] + [(i, i + 1, None) for i in range(16, 22)]
    assert _run_cached(variant, models, calls) <= LOGIT_TOL


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_chunked_prefill_at_nonzero_index_matches_jax(models, variant):
    """Chunks of 16 at indices 0, 16 and 32 (blockwise attention against
    the cut cache under flash), then two decode steps."""
    calls = [(0, 16, None), (16, 32, None), (32, 40, None), (40, 41, None), (41, 42, None)]
    assert _run_cached(variant, models, calls) <= LOGIT_TOL


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ragged_decode_with_pad_offsets_matches_jax(models, variant):
    """Decode steps with per-row left-pads: logical positions for learned
    and RoPE positions, pad slots masked out."""
    pad = [0, 5]
    calls = [(0, 16, None)] + [(i, i + 1, pad) for i in range(16, 22)]
    assert _run_cached(variant, models, calls) <= LOGIT_TOL


@pytest.mark.parametrize("g,window,q_offset,k_offset,block_kv", [
    (4, 0, 0, 0, 0), (2, 0, 24, 0, 8), (1, 10, 40, 16, 8), (2, 6, 17, 8, 4),
])
def test_blockwise_attention_matches_jax(g, window, q_offset, k_offset, block_kv):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 16, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, g, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, g, 16)).astype(np.float32)
    kw = dict(causal=True, block_q=8, block_kv=block_kv, q_offset=q_offset, k_offset=k_offset, window=window)
    want = np.asarray(jflash.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = blockwise_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_chunked_prefill_matches_the_uncached_forward(models):
    """Within the port: chunked prefill (blockwise at indices 8 and 16) gives
    the uncached forward's logits."""
    _, tc, _, tp = models["rope-gqa"]
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, tc.vocab_size, (2, 24)))
    full, _ = tt.forward(tp, toks, tc)
    cache = tt.make_kv_cache(tc, 2, 24, dtype="float32", device="cpu")
    got = []
    for start in (0, 8, 16):
        logits, cache = tt.forward(tp, toks[:, start:start + 8], tc, kv_cache=cache, cache_index=start)
        got.append(logits)
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), full.numpy(), atol=2e-4, rtol=2e-4)


def test_pad_offsets_validation_matches_jax(models):
    jc, tc, jp, tp = models["learned-mha"]
    toks = np.zeros((2, 4), np.int64)
    with pytest.raises(ValueError, match="pad_offsets"):
        jt.forward(jp, jnp.asarray(toks), jc, pad_offsets=jnp.zeros(2, jnp.int32))
    with pytest.raises(ValueError, match="pad_offsets"):
        tt.forward(tp, torch.from_numpy(toks), tc, pad_offsets=torch.zeros(2, dtype=torch.int32))
    pool = tt.make_paged_kv_pool(tc, 4, 8, device="cpu")
    info = tt.PagedInfo(torch.ones(2, 1, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="pad_offsets"):
        tt.forward(tp, torch.from_numpy(toks[:, :1]), tc, kv_cache=pool, paged=info,
                   pad_offsets=torch.zeros(2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------


def _both(variant, models, prompt, n_new, **kw):
    jc, tc, jp, tp = models[variant]
    want = np.asarray(jgen.generate(jp, jc, jnp.asarray(prompt), n_new, jax.random.key(0), temperature=0.0,
                                    **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                                       for k, v in kw.items()}))
    got = tgen.generate(tp, tc, prompt, n_new, 0, temperature=0.0, **kw).numpy()
    return got, want


@pytest.mark.parametrize("variant", ["learned-mha", "rope-gqa", "rope-window", "naive"])
@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_greedy_generate_matches_jax(models, variant, ragged):
    prompt = np.random.default_rng(11).integers(0, 256, (3, 11))
    kw = dict(prompt_lengths=np.array([11, 4, 7])) if ragged else {}
    got, want = _both(variant, models, prompt, 20, **kw)
    assert got.dtype == np.int32 and got.shape == (3, 20)
    assert len(np.unique(want)) > 5  # the streams vary
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", ["learned-mha", "rope-gqa"])
def test_ragged_rows_equal_per_row_generation(models, variant):
    _, tc, _, tp = models[variant]
    lengths = [3, 8, 5]
    rng = np.random.default_rng(20)
    batch = np.zeros((3, 8), np.int64)
    for i, n in enumerate(lengths):
        batch[i, :n] = rng.integers(0, tc.vocab_size, n)
    got = tgen.generate(tp, tc, batch, 6, 9, temperature=0.0, prompt_lengths=lengths).numpy()
    for i, n in enumerate(lengths):
        want = tgen.generate(tp, tc, batch[i, :n], 6, 9, temperature=0.0).numpy()
        np.testing.assert_array_equal(got[i], want[0], err_msg=f"row {i} (len {n})")


def test_stop_token_freezes_finished_rows_as_jax(models):
    prompt = np.random.default_rng(30).integers(0, 256, (2, 6))
    base, _ = _both("learned-mha", models, prompt, 10)
    stop = int(base[0, 2])  # a token the greedy run emits
    got, want = _both("learned-mha", models, prompt, 10, stop_token=stop)
    np.testing.assert_array_equal(got, want)
    for row in range(2):
        hits = np.where(base[row] == stop)[0]
        if hits.size == 0:
            np.testing.assert_array_equal(got[row], base[row])
            continue
        first = int(hits[0])
        np.testing.assert_array_equal(got[row, :first + 1], base[row, :first + 1])
        assert (got[row, first:] == stop).all(), got[row]


def test_generate_validation_raises_jax_types(models):
    jc, tc, jp, tp = models["learned-mha"]
    cases = [
        (np.zeros((1, 60), np.int64), 10, {}, "context_length"),
        (np.zeros((2, 4), np.int64), 4, dict(prompt_lengths=np.array([2, 3, 4])), "prompt_lengths"),
        (np.zeros((2, 4), np.int64), 4, dict(prompt_lengths=np.array([2, 9])), "prompt_lengths"),
        (np.zeros((2, 4), np.int64), 4, dict(prompt_lengths=np.array([0, 3])), "prompt_lengths"),
    ]
    for prompt, n_new, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            jgen.generate(jp, jc, jnp.asarray(prompt), n_new, jax.random.key(0),
                          **{k: jnp.asarray(v) for k, v in kw.items()})
        with pytest.raises(ValueError, match=match):
            tgen.generate(tp, tc, prompt, n_new, 0, **kw)


def test_unported_generate_options_raise(models, jax_ckpt, capsys):
    """Sharded decode still raises, and so do ragged rows of a MoE model
    (JAX's ``ValueError``: MoE itself runs since it was ported). Speculative
    decoding, refused before it was ported, now runs: a greedy ``generate_text_speculative``
    (self-draft, k 3) and the CLI's ``--draft_model_path`` mode give
    ``generate_text``'s string, and JAX's."""
    _, tc, _, tp = models["learned-mha"]
    with pytest.raises(NotImplementedError, match="mesh"):
        tgen.generate(tp, tc, np.zeros((1, 4), np.int64), 2, 0, mesh=object())
    with pytest.raises(NotImplementedError, match="shard_params_for_inference"):
        tgen.shard_params_for_inference(tp, object())
    path = jax_ckpt["plain"]
    want = tgen.generate_text(path, "Hello", 10, temperature=0.0, device="cpu")
    assert tgen.generate_text_speculative(path, path, "Hello", 10, k=3, device="cpu") == want
    assert want == jgen.generate_text_speculative(path, path, "Hello", 10, k=3, temperature=0.0)
    assert "acceptance=" in capsys.readouterr().err
    assert tgen_cli.main(["--model_path", path, "--input_text", "Hello", "--max_new_tokens", "10",
                          "--temperature", "0", "--draft_model_path", path, "--spec_k", "3",
                          "--device", "cpu"]) == [want]
    moe_cfg = dataclasses.replace(tc, n_experts=2)
    with pytest.raises(ValueError, match="ragged prompt_lengths is unsupported for MoE"):
        tgen.generate(tt.init_params(moe_cfg, 0, device="cpu"), moe_cfg, np.zeros((2, 4), np.int64), 2, 0,
                      prompt_lengths=[4, 2])


def test_sampled_first_tokens_follow_the_softmax(models):
    """Temperature 1 with top-k 5 over 2048 copies of one prompt: the first
    sampled token of each package lies in the top 5 and its frequencies are
    within 0.06 total variation of softmax(top-5 logits)."""
    jc, tc, jp, tp = models["learned-mha"]
    n = 2048
    prompt = np.tile(np.random.default_rng(5).integers(0, 256, (1, 9)), (n, 1))
    logits, _ = jt.forward(jp, jnp.asarray(prompt[:1]), jc)
    last = np.asarray(logits[0, -1], np.float64)
    top = np.argsort(last)[::-1][:5]
    p = np.exp(last[top] - last[top].max())
    p /= p.sum()
    jtok = np.asarray(jgen.generate(jp, jc, jnp.asarray(prompt), 2, jax.random.key(1), temperature=1.0,
                                    top_k=5))[:, 0]
    ttok = tgen.generate(tp, tc, prompt, 2, 1, temperature=1.0, top_k=5).numpy()[:, 0]
    for toks in (jtok, ttok):
        assert np.isin(toks, top).all()
        freq = np.array([(toks == t).mean() for t in top])
        assert 0.5 * np.abs(freq - p).sum() <= 0.06, (freq, p)


def test_cast_params_for_inference_casts_the_jax_leaves():
    _, tc, _, _ = build("learned-mha")
    kw = dict(BASE, compute_dtype="bfloat16", tie_embeddings=False, lm_head_bias=True, qkv_bias=True)
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    npp = random_params(jc, 2, std=0.05)
    jcast = jax.tree_util.tree_flatten_with_path(jgen.cast_params_for_inference(jax.tree.map(jnp.asarray, npp), jc))[0]
    want = {jckpt._leaf_name(path): str(x.dtype) for path, x in jcast}
    tp = bridge.params_from_numpy(npp, tc, device="cpu")
    tcast = tgen.cast_params_for_inference(tp, tc)
    got = {"__".join(path): str(x.dtype).replace("torch.", "")
           for path, x in _flatten(tcast)}
    assert got == want
    assert "float32" in got.values() and "bfloat16" in got.values()
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 16)))
    a, _ = tt.forward(tp, toks, tc)
    b, _ = tt.forward(tcast, toks, tc)
    assert torch.equal(a, b)


def _flatten(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), v


# ---------------------------------------------------------------------------
# Checkpoints and the CLIs
# ---------------------------------------------------------------------------

CKPT_MODEL = dict(BASE, vocab_size=260)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX-written checkpoint (params and EMA) of a byte-tokenizer model,
    one without EMA, and a token file drawn from the same model's range."""
    root = tmp_path_factory.mktemp("gen")
    config = jcfg.Config(model=jcfg.ModelConfig(**CKPT_MODEL), data=jcfg.DataConfig(tokenizer_name="byte"),
                         train=jcfg.TrainConfig(batch_size=4))
    params = jax.tree.map(jnp.asarray, random_params(config.model, 3))
    extra = {"step": 5, "config": dataclasses.asdict(config)}
    with_ema = jckpt.save_checkpoint(str(root / "ema"), 5, {"params": params,
                                                          "ema": jax.tree.map(lambda x: 0.5 * x, params)},
                                     extra=extra)
    jckpt.save_checkpoint(str(root / "plain"), 5, {"params": params}, extra=extra)
    data = root / "val.bin"
    np.random.default_rng(0).integers(0, 64, 20_000).astype(np.uint16).tofile(data)
    return {"ema": with_ema, "plain": str(root / "plain"), "data": str(data), "params": params,
            "config": config}


def test_load_model_for_inference_reads_jax_checkpoints(jax_ckpt):
    params, cfg = tgen.load_model_for_inference(jax_ckpt["plain"], device="cpu")
    assert cfg.model == tcfg.ModelConfig(**CKPT_MODEL) and cfg.data.tokenizer_name == "byte"
    want = dict(_flatten(jax.tree.map(np.asarray, jax_ckpt["params"])))
    for path, x in _flatten(params):
        np.testing.assert_array_equal(x.numpy(), want[path])
    ema, _ = tgen.load_model_for_inference(jax_ckpt["ema"], use_ema=True, device="cpu")
    np.testing.assert_array_equal(ema["tok_embed"]["embedding"].numpy(),
                                  0.5 * want[("tok_embed", "embedding")])
    with pytest.raises(ValueError, match="no EMA shadow"):
        tgen.load_model_for_inference(jax_ckpt["plain"], use_ema=True, device="cpu")
    with pytest.raises(FileNotFoundError):
        tgen.load_model_for_inference(str(jax_ckpt["data"]) + ".missing", device="cpu")


def test_generate_text_from_jax_checkpoint_matches_jax(jax_ckpt):
    prompts = ["Hello", "ab", "The quick brown"]
    want = jgen.generate_text_batch(jax_ckpt["plain"], prompts, max_new_tokens=12, temperature=0.0)
    got = tgen.generate_text_batch(jax_ckpt["plain"], prompts, max_new_tokens=12, temperature=0.0, device="cpu")
    assert got == want
    single = tgen.generate_text(jax_ckpt["plain"], "Hello", max_new_tokens=12, temperature=0.0, device="cpu")
    assert single == jgen.generate_text(jax_ckpt["plain"], "Hello", max_new_tokens=12, temperature=0.0)
    # A stop token the first row emits cuts its text there.
    ids = [ord(c) for c in want[0][len("Hello"):]]
    stop = ids[3]
    cut = tgen.generate_text_batch(jax_ckpt["plain"], prompts, max_new_tokens=12, temperature=0.0,
                                   stop_token=stop, device="cpu")
    assert cut == jgen.generate_text_batch(jax_ckpt["plain"], prompts, max_new_tokens=12, temperature=0.0,
                                           stop_token=stop)
    assert cut[0] == "Hello" + "".join(map(chr, ids[:ids.index(stop)]))


def test_generate_text_cli_runs_on_cpu(jax_ckpt, tmp_path, capsys):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("Hello\nab\n\nThe quick brown\n")
    outs = tgen_cli.main(["--model_path", jax_ckpt["plain"], "--input_file", str(prompts), "--max_new_tokens",
                          "6", "--temperature", "0", "--device", "cpu"])
    assert outs == jgen.generate_text_batch(jax_ckpt["plain"], ["Hello", "ab", "The quick brown"],
                                            max_new_tokens=6, temperature=0.0)
    assert capsys.readouterr().out.count("---") == 3


def test_evaluate_cli_matches_jax_evaluate(jax_ckpt, capsys):
    from pretraining_llm_tpu.data import loader as jloader
    from pretraining_llm_tpu.training import train_step as jts

    rec = tevaluate.main(["--model_path", jax_ckpt["plain"], "--data", jax_ckpt["data"], "--iters", "3",
                          "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    # scripts/evaluate.py's computation, in process.
    params, cfg = jgen.load_model_for_inference(jax_ckpt["plain"])
    it = jloader.get_batch_iterator(jax_ckpt["data"], cfg.train.batch_size, cfg.model.context_length,
                                    seed=cfg.data.sample_seed + 104729)
    xs, ys = zip(*(next(it) for _ in range(3)))
    want = float(jts.build_eval_loop(cfg, mesh=None)({"params": params},
                                                     (jnp.asarray(np.stack(xs)), jnp.asarray(np.stack(ys)))))
    assert abs(rec["val_loss"] - want) <= 1e-5 * want
    assert rec["batch"] == 4 and rec["tokens_evaluated"] == 3 * 4 * 64
    assert abs(rec["val_ppl"] - np.exp(rec["val_loss"])) <= 1e-2 * rec["val_ppl"]


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["load_model_for_inference", "generate_text", "generate_text_cli",
                                   "evaluate_cli"])
def test_sample_and_evaluate_entry_points_default_to_the_gpu(no_gpu, jax_ckpt, entry):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "load_model_for_inference":
            tgen.load_model_for_inference(jax_ckpt["plain"])
        elif entry == "generate_text":
            tgen.generate_text(jax_ckpt["plain"], "Hello", 2)
        elif entry == "generate_text_cli":
            tgen_cli.main(["--model_path", jax_ckpt["plain"], "--input_text", "Hello"])
        else:
            tevaluate.main(["--model_path", jax_ckpt["plain"], "--data", jax_ckpt["data"], "--iters", "1"])
