"""Structural rules of the PyTorch port.

- No module of ``pretraining_llm_tpu_torch``, and not ``chip_smoke.py``,
  imports JAX or anything of the JAX package.
- Entry points run on the GPU unless the caller passes ``device="cpu"``:
  with no GPU they raise instead of falling back to the CPU.
- Options once refused as not yet ported run now, and raise the JAX
  package's ``ValueError`` on a bad value.
- Every kernel family has its CUDA source, built by ``ops/_build.py``; the
  host BPE encoder's C++ source is the port's own copy, built under
  ``build/``.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu_torch.config import ModelConfig, get_preset, list_presets
from pretraining_llm_tpu_torch.generation.serving import ServingEngine
from pretraining_llm_tpu_torch import train as train_cli
from pretraining_llm_tpu_torch.models import bridge, transformer
from pretraining_llm_tpu_torch.ops.flash_attention import flash_attention
from pretraining_llm_tpu_torch.ops.fused_ce import fused_cross_entropy
from pretraining_llm_tpu_torch.training import optimizer as opt
from pretraining_llm_tpu_torch.training import train_step
from pretraining_llm_tpu_torch.training.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
TINY = dataclasses.replace(get_preset("tiny").model, compute_dtype="float32")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "pretraining_llm_tpu")


def _port_sources():
    return sorted((ROOT / "pretraining_llm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


# Calls that load a module by name or by path, around an import statement.
_LOADERS = ("spec_from_file_location", "run_path", "run_module", "SourceFileLoader", "import_module", "load_source")


def _forbidden_loads(tree) -> list:
    """The string arguments of module loads by path or name that reach JAX,
    the JAX package or a file under ``scripts/`` (whose tools import the
    JAX package)."""
    bad = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", None)
        if name not in _LOADERS:
            continue
        for arg in [*node.args, *(k.value for k in node.keywords)]:
            for c in ast.walk(arg):
                if isinstance(c, ast.Constant) and isinstance(c.value, str) and (
                        _forbidden(c.value) or c.value == "scripts" or "scripts/" in c.value):
                    bad.append(f"{name}({c.value!r})")
    return bad


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = _forbidden_loads(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            bad += [a.value for a in node.args[:1]
                    if isinstance(a, ast.Constant) and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("src, caught", [
    ('spec = importlib.util.spec_from_file_location("r", ROOT / "scripts" / "obs_report.py")', True),
    ('runpy.run_path("scripts/obs_report.py")', True),
    ('importlib.import_module("pretraining_llm_tpu.observability.metrics")', True),
    ('importlib.import_module("jax.numpy")', True),
    ('importlib.import_module("pretraining_llm_tpu_torch.serve")', False),
    ('spec = importlib.util.spec_from_file_location("c", ROOT / "chip_smoke.py")', False),
])
def test_scan_sees_loads_by_path_and_name(src, caught):
    assert bool(_forbidden_loads(ast.parse(src))) is caught


def test_port_has_kernel_sources_for_both_kernels():
    """One source per ported kernel family, each built by ``ops/_build.py``."""
    from pretraining_llm_tpu_torch.ops import _build

    names = sorted(p.name for p in (ROOT / "pretraining_llm_tpu_torch" / "csrc").glob("*.cu"))
    assert names == ["flash_bwd.cu", "flash_bwd_tc.cu", "flash_fwd.cu", "flash_fwd_tc.cu", "fused_ce.cu",
                     "fused_ce_bwd_tc.cu", "fused_ce_tc.cu", "paged_decode.cu", "ragged_paged.cu",
                     "ragged_paged_tc.cu"]
    assert sorted(_build.SOURCES) == [n[:-3] for n in names]


def test_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    """A library is rebuilt when a header it may include (``csrc/*.cuh``)
    changes, not only its own source."""
    from pretraining_llm_tpu_torch.ops import _build

    for name in ("flash_fwd_tc.cu", "hopper.cuh"):
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("flash_fwd_tc")
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path("flash_fwd_tc") != before


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(TINY, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.make_paged_kv_pool(TINY, 4, 8)
    tree = bridge.params_to_numpy(transformer.init_params(TINY, 0, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.params_from_numpy(tree, TINY)
    params = transformer.init_params(TINY, 0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(params, TINY, n_blocks=4, block_size=8)


@pytest.mark.parametrize("entry", ["init_train_state", "Trainer", "cli"])
def test_training_entry_points_raise_without_gpu(no_gpu, tmp_path, entry):
    cfg = get_preset("tiny").with_overrides({"train.checkpoint_dir": str(tmp_path)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "init_train_state":
            train_step.init_train_state(cfg)
        elif entry == "Trainer":
            Trainer(cfg, synthetic_data=True, resume=False)
        else:
            train_cli.main(["--preset", "tiny", "--data", "synthetic", "--no-resume",
                            "--override", f"train.checkpoint_dir={tmp_path}"])


def test_flash_output_carries_the_function_grad_fn():
    """The flash path's output is the ``FlashAttention`` node, so a backward
    reaches the backward kernels (CUDA) or their plain version (CPU), never
    autograd through the plain forward."""
    q = torch.randn(1, 8, 4, 32, requires_grad=True)
    k = torch.randn(1, 8, 2, 32, requires_grad=True)
    v = torch.randn(1, 8, 2, 32, requires_grad=True)
    out = flash_attention(q, k, v)
    node = out.grad_fn
    while node is not None and "FlashAttention" not in type(node).__name__:
        node = node.next_functions[0][0]  # through the heads-last permute/reshape
    assert node is not None and type(node).__name__ == "FlashAttentionBackward"
    out.sum().backward()
    assert all(x.grad is not None and x.grad.abs().sum() > 0 for x in (q, k, v))


def test_fused_ce_output_carries_the_function_grad_fn():
    """The fused head's per-token losses are the ``FusedCE`` node, so a
    backward reaches the dH and dW kernels (CUDA) or their plain versions
    (CPU), never autograd through a plain forward."""
    h = torch.randn(16, 8, requires_grad=True)
    w = torch.randn(8, 40, requires_grad=True)
    loss = fused_cross_entropy(h, w, torch.randint(0, 40, (16,)))
    assert type(loss.grad_fn).__name__ == "FusedCEBackward"
    loss.mean().backward()
    assert all(x.grad is not None and x.grad.abs().sum() > 0 for x in (h, w))


def test_engine_refuses_params_on_another_device():
    params = transformer.init_params(TINY, 0, device="cpu")
    params = dict(params, tok_embed={"embedding": params["tok_embed"]["embedding"].to("meta")})
    with pytest.raises(ValueError, match="params lie on meta"):
        ServingEngine(params, TINY, n_blocks=4, block_size=8, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(spec_k=2), dict(mesh=None), dict(pipeline_depth=2), dict(admit_batch=4),
    dict(fused_sampling=False), dict(kv_checksum=True),
])
def test_unported_engine_options_raise(kw):
    """All six options were refused before they were ported; now each
    constructs, serves one tiny request (the pipelined scheduler, and the
    synchronous one for the unfused lane) to the greedy tokens of the
    default engine, and (but ``mesh``) raises the JAX engine's
    ``ValueError`` on a bad value. Sharded serving runs here on a mesh of
    one rank (meshes of several ranks:
    ``test_torch_parallel_inference.py``)."""
    params = transformer.init_params(TINY, 0, device="cpu")
    base = dict(n_blocks=8, block_size=8, device="cpu")
    name = next(iter(kw))
    if name == "mesh":
        import torch.distributed as dist

        from pretraining_llm_tpu_torch.parallel import mesh as pmesh

        want = ServingEngine(params, TINY, **base)
        want.submit([3, 1, 4, 1, 5], 4)
        mesh = pmesh.single_device_mesh("cpu")
        try:
            eng = ServingEngine(params, TINY, **base, mesh=mesh)
            assert eng.submit([3, 1, 4, 1, 5], 4) == 0
            assert eng.run() == want.run(pipeline=False)
        finally:
            dist.destroy_process_group()
        return
    extra = {"spec_k": dict(draft_params=params, draft_cfg=TINY), "kv_checksum": dict(prefix_cache=True),
             "admit_batch": dict(max_batch=2)}.get(name, {})
    bad = {"spec_k": (dict(spec_k=-1), "spec_k must be >= 0"),
           "pipeline_depth": (dict(pipeline_depth=0), "pipeline_depth must be >= 1"),
           "admit_batch": (dict(admit_batch=-1), "admit_batch must be >= 0"),
           "fused_sampling": (dict(fused_sampling=False, logprobs_k=2), "logprobs_k requires fused_sampling"),
           "kv_checksum": (dict(kv_checksum=True, prefix_cache=True, prefix_cache_min_blocks=0),
                           "min_blocks must be >= 1")}[name]
    prompt = [3, 1, 4, 1, 5]
    want = ServingEngine(params, TINY, **base)
    want.submit(prompt, 4)
    eng = ServingEngine(params, TINY, **base, **extra, **kw)
    assert eng.submit(prompt, 4) == 0
    assert eng.run(pipeline=name != "fused_sampling") == want.run(pipeline=False)
    with pytest.raises(ValueError, match=bad[1]):
        ServingEngine(params, TINY, **base, **dict(extra, **bad[0]))


@pytest.mark.parametrize("kw,name", [
    (dict(sequence_parallel=True), "sequence_parallel"),
    (dict(attention_impl="ring"), "ring"),
    (dict(attention_impl="ulysses"), "ulysses"),
])
def test_unported_model_options_raise(kw, name):
    """Ring and Ulysses attention, sequence parallelism and pipeline stages
    are ported (``parallel/``): on one process, with no seq or pipe axis,
    the model takes them and computes JAX's degenerate form, the plain
    model, bit for bit (a ``pipeline_stages`` = 2 config runs the plain
    layer loop, as JAX's scan does off a pipe mesh)."""
    cfg = dataclasses.replace(TINY, **kw)
    params = transformer.init_params(cfg, 0, device="cpu")
    tokens = torch.arange(8, dtype=torch.long)[None]
    got, _ = transformer.forward(params, tokens, cfg)
    want, _ = transformer.forward(params, tokens, dataclasses.replace(TINY, attention_impl="naive"))
    assert torch.equal(got, want), name
    piped, _ = transformer.forward(params, tokens, dataclasses.replace(TINY, pipeline_stages=2))
    plain, _ = transformer.forward(params, tokens, TINY)
    assert torch.equal(piped, plain)


@pytest.mark.parametrize("key,value,name", [
    ("train.optimizer", "adafactor", "adafactor"),
    ("train.optimizer", "muon", "muon"),
])
def test_unported_training_options_raise(key, value, name):
    """Adafactor and Muon were refused before they were ported; now a
    train step with either runs and updates the state in place: finite
    parameters, the same tensors (``data_ptr``) before and after, and the
    optimizer's state tree under the JAX package's names."""
    cfg = get_preset("tiny").with_overrides({key: value, "model.compute_dtype": "float32"})
    state = train_step.init_train_state(cfg, device="cpu")
    assert set(state["opt"]) == {"v" if name == "adafactor" else "s", "count"}
    moments = "v" if name == "adafactor" else "s"

    def ptrs(st):
        return [t.data_ptr() for _, t in opt.tree_leaves({"params": st["params"], "opt": st["opt"][moments]})]

    before_ptrs = ptrs(state)
    x = torch.randint(0, cfg.model.vocab_size, (cfg.train.batch_size, cfg.model.context_length))
    before = opt.tree_map(torch.clone, state["params"])
    state, metrics = train_step.build_train_step(cfg)(state, (x, x))
    assert int(state["opt"]["count"]) == 1 and torch.isfinite(metrics["loss"])
    assert ptrs(state) == before_ptrs
    moved = [not torch.equal(a, b) for (_, a), (_, b) in zip(opt.tree_leaves(before),
                                                               opt.tree_leaves(state["params"]))]
    assert any(moved) and all(torch.isfinite(t).all() for _, t in opt.tree_leaves(state["params"]))


def test_unported_forward_paths_raise():
    """A dense cache at a nonzero cache_index is ported: a chunk there
    gives the uncached forward's logits. A cached call of a
    ``pipeline_stages`` = 2 config (once refused) takes the plain layer
    loop, as JAX does with a cache: the cached plain model's logits and
    cache, bit for bit."""
    params = transformer.init_params(TINY, 0, device="cpu")
    cache = transformer.make_kv_cache(TINY, 1, 16, device="cpu")
    tokens = torch.arange(8, dtype=torch.long)[None]
    full, _ = transformer.forward(params, tokens, TINY)
    _, cache = transformer.forward(params, tokens[:, :4], TINY, kv_cache=cache, cache_index=0)
    chunk, _ = transformer.forward(params, tokens[:, 4:], TINY, kv_cache=cache, cache_index=4)
    torch.testing.assert_close(chunk, full[:, 4:], rtol=1e-4, atol=1e-4)
    # A cached call with ring attention takes the dense path, as in JAX.
    ring, _ = transformer.forward(params, tokens[:, 4:], dataclasses.replace(TINY, attention_impl="ring"),
                                  kv_cache=cache, cache_index=4)
    torch.testing.assert_close(ring, full[:, 4:], rtol=1e-4, atol=1e-4)
    piped_cache = {k: v.clone() for k, v in cache.items()}
    piped, piped_cache = transformer.forward(params, tokens[:, 4:], dataclasses.replace(TINY, pipeline_stages=2),
                                             kv_cache=piped_cache, cache_index=4)
    plain, cache = transformer.forward(params, tokens[:, 4:], TINY, kv_cache=cache, cache_index=4)
    assert torch.equal(piped, plain)
    assert all(torch.equal(piped_cache[k], cache[k]) for k in cache)


SAMPLE_EVAL_PREPROCESS_MODULES = (
    "generation/generate.py", "data/_native.py", "data/bpe.py", "data/native_bpe.py", "data/tokenizer.py",
    "data/preprocess.py", "generate_text.py", "evaluate.py", "data_preprocess.py",
)


def test_sample_evaluate_preprocess_modules_are_scanned():
    """The sample, evaluate and preprocess modules and their CLIs are among
    the sources that ``test_port_imports_nothing_of_jax`` scans, so none of
    them imports JAX or the JAX package (not even its JAX-free
    ``data/*.py``)."""
    scanned = {p.relative_to(ROOT / "pretraining_llm_tpu_torch").as_posix() for p in _port_sources()[:-1]}
    assert set(SAMPLE_EVAL_PREPROCESS_MODULES) <= scanned
    for rel in SAMPLE_EVAL_PREPROCESS_MODULES:
        text = (ROOT / "pretraining_llm_tpu_torch" / rel).read_text()
        assert "pretraining_llm_tpu." not in text.replace("pretraining_llm_tpu_torch.", ""), rel


SERVING_MODULES = (
    "generation/serving.py", "generation/paged.py", "generation/speculative.py", "generation/prefix_cache.py",
    "resilience/__init__.py", "resilience/integrity.py", "serve.py",
)


def test_serving_modules_are_scanned():
    """The pipelined engine, speculative decoding, the port's copy of the
    KV digests and the serve CLI are among the sources that
    ``test_port_imports_nothing_of_jax`` scans; none names a module of the
    JAX package."""
    scanned = {p.relative_to(ROOT / "pretraining_llm_tpu_torch").as_posix() for p in _port_sources()[:-1]}
    assert set(SERVING_MODULES) <= scanned
    for rel in SERVING_MODULES:
        text = (ROOT / "pretraining_llm_tpu_torch" / rel).read_text()
        assert "pretraining_llm_tpu." not in text.replace("pretraining_llm_tpu_torch.", ""), rel


FRONTEND_AND_TOOLING_MODULES = (
    "frontend/__init__.py", "frontend/admission.py", "frontend/engine_loop.py", "frontend/gateway.py",
    "frontend/loadgen.py", "observability/tracing.py", "observability/capacity.py", "observability/sketches.py",
    "observability/slo.py", "utils/safetensors.py", "import_hf_checkpoint.py", "export_hf_checkpoint.py",
    "import_torch_checkpoint.py", "export_torch_checkpoint.py",
)


def test_frontend_and_tooling_modules_are_scanned():
    """The online front end, the serving observability and the checkpoint
    converters are the port's own copies: scanned by
    ``test_port_imports_nothing_of_jax``, none naming a module of the JAX
    package, and none importing ``transformers`` or ``safetensors`` (the
    card's host has neither)."""
    scanned = {p.relative_to(ROOT / "pretraining_llm_tpu_torch").as_posix() for p in _port_sources()[:-1]}
    assert set(FRONTEND_AND_TOOLING_MODULES) <= scanned
    for rel in FRONTEND_AND_TOOLING_MODULES:
        path = ROOT / "pretraining_llm_tpu_torch" / rel
        text = path.read_text()
        assert "pretraining_llm_tpu." not in text.replace("pretraining_llm_tpu_torch.", ""), rel
        for node in ast.walk(ast.parse(text)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
            assert not any(n.split(".")[0] in ("transformers", "safetensors") for n in names), (rel, names)


def test_bpe_build_writes_only_under_build(tmp_path, monkeypatch):
    """The native BPE library is built from the port's own copy of the
    source (``csrc/bpe.cpp``) into ``build/native/``, never into the repo's
    ``native/`` or the package."""
    from pretraining_llm_tpu_torch.data import _native, native_bpe

    assert _native.BUILD_DIR == ROOT / "build" / "native"
    assert _native.library_path("bpe").parent == ROOT / "build" / "native"

    def listing():
        return sorted(str(p) for d in (ROOT / "native", ROOT / "pretraining_llm_tpu_torch")
                      for p in d.rglob("*") if "__pycache__" not in p.parts)

    before = listing()
    build_dir = tmp_path / "build" / "native"
    monkeypatch.setattr(_native, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_native, "_cache", {})
    lib, why = native_bpe.load_library()
    assert lib is not None, why
    assert why.startswith("native (libbpe-")
    assert [p.name for p in build_dir.iterdir() if not p.name.startswith(".")] == [
        _native.library_path("bpe").name]
    assert listing() == before


PORT_PRESETS = ("gpt2-124m", "gpt2-1p3b-fsdp", "gpt2-350m-dp", "gpt2-8k-gqa", "gpt2-8k-sp", "llama-1b",
                "llama3-1b-gqa", "moe-8x350m", "reference-3b", "tiny")


def test_presets_and_config_validation():
    """The port registers every preset of the JAX package, MoE's and the
    two 8k ring attention presets included."""
    assert tuple(list_presets()) == PORT_PRESETS
    gpt2 = get_preset("gpt2-124m").model
    assert (gpt2.vocab_size, gpt2.d_model, gpt2.n_heads, gpt2.head_dim, gpt2.n_layers) == (50304, 768, 12, 64, 12)
    assert gpt2.attention_impl == "flash" and gpt2.tie_embeddings and gpt2.qkv_bias
    llama = get_preset("llama3-1b-gqa").model
    assert (llama.kv_heads, llama.d_ff, llama.norm) == (4, 5504, "rmsnorm")
    with pytest.raises(KeyError):
        get_preset("nope")
    with pytest.raises(ValueError, match="paged_attention_impl"):
        ModelConfig(paged_attention_impl="fast")
    with pytest.raises(ValueError, match="n_kv_heads"):
        ModelConfig(n_heads=12, n_kv_heads=5)
    assert np.isclose(gpt2.num_params(), 124_475_904)


def test_moe_module_is_scanned():
    """``models/moe.py`` is among the sources that
    ``test_port_imports_nothing_of_jax`` scans and names no module of the
    JAX package; the model takes MoE configs (a MoE preset's forward
    runs)."""
    scanned = {p.relative_to(ROOT / "pretraining_llm_tpu_torch").as_posix() for p in _port_sources()[:-1]}
    assert "models/moe.py" in scanned
    text = (ROOT / "pretraining_llm_tpu_torch" / "models" / "moe.py").read_text()
    assert "pretraining_llm_tpu." not in text.replace("pretraining_llm_tpu_torch.", "")
    cfg = dataclasses.replace(get_preset("moe-8x350m").model, n_layers=1, d_model=32, n_heads=2, mlp_ratio=1.0,
                              vocab_size=64, context_length=16, compute_dtype="float32")
    logits, _ = transformer.forward(transformer.init_params(cfg, 0, device="cpu"),
                                    torch.zeros((1, 8), dtype=torch.long), cfg)
    assert logits.shape == (1, 8, 64) and torch.isfinite(logits).all()


RESILIENCE_OBSERVABILITY_MODULES = (
    "resilience/anomaly.py", "resilience/rollback.py", "resilience/watchdog.py", "resilience/faults.py",
    "observability/__init__.py", "observability/events.py", "observability/spans.py", "observability/goodput.py",
    "observability/export.py", "observability/metrics.py", "observability/device.py", "observability/hub.py",
    "data/native_batcher.py", "supervisor.py",
)


def test_resilience_and_observability_modules_are_scanned():
    """The resilience loop, the observability hub, the native batcher and
    the supervisor are among the sources that
    ``test_port_imports_nothing_of_jax`` scans and name no module of the
    JAX package; the supervisor starts without torch (it must come up
    while the training stack is wedged)."""
    import subprocess
    import sys

    scanned = {p.relative_to(ROOT / "pretraining_llm_tpu_torch").as_posix() for p in _port_sources()[:-1]}
    assert set(RESILIENCE_OBSERVABILITY_MODULES) <= scanned
    for rel in RESILIENCE_OBSERVABILITY_MODULES:
        text = (ROOT / "pretraining_llm_tpu_torch" / rel).read_text()
        assert "pretraining_llm_tpu." not in text.replace("pretraining_llm_tpu_torch.", ""), rel
    code = "import sys, pretraining_llm_tpu_torch.supervisor; assert 'torch' not in sys.modules, 'torch'"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


FLEET_AND_TOOL_MODULES = (
    "obs_report.py", "frontend/journal.py", "frontend/kv_transfer.py", "frontend/replica.py", "frontend/router.py",
    "frontend/loadgen.py", "frontend/__init__.py", "resilience/faults.py", "resilience/integrity.py",
    "generation/serving.py", "serve.py", "train.py", "frontend/wire.py", "frontend/worker.py",
    "frontend/remote_replica.py", "observability/clocksync.py",
)


def test_fleet_and_tool_modules_are_scanned():
    """The fleet in one process (router, replicas, journal, KV transfer, the
    serving faults and golden probes), its process replicas (wire, worker,
    remote replica, clock sync), the analyzer and ``train
    --compile-only`` are among the sources that
    ``test_port_imports_nothing_of_jax`` scans; none names a module of the
    JAX package, and the analyzer imports neither torch nor numpy (it runs
    where the training stack does not)."""
    import subprocess
    import sys

    scanned = {p.relative_to(ROOT / "pretraining_llm_tpu_torch").as_posix() for p in _port_sources()[:-1]}
    assert set(FLEET_AND_TOOL_MODULES) <= scanned
    for rel in FLEET_AND_TOOL_MODULES:
        text = (ROOT / "pretraining_llm_tpu_torch" / rel).read_text()
        assert "pretraining_llm_tpu." not in text.replace("pretraining_llm_tpu_torch.", ""), rel
    code = ("import sys, pretraining_llm_tpu_torch.obs_report\n"
            "assert not {'torch', 'numpy', 'jax'} & set(sys.modules), sorted({'torch', 'numpy', 'jax'} & set(sys.modules))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    from pretraining_llm_tpu_torch import frontend

    assert {"Router", "RouterRequest", "Replica", "ReplicaUnavailable", "FleetAction", "rolling_restart_plan",
            "run_fleet_plan", "RemoteReplica", "encode_frame", "send_frame", "recv_frame",
            "ConnectionLost", "ProtocolError", "PROTO_VERSION", "MAX_FRAME_BYTES"} <= set(dir(frontend))
    # A process replica spawns the port's worker, never the JAX package's.
    text = (ROOT / "pretraining_llm_tpu_torch" / "frontend" / "remote_replica.py").read_text()
    assert '"pretraining_llm_tpu_torch.frontend.worker"' in text


PARALLEL_MODULES = ("parallel/__init__.py", "parallel/mesh.py", "parallel/sharding.py", "parallel/zigzag.py",
                    "parallel/ring_attention.py", "parallel/ulysses.py", "parallel/tensor.py", "parallel/pipeline.py")


@pytest.mark.parametrize("helper", ["_torch_ranks.py", "_torch_parallel_cases.py", "_torch_threads.py",
                                    "_torch_pipeline_cases.py"])
def test_parallel_modules_and_rank_helpers_are_scanned(helper):
    """The parallelism modules (``parallel/tensor.py`` among them) are
    among the sources that ``test_port_imports_nothing_of_jax`` scans; the
    gloo ranks of the multi-rank tests run modules that import nothing of
    JAX either (the cases of the tensor, expert, inference and checkpoint
    tests included, and the pipeline's). No axis is left unported: the
    mesh module has no list of unported axes any more."""
    from pretraining_llm_tpu_torch.parallel import mesh as pmesh

    scanned = {p.relative_to(ROOT / "pretraining_llm_tpu_torch").as_posix() for p in _port_sources()[:-1]}
    assert set(PARALLEL_MODULES) <= scanned
    assert not hasattr(pmesh, "UNPORTED_AXES") and not hasattr(pmesh, "check_ported_axes")
    test_port_imports_nothing_of_jax(ROOT / "tests" / helper)
