"""The port's mixture-of-experts MLP against the JAX package's.

``models/moe.py`` (index gathers in place of the one-hot dispatch and
combine einsums) and the MoE paths through the transformer, loss, train
step, checkpoints, remat and ``generate``, on the CPU at 2 layers, d 64,
4 experts, T 32, with the JAX tree (seeded numpy noise) carried into the
port by ``models/bridge.py``. Mirrors ``tests/test_moe.py`` where it
applies. Tolerances (fp32): MoE outputs and logits 1e-5 of the largest
|value|, aux and loss 1e-5 relative, every gradient leaf 1e-5 of its
largest |g| (summation order: the JAX one-hot einsums add zeros and the
kept terms in expert order, the port its k terms in choice order), the
optimizer steps as ``test_torch_port_training.py`` (parameters 1e-5
max-abs, the optimizer state 1e-5 of each leaf's largest |value|), the
loss and aux over several AdamW steps 1e-5 relative; routing decisions,
remat gradients, checkpoint leaves and greedy tokens exactly.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.generation import serving as jserving
from pretraining_llm_tpu.generation import speculative as jspec
from pretraining_llm_tpu.models import moe as jmoe
from pretraining_llm_tpu.models import quantize as jquant
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu.training import checkpoint as jckpt
from pretraining_llm_tpu.training import optimizer as jopt
from pretraining_llm_tpu.training import train_step as jts
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch.generation import generate as tgen
from pretraining_llm_tpu_torch.generation import serving as tserving
from pretraining_llm_tpu_torch.generation import speculative as tspec
from pretraining_llm_tpu_torch.models import bridge, moe
from pretraining_llm_tpu_torch.models import quantize as tquant
from pretraining_llm_tpu_torch.models import transformer as ttf
from pretraining_llm_tpu_torch.ops import remat
from pretraining_llm_tpu_torch.training import checkpoint as tckpt
from pretraining_llm_tpu_torch.training import optimizer as topt
from pretraining_llm_tpu_torch.training import train_step as tts

jgen = importlib.import_module("pretraining_llm_tpu.generation.generate")

MODEL = dict(
    vocab_size=97, context_length=32, d_model=64, n_heads=4, n_layers=2,
    activation="gelu", norm="layernorm", pos_embed="learned", tie_embeddings=True,
    qkv_bias=True, mlp_bias=True, compute_dtype="float32", attention_impl="flash",
    n_experts=4, experts_per_token=2, moe_group_size=64,
)
BATCH = 4  # 4 x 32 = 128 tokens: 2 routing groups of 64
RTOL = 1e-5
PARAM_TOL = 1e-5  # max-abs after a step, as test_torch_port_training.py: Adam's g / sqrt(v) magnifies a
                  # gradient's last bits where |g| is near eps
MLP_FLAVOURS = {
    "gelu-bias": dict(activation="gelu", mlp_bias=True),
    "relu": dict(activation="relu", mlp_bias=False),
    "swiglu": dict(activation="swiglu", mlp_bias=False),
    "swiglu-bias": dict(activation="swiglu", mlp_bias=True),
}


def _configs(**kw):
    m = dict(MODEL, **kw)
    return jcfg.ModelConfig(**m), tcfg.ModelConfig(**m)


def _tree(jc, seed=0, std=0.05):
    layout = jax.eval_shape(functools.partial(jtf.init_params, jc), jax.random.key(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: ((1.0 if p[-1].key == "scale" else 0.0) + rng.normal(0, std, s.shape)).astype(np.float32),
        layout)


def _tokens(seed, b=BATCH, t=MODEL["context_length"] + 1):
    return np.random.default_rng(seed).integers(0, MODEL["vocab_size"], (b, t)).astype(np.int32)


def _flat(tree):
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        return {"/".join(p): t.detach().numpy() for p, t in topt.tree_leaves(tree)}
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x, np.float32)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_close(want_tree, got_tree, what, rtol=RTOL):
    want, got = _flat(want_tree), _flat(got_tree)
    assert want.keys() == got.keys(), what
    for name in want:
        tol = max(rtol * float(np.abs(want[name]).max()), 1e-7)
        assert float(np.abs(want[name] - got[name]).max()) <= tol, (what, name)


def _layer0_mlp(tree):
    return jax.tree.map(lambda a: a[0], tree["blocks"]["mlp"])


@functools.partial(jax.jit, static_argnames=("cfg", "decode"))
def _jax_moe(mlp, h, *, cfg, decode=False):
    return jmoe.moe_mlp(mlp, h, cfg, decode=decode)


@functools.partial(jax.jit, static_argnames=("cfg", "capacity"))
def _jax_dispatch(logits, *, cfg, capacity):
    return jax.vmap(lambda lg: jmoe.route(lg, cfg, capacity)[0])(logits)


@functools.partial(jax.jit, static_argnames=("cfg", "include_aux"))
def _jax_loss_grads(params, x, y, *, cfg, include_aux=True):
    return jax.value_and_grad(lambda p: jtf.loss_fn(p, x, y, cfg, include_aux=include_aux))(params)


def _port_dispatch(r, n_experts, capacity):
    """(G, S, E, C) 0/1 dispatch of the port's routing decisions, the JAX
    ``route``'s first output."""
    g, s, _ = r.idx.shape
    out = torch.zeros((g, s, n_experts, capacity))
    gi, si, ki = torch.nonzero(r.keep, as_tuple=True)
    out[gi, si, r.idx[gi, si, ki], r.pos[gi, si, ki]] = 1.0
    return out


@pytest.mark.parametrize("flavour", sorted(MLP_FLAVOURS))
def test_moe_mlp_matches_jax(flavour):
    """``moe_mlp``'s output and aux loss equal JAX's for each expert FFN
    form (gelu with biases, relu, SwiGLU with and without biases)."""
    jc, tc = _configs(**MLP_FLAVOURS[flavour])
    tree = _tree(jc, 1)
    h = np.random.default_rng(2).normal(size=(BATCH, 32, 64)).astype(np.float32)
    want_y, want_aux = _jax_moe(_layer0_mlp(tree), jnp.asarray(h), cfg=jc)
    params = bridge.params_from_numpy(tree, tc, device="cpu")
    y, aux = moe.moe_mlp(ttf._layer(params["blocks"], 0)["mlp"], torch.from_numpy(h), tc)
    want_y = np.asarray(want_y)
    assert y.shape == want_y.shape and y.dtype == torch.float32
    assert float(np.abs(y.numpy() - want_y).max()) <= RTOL * float(np.abs(want_y).max())
    assert abs(float(aux) - float(want_aux)) <= RTOL * abs(float(want_aux))


@pytest.mark.parametrize("factor,group_size", [(1.25, 0), (0.05, 0), (1.25, 32), (0.05, 48), (8.0, 48)])
def test_dispatch_decisions_match_jax(factor, group_size):
    """Every kept or dropped (token, choice) and its capacity position equal
    JAX's, under ample and starved capacity (``expert_capacity_factor``
    0.05) and at ``moe_group_size`` 0 (one group), a divisor (32: 4 groups
    of the 128 tokens) and a non-divisor (48: 2 groups)."""
    jc, tc = _configs(expert_capacity_factor=factor, moe_group_size=group_size)
    n = BATCH * 32
    g = moe._group_count(n, group_size)
    assert g == jmoe._group_count(n, group_size) == {0: 1, 32: 4, 48: 2}[group_size]
    capacity = moe.expert_capacity(tc, n // g)
    assert capacity == jmoe.expert_capacity(jc, n // g)
    logits = np.random.default_rng(3).normal(size=(g, n // g, 4)).astype(np.float32)
    want = np.asarray(_jax_dispatch(jnp.asarray(logits), cfg=jc, capacity=capacity))
    r = moe.route(torch.from_numpy(logits), tc, capacity)
    np.testing.assert_array_equal(_port_dispatch(r, 4, capacity).numpy(), want)
    dropped = int((~r.keep).sum())
    assert dropped > 0 if factor < 1.0 else factor < 4.0 or dropped == 0  # 8.0: room for every choice


def test_top_k_ties_take_the_lower_expert():
    """Duplicated router columns give equal probabilities: both packages
    pick the lower expert index first (``jax.lax.top_k``'s order; the
    port's stable descending sort), so the decisions and outputs agree."""
    jc, tc = _configs()
    tree = _tree(jc, 4)
    router = tree["blocks"]["mlp"]["router"]
    router[..., 1] = router[..., 0]
    router[..., 3] = router[..., 2]
    h = np.random.default_rng(5).normal(size=(BATCH, 32, 64)).astype(np.float32)
    logits = h.reshape(2, 64, 64) @ router[0]
    capacity = moe.expert_capacity(tc, 64)
    want = np.asarray(_jax_dispatch(jnp.asarray(logits), cfg=jc, capacity=capacity))
    r = moe.route(torch.from_numpy(logits), tc, capacity)
    assert bool((r.idx[..., 0] % 2 == 0).all())  # of each tied pair, the lower index first
    np.testing.assert_array_equal(_port_dispatch(r, 4, capacity).numpy(), want)
    want_y, _ = _jax_moe(_layer0_mlp(tree), jnp.asarray(h), cfg=jc)
    y, _ = moe.moe_mlp(ttf._layer(bridge.params_from_numpy(tree, tc, device="cpu")["blocks"], 0)["mlp"],
                       torch.from_numpy(h), tc)
    assert float(np.abs(y.numpy() - np.asarray(want_y)).max()) <= RTOL * float(np.abs(want_y).max())


def test_decode_routing_ignores_cobatched_rows():
    """``decode=True`` routes without capacity in one group: at a capacity
    factor that drops most choices in a grouped call, a row's output is the
    same alone as beside 7 other rows, and equals JAX's."""
    jc, tc = _configs(expert_capacity_factor=0.05)
    tree = _tree(jc, 6)
    mlp = ttf._layer(bridge.params_from_numpy(tree, tc, device="cpu")["blocks"], 0)["mlp"]
    h = np.random.default_rng(7).normal(size=(8, 1, 64)).astype(np.float32)
    batch, _ = moe.moe_mlp(mlp, torch.from_numpy(h), tc, decode=True)
    alone, _ = moe.moe_mlp(mlp, torch.from_numpy(h[:1]), tc, decode=True)
    scale = float(batch.abs().max())
    assert float((alone - batch[:1]).abs().max()) <= RTOL * scale  # the products' blocking may differ
    want, _ = _jax_moe(_layer0_mlp(tree), jnp.asarray(h), cfg=jc, decode=True)
    assert float(np.abs(batch.numpy() - np.asarray(want)).max()) <= RTOL * float(np.abs(want).max())


@pytest.mark.parametrize("include_aux", [True, False])
def test_loss_and_gradients_match_jax(include_aux):
    """``loss_fn`` with the router term (training) and without it (eval:
    pure cross-entropy, equal to the dense head's loss on the same hidden
    states), and the gradient of every leaf against ``jax.grad``."""
    jc, tc = _configs()
    tree = _tree(jc, 8)
    toks = _tokens(9)
    x, y = toks[:, :-1], toks[:, 1:]
    want_loss, want_grads = _jax_loss_grads(tree, x, y, cfg=jc, include_aux=include_aux)
    params = bridge.params_from_numpy(tree, tc, device="cpu")
    leaves = topt.tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    loss = ttf.loss_fn(leaves, torch.from_numpy(x), torch.from_numpy(y), tc, include_aux=include_aux)
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(want_loss)) <= RTOL * abs(float(want_loss))
    _, _, aux = ttf.forward(params, torch.from_numpy(x), tc, return_aux=True)
    pure = ttf.loss_fn(params, torch.from_numpy(x), torch.from_numpy(y), tc, include_aux=False)
    gap = float(loss) - float(pure)
    assert abs(gap - (tc.router_aux_coef * float(aux) if include_aux else 0.0)) <= 1e-6
    _assert_close(want_grads, topt.tree_map(lambda p: p.grad, leaves), "grads")


def test_forward_logits_and_aux_match_jax():
    jc, tc = _configs(activation="swiglu", mlp_bias=False)
    tree = _tree(jc, 10)
    x = _tokens(11)[:, :-1]
    want_logits, _, want_aux = jax.jit(functools.partial(jtf.forward, cfg=jc, return_aux=True))(tree, x)
    logits, _, aux = ttf.forward(bridge.params_from_numpy(tree, tc, device="cpu"), torch.from_numpy(x), tc,
                                 return_aux=True)
    assert float(np.abs(logits.numpy() - np.asarray(want_logits)).max()) <= RTOL * float(
        np.abs(want_logits).max())
    assert abs(float(aux) - float(want_aux)) <= RTOL * abs(float(want_aux))


def _train_configs(optimizer):
    # No QKV bias: the key bias's gradient is noise around 0, which AdamW
    # turns into +-lr (ROADMAP Queue C, settled differences).
    jc, tc = _configs(qkv_bias=False)
    train = dict(batch_size=BATCH, lr=1e-3, warmup_frac=0.0, lr_schedule="warmup_constant", optimizer=optimizer,
                 grad_clip=1.0)
    return (jcfg.Config(model=jc, train=jcfg.TrainConfig(**train)),
            tcfg.Config(model=tc, train=tcfg.TrainConfig(**train)))


@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
def test_one_optimizer_step_matches_jax(optimizer):
    """One train step (loss with the router term, clip, AdamW or Muon, whose
    matrix view takes the expert axis as a batch axis) from the same
    params: the loss, every parameter and every optimizer state leaf equal
    JAX's."""
    jc, tc = _train_configs(optimizer)
    tree = _tree(jc.model, 12)
    params = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": params, "opt": jopt.optimizer_init(params, jc.train), "step": jnp.zeros((), jnp.int32)}
    toks = _tokens(13)
    x, y = toks[:, :-1], toks[:, 1:]
    jstate, jm = jts.build_train_step(jc)(jstate, (jnp.asarray(x), jnp.asarray(y)))
    tparams = bridge.params_from_numpy(tree, tc.model, device="cpu")
    state = {"params": tparams, "opt": topt.optimizer_init(tparams, tc.train),
             "step": torch.zeros((), dtype=torch.int32)}
    state, tm = tts.build_train_step(tc)(state, (torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= RTOL * float(jm["loss"])
    want, got = _flat(jax.device_get(jstate["params"])), _flat(state["params"])
    assert want.keys() == got.keys()
    for name in want:
        assert float(np.abs(want[name] - got[name]).max()) <= PARAM_TOL, name
    key = "s" if optimizer == "muon" else "mu"
    _assert_close(jax.device_get(jstate["opt"][key]), state["opt"][key], f"{optimizer} state")


TRAJECTORY_STEPS = 8
PRESET_MOE = ("n_experts", "experts_per_token", "expert_capacity_factor", "moe_group_size", "router_aux_coef")
PRESET_TRAIN = ("lr", "lr_schedule", "warmup_frac", "min_lr_frac", "weight_decay", "grad_clip")


def _trajectories():
    """(JAX, port) lists of (loss, aux) at each of TRAJECTORY_STEPS AdamW
    steps from one tree, on fresh uniform random tokens each step as the
    trainer's synthetic batches: the train step's loss (cross-entropy plus
    ``router_aux_coef`` times aux) and the aux term of an uncached forward
    of that step's batch before the step. moe-8x350m's routing (8 experts,
    top-2, capacity factor 1.25, groups of 2048 tokens: one group of 128
    here, router_aux_coef 0.01) and optimizer (its lr, warmup-cosine over
    the run, weight decay, clip) at the file's small widths."""
    preset = jcfg.get_preset("moe-8x350m")
    jc, tc = _configs(qkv_bias=False, **{f: getattr(preset.model, f) for f in PRESET_MOE})
    train = dict(batch_size=BATCH, train_steps=TRAJECTORY_STEPS, optimizer="adamw",
                 **{f: getattr(preset.train, f) for f in PRESET_TRAIN})
    jc = jcfg.Config(model=jc, train=jcfg.TrainConfig(**train))
    tc = tcfg.Config(model=tc, train=tcfg.TrainConfig(**train))
    tree = _tree(jc.model, 30)
    params = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": params, "opt": jopt.optimizer_init(params, jc.train), "step": jnp.zeros((), jnp.int32)}
    tparams = bridge.params_from_numpy(tree, tc.model, device="cpu")
    state = {"params": tparams, "opt": topt.optimizer_init(tparams, tc.train),
             "step": torch.zeros((), dtype=torch.int32)}
    jstep, tstep = jts.build_train_step(jc), tts.build_train_step(tc)
    jforward = jax.jit(functools.partial(jtf.forward, cfg=jc.model, return_aux=True))
    want, got = [], []
    for step in range(TRAJECTORY_STEPS):
        toks = _tokens(31 + step)
        x, y = toks[:, :-1], toks[:, 1:]
        want_aux = float(jforward(jstate["params"], jnp.asarray(x))[2])
        with torch.no_grad():
            aux = float(ttf.forward(state["params"], torch.from_numpy(x), tc.model, return_aux=True)[2])
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        state, tm = tstep(state, (torch.from_numpy(x), torch.from_numpy(y)))
        want.append((float(jm["loss"]), want_aux))
        got.append((float(tm["loss"]), aux))
    return want, got


def test_adamw_trajectory_matches_jax():
    """Several AdamW steps at moe-8x350m's routing and optimizer settings:
    the loss and the router's aux term at every step equal JAX's within
    RTOL, so a fault in the aux gradient that builds up over steps shows."""
    want, got = _trajectories()
    for step, ((want_loss, want_aux), (loss, aux)) in enumerate(zip(want, got)):
        assert abs(loss - want_loss) <= RTOL * abs(want_loss), (step, want, got)
        assert abs(aux - want_aux) <= RTOL * abs(want_aux), (step, want, got)


@pytest.mark.parametrize("policy", [p for p in remat.POLICIES if p != "none"])
def test_remat_policies_give_none_gradients_bit_for_bit(policy):
    """Each remat policy wraps a layer body that returns (x, aux): its
    gradients equal ``none``'s bit for bit, the expert hidden tagged
    "mlp_hidden" as in the dense MLP."""
    _, tc = _configs(activation="swiglu", mlp_bias=True)
    params = ttf.init_params(tc, 14, device="cpu")
    toks = torch.from_numpy(_tokens(15).astype(np.int64))

    def grads(cfg):
        leaves = topt.tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
        ttf.loss_fn(leaves, toks[:, :-1], toks[:, 1:], cfg).backward()
        return {"/".join(p): t.grad for p, t in topt.tree_leaves(leaves)}

    want, got = grads(tc), grads(dataclasses.replace(tc, remat=policy))
    assert want.keys() == got.keys()
    for name in want:
        assert torch.equal(want[name], got[name]), name


def test_checkpoint_round_trips_with_jax(tmp_path):
    """A port train state of a MoE model (router and expert stacks)
    restores in JAX leaf for leaf, and JAX writes it back to the port."""
    jc, tc = _train_configs("adamw")
    state = tts.init_train_state(tc, 16, device="cpu")
    toks = _tokens(17)
    state, _ = tts.build_train_step(tc)(state, (torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:])))
    path = tckpt.save_checkpoint(str(tmp_path / "port"), 1, state)
    template = jax.eval_shape(lambda: jts.init_train_state(jc, jax.random.key(0)))
    jstate, _ = jckpt.load_checkpoint(path, template)
    assert set(jstate["params"]["blocks"]["mlp"]) == {"router", "experts"}
    want = {k: v for k, v in _flat(state).items()}
    got = _flat(jstate)
    assert want.keys() == got.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    back_path = jckpt.save_checkpoint(str(tmp_path / "jax"), 1, jstate)
    back, _ = tckpt.load_checkpoint(back_path, tts.init_train_state(tc, 0, device="cpu"))
    for name, value in _flat(back).items():
        np.testing.assert_array_equal(value, want[name], err_msg=name)


def test_greedy_generate_matches_jax():
    """Greedy ``generate`` of a MoE model (prefill routed in groups with
    capacity over the unpadded prompt, decode steps without capacity)
    gives JAX's tokens; ``cast_params_for_inference`` keeps the router in
    fp32, as JAX's does."""
    jc, tc = _configs(moe_group_size=16, expert_capacity_factor=0.5)
    tree = _tree(jc, 18, std=0.3)
    prompt = _tokens(19, b=3, t=11)
    want = np.asarray(jgen.generate(tree, jc, jnp.asarray(prompt), 12, jax.random.key(0), temperature=0.0))
    params = bridge.params_from_numpy(tree, tc, device="cpu")
    got = tgen.generate(params, tc, prompt, 12, 0, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    cast = bridge.cast_params_for_inference(params, dataclasses.replace(tc, compute_dtype="bfloat16"))
    assert cast["blocks"]["mlp"]["router"].dtype == torch.float32
    assert cast["blocks"]["mlp"]["experts"]["w1"].dtype == torch.bfloat16


def test_speculative_moe_target_matches_jax():
    """A MoE target verifies each round's k + 1 tokens with capacity routing
    in groups, as JAX's does: greedy ``generate_speculative`` with a dense
    draft gives JAX's tokens and round statistics."""
    jc, tc = _configs(moe_group_size=4, expert_capacity_factor=0.5)
    jd, td = _configs(n_experts=0, n_layers=1)
    tree, draft = _tree(jc, 22, std=0.3), _tree(jd, 23, std=0.3)
    prompt = _tokens(24, b=1, t=7)
    want, want_stats = jspec.generate_speculative(tree, jc, draft, jd, jnp.asarray(prompt), 10, jax.random.key(0),
                                                  k=3, temperature=0.0)
    got, stats = tspec.generate_speculative(bridge.params_from_numpy(tree, tc, device="cpu"), tc,
                                            bridge.params_from_numpy(draft, td, device="cpu"), td, prompt, 10, 0,
                                            k=3, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert {k: int(v) for k, v in want_stats.items()} == stats


def test_moe_refusals_match_jax():
    """Ragged ``prompt_lengths``, paged serving and int8 weight quantization
    refuse a MoE model with JAX's types and messages."""
    jc, tc = _configs()
    tree = _tree(jc, 20)
    params = bridge.params_from_numpy(tree, tc, device="cpu")
    prompt = _tokens(21, b=2, t=6)
    calls = [
        (lambda: jgen.generate(tree, jc, jnp.asarray(prompt), 2, jax.random.key(0), prompt_lengths=[6, 4]),
         lambda: tgen.generate(params, tc, prompt, 2, 0, prompt_lengths=[6, 4])),
        (lambda: jserving.ServingEngine(tree, jc),
         lambda: tserving.ServingEngine(params, tc, device="cpu")),
        (lambda: jquant.quantize_params_for_serving(tree, jc),
         lambda: tquant.quantize_params_for_serving(params, tc)),
    ]
    for jax_call, port_call in calls:
        with pytest.raises(ValueError) as want:
            jax_call()
        with pytest.raises(ValueError) as got:
            port_call()
        assert str(got.value) == str(want.value)
