"""The port's presets against the JAX package's.

Each preset the port registers equals the JAX preset of the same name, field
for field, in its model, mesh and train sections.
A copy of each of the presets added for single-device training
(gpt2-350m-dp, gpt2-1p3b-fsdp, llama-1b, reference-3b, moe-8x350m), shrunk
to 2 layers and narrow widths but keeping its own activation, norm,
positions, output projection, tying, biases, experts and remat policy, gives the JAX logits, loss and
gradients from the same weights (the JAX tree with seeded numpy noise,
through ``models/bridge.py``). Tolerances (fp32): logits 1e-4 max-abs, loss
1e-5 relative, gradients 1e-4 of each leaf's largest |g| (summation order),
as ``test_torch_port_training.py``.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)
from pretraining_llm_tpu import config as jcfg
from pretraining_llm_tpu.models import transformer as jtf
from pretraining_llm_tpu_torch import config as tcfg
from pretraining_llm_tpu_torch.models import bridge
from pretraining_llm_tpu_torch.models import transformer as ttf
from pretraining_llm_tpu_torch.training import optimizer as topt

NEW_PRESETS = ("gpt2-350m-dp", "gpt2-1p3b-fsdp", "llama-1b", "reference-3b", "moe-8x350m")
SHRINK = dict(vocab_size=97, context_length=32, d_model=32, n_heads=4, n_layers=2, compute_dtype="float32")
LOGITS_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.mark.parametrize("name", tcfg.list_presets())
def test_preset_equals_jax_preset(name):
    port, ref = tcfg.get_preset(name), jcfg.get_preset(name)
    assert port.name == ref.name == name
    for section in ("model", "mesh", "data", "train"):
        assert dataclasses.asdict(getattr(port, section)) == dataclasses.asdict(getattr(ref, section)), section
    assert port.model.num_params() == ref.model.num_params()


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_logits_loss_grads(params, x, y, *, cfg):
    logits, _ = jtf.forward(params, x, cfg)
    loss, grads = jax.value_and_grad(lambda p: jtf.loss_fn(p, x, y, cfg))(params)
    return logits, loss, grads


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x, np.float32)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", NEW_PRESETS)
def test_shrunk_preset_matches_jax(name):
    jm = dataclasses.replace(jcfg.get_preset(name).model, **SHRINK)
    tm = dataclasses.replace(tcfg.get_preset(name).model, **SHRINK)
    layout = jax.eval_shape(functools.partial(jtf.init_params, jm), jax.random.key(0))
    rng = np.random.default_rng(11)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, s: ((1.0 if p[-1].key == "scale" else 0.0) + rng.normal(0, 0.05, s.shape)).astype(np.float32),
        layout)
    toks = rng.integers(0, SHRINK["vocab_size"], (4, SHRINK["context_length"] + 1)).astype(np.int32)
    x, y = toks[:, :-1], toks[:, 1:]
    want_logits, want_loss, want_grads = _jax_logits_loss_grads(tree, x, y, cfg=jm)

    params = bridge.params_from_numpy(tree, tm, device="cpu")
    with torch.no_grad():
        logits, _ = ttf.forward(params, torch.from_numpy(x), tm)
    leaves = topt.tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    loss = ttf.loss_fn(leaves, torch.from_numpy(x), torch.from_numpy(y), tm)
    loss.backward()
    loss = loss.detach()
    assert float(np.abs(logits.numpy() - np.asarray(want_logits)).max()) <= LOGITS_TOL
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    want, got = _flat(want_grads), _flat(bridge.params_to_numpy(topt.tree_map(lambda p: p.grad, leaves)))
    assert want.keys() == got.keys()
    for leaf in want:
        scale = max(float(np.abs(want[leaf]).max()), 1e-12)
        assert float(np.abs(want[leaf] - got[leaf]).max()) <= GRAD_RTOL * scale, leaf
